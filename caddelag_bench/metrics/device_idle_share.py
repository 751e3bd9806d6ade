"""``device_idle_share``: the share of the profiled, unfenced slice of the window in which no
operation ran on the card, in % (from the ``torch.profiler`` trace)."""


def read(r):
    p = r.profile
    if p is None or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
