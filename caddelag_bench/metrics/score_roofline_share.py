"""``score_roofline_share``: the scorer's bytes (A1, A2, Z1, Z2, the scores) at the HBM peak,
over the fenced score time per transition, in % (on the card only)."""

from caddelag_bench import yardstick


def read(r):
    if not r.on_card or not r.transitions or not r.phase_calls.get("score"):
        return None
    seconds = r.phase_seconds["score"] / r.transitions
    if seconds <= 0:
        return None
    return 100.0 * yardstick.score_bytes(r.n, r.k) / yardstick.HBM_BYTES_PER_S / seconds
