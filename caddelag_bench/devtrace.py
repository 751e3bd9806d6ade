"""Read a ``torch.profiler`` slice of the window: device busy time, top operations, idle gaps.

The slice is bracketed by a ``bench.window`` annotation; every device
activity (kernels, copies, sets) inside it counts as busy, merged where they
overlap.  Each idle stretch of the device is put down to the innermost host
event (an operator, a runtime call or one of the benchmark's own
annotations) running at its midpoint, and the stretches are summed by that
name.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 120
_LOOKBACK = 4096  # host events scanned back from a gap for the one that holds it


def export_events(prof) -> list[dict]:
    """The profiler's Chrome-trace events, through a temporary file in ``TMPDIR``."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: list[dict]) -> dict | None:
    """``busy_s``, ``window_s``, ``device_ops`` and ``idle_gaps`` of the slice; None without one."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, by_name = [], defaultdict(float)
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            s, t = max(s, w0), min(t, w1)
            if t > s:
                dev.append((s, t))
                by_name[str(e.get("name", "?"))[:NAME_CHARS]] += (t - s) * 1e-6
        elif e.get("cat") in HOST_CATS and e.get("name") != WINDOW:
            host.append((s, t, str(e.get("name", "?"))[:NAME_CHARS]))
    if not dev:
        return None
    busy = _merge(dev)
    busy_s = sum(t - s for s, t in busy) * 1e-6
    host.sort()
    starts = [h[0] for h in host]
    gaps, prev = defaultdict(float), w0
    for s, t in busy + [[w1, w1]]:
        if s > prev:
            gaps[_holder(host, starts, 0.5 * (prev + s))] += (s - prev) * 1e-6
        prev = max(prev, t)
    return {
        "busy_s": busy_s,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:TOP],
    }


def _holder(host, starts, mid: float) -> str:
    """The innermost host event that holds ``mid`` (the latest to start), else ``host``."""
    i = bisect.bisect_right(starts, mid) - 1
    for j in range(i, max(-1, i - _LOOKBACK), -1):
        if host[j][1] >= mid:
            return host[j][2]
    return "host"
