"""Observability for the port: metrics registry, span tracer and ``phase``.

:func:`phase` opens a trace span (when tracing is on) and always adds to the
``phase.<name>.seconds`` / ``phase.<name>.calls`` registry counters the
per-transition breakdowns are cut from.  Without fencing the seconds measure
enqueue plus host work; ``enable_tracing(fence=True)`` makes them device
walls.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

from repro_torch.obs import metrics, trace
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry, MetricsSnapshot
from repro_torch.obs.trace import disable_tracing, enable_tracing, span, tracer

__all__ = [
    "metrics",
    "trace",
    "REGISTRY",
    "MetricsRegistry",
    "MetricsSnapshot",
    "disable_tracing",
    "enable_tracing",
    "span",
    "tracer",
    "phase",
]


@contextmanager
def phase(name: str, **args):
    """Time one pipeline phase: a trace span plus always-on registry counters."""
    t0 = time.perf_counter()
    sp = trace.span(f"phase.{name}", **args)
    sp.__enter__()
    try:
        yield sp
    finally:
        sp.__exit__(None, None, None)
        REGISTRY.add_named({
            f"phase.{name}.seconds": time.perf_counter() - t0,
            f"phase.{name}.calls": 1.0,
        })
