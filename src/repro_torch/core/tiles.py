"""The streaming tile executor on one device (out-of-core operands).

Port of the single-device part of :mod:`repro.core.tiles`:
:func:`is_streamable`, :class:`StreamStats` with :func:`stream_stats` /
:func:`reset_stream_stats`, and :func:`tile_stream` as a plain loop over row
panels (one device: no ``shard_map``, no program cache).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import REGISTRY as _OBS_REGISTRY
from repro_torch.obs.metrics import MetricsRegistry


def is_streamable(x) -> bool:
    """True for store-backed snapshot handles (duck-typed, no store import).

    The protocol: ``shape`` (n0, n1), ``dtype``, ``panel_rows`` (preferred
    streaming height) and ``read_panel(row0, height) -> host array``.
    """
    return (
        not isinstance(x, (torch.Tensor, np.ndarray))
        and hasattr(x, "read_panel")
        and hasattr(x, "panel_rows")
        and hasattr(x, "shape")
    )


class StreamStats:
    """Accounting of the streaming executors: a live view over ``stream.*``
    counters of a :class:`MetricsRegistry`.

    ``bytes_read`` counts what the backing tier served before codec decode;
    ``bytes_decoded`` the host bytes the prefetch thread produced from them;
    ``bytes_h2d`` what was copied to the device, and ``bytes_h2d_saved`` the
    decoded-minus-stored gap of panels shipped in stored form.  Host-RAM
    replays add ``panels`` / ``bytes_h2d`` but no ``bytes_read``.  The
    ``stream.peak_live_bytes`` gauge is the high-water mark of device bytes
    the executors held at once.
    """

    __slots__ = ("_reg",)
    _PREFIX = "stream."
    FIELDS = ("panels", "bytes_h2d", "bytes_h2d_saved", "bytes_read", "bytes_decoded", "calls")

    def __init__(self, registry: MetricsRegistry | None = None):
        self._reg = registry if registry is not None else MetricsRegistry()

    def add(self, **fields: int) -> None:
        """Atomically increment counters: ``st.add(panels=1, bytes_h2d=nb)``."""
        for name in fields:
            if name not in StreamStats.FIELDS:
                raise AttributeError(f"unknown stream counter {name!r}")
        self._reg.add_named({f"stream.{name}": v for name, v in fields.items()})

    def _note_live(self, live: int) -> None:
        self._reg.max_gauge("stream.peak_live_bytes", live)

    def __getattr__(self, name: str) -> int:
        if name in StreamStats.FIELDS:
            return int(self._reg.value(f"stream.{name}"))
        if name == "peak_live_bytes":
            return int(self._reg.gauge("stream.peak_live_bytes"))
        raise AttributeError(name)

    def snapshot(self) -> dict[str, int]:
        """One atomic dict of every counter (plus the peak gauge)."""
        snap = self._reg.snapshot()
        out = {f: int(snap.counter(f"stream.{f}")) for f in StreamStats.FIELDS}
        out["peak_live_bytes"] = int(snap.gauges.get("stream.peak_live_bytes", 0))
        return out

    def __repr__(self) -> str:
        return "StreamStats(" + ", ".join(f"{k}={v}" for k, v in self.snapshot().items()) + ")"


_STREAM_STATS = StreamStats(registry=_OBS_REGISTRY)


def stream_stats() -> StreamStats:
    """Counters since process start / last :func:`reset_stream_stats`."""
    return _STREAM_STATS


def reset_stream_stats() -> StreamStats:
    """Zero the counters in place (the same live instance is returned)."""
    _OBS_REGISTRY.reset(StreamStats._PREFIX)
    return _STREAM_STATS


def _infer_panel_rows(handles, n0: int) -> int:
    """Smallest height that is tile-aligned for every handle."""
    rows = int(np.lcm.reduce(np.asarray([int(h.panel_rows) for h in handles], np.int64)))
    if n0 % rows:
        raise ValueError(f"no common panel height: tile rows don't tile n0={n0}")
    return rows


def tile_stream(
    fn: Callable[..., torch.Tensor],
    *operands,
    device: torch.device,
    consts: tuple = (),
    panel_rows: int | None = None,
    prefetch_depth: int | None = None,
) -> torch.Tensor:
    """Run a row-parallel body over streamed row panels of ``operands``.

    ``fn(row0, *panels, *consts)`` gets the global row origin and one
    (ph, n1) panel per operand -- snapshot handles stream through a
    :class:`~repro_torch.store.PanelPipeline` onto ``device``, resident
    tensors are sliced -- and returns the output rows of that panel.  The
    per-panel outputs are stacked by rows into one (n0, ...) tensor (the
    JAX executor's ``reduce="cols"`` concatenation; a body returning whole
    panels gives the assembled matrix).
    """
    from repro_torch.store.pipeline import PanelPipeline  # the store is optional

    handles = [op for op in operands if is_streamable(op)]
    if not handles:
        raise ValueError("tile_stream needs at least one streamable operand")
    n0 = int(handles[0].shape[0])
    for op in operands:
        if tuple(op.shape) != tuple(handles[0].shape):
            raise ValueError(f"streamed operand is {tuple(op.shape)}, want {tuple(handles[0].shape)}")
    if panel_rows is None:
        panel_rows = _infer_panel_rows(handles, n0)
    if n0 % panel_rows:
        raise ValueError(f"panel_rows={panel_rows} must divide n0={n0}")
    stats = _STREAM_STATS
    stats.add(calls=1)
    out = None
    origins = list(range(0, n0, panel_rows))
    with obs_trace.span("tile_stream", body=getattr(fn, "__name__", repr(fn)), n0=n0,
                        panels=len(origins)):
        with PanelPipeline(operands, origins, panel_rows, depth=prefetch_depth,
                           device=device, stats=stats) as pipe:
            for r0, panels in pipe:
                blk = fn(r0, *panels, *consts)
                if out is None:
                    out = torch.empty((n0, *blk.shape[1:]), dtype=blk.dtype, device=blk.device)
                out[r0 : r0 + panel_rows] = blk
    return out
