"""The tile-program layer: one device grid's tiles, and the streaming executor.

Port of :mod:`repro.core.tiles`.  :func:`tile_map` runs a tile body over
every tile of a :class:`~repro_torch.core.distmatrix.DistContext` grid
from one process (a loop over the tiles, each on its grid device), reduces
in a fixed order and stitches the result; on a 1x1 grid it runs the body
once on the whole matrix, so one device and a grid share one
implementation.  Its plans (the tiles' index tensors) are cached per
context and geometry, and counted by :class:`ProgramCacheStats`.
:func:`tile_stream` is the out-of-core executor on one device: a plain
loop over row panels of store-backed operands (:func:`is_streamable`,
:class:`StreamStats`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import REGISTRY as _OBS_REGISTRY
from repro_torch.obs.metrics import MetricsRegistry


# ---------------------------------------------------------------------------
# the plan cache
# ---------------------------------------------------------------------------
#
# There is no compiler to cache in the port: what a tile program reuses is
# its plan -- the tiles' global index tensors on their devices, the Cannon
# tables of a schedule.  Every body on a grid shares the same tiles, so a
# plan is keyed on the context and the block geometry alone.


class ProgramCacheStats:
    """Plan-cache accounting: a live view over ``program_cache.*`` counters
    of a :class:`MetricsRegistry` (the process registry by default, so run
    reports read the same numbers).

    ``hits`` counts plans reused, ``misses`` plans built, and ``traces``
    plan builds (the JAX package counts tile-body traces there; a plan is
    built where a program is traced).  A plan is one (context, geometry),
    so the counters count geometries, not bodies.  :func:`reset_program_cache_stats`
    zeroes the counters in place.
    """

    __slots__ = ("_reg",)
    _PREFIX = "program_cache."

    def __init__(self, registry: MetricsRegistry | None = None):
        self._reg = registry if registry is not None else MetricsRegistry()

    @property
    def hits(self) -> int:
        return int(self._reg.value("program_cache.hits"))

    @property
    def misses(self) -> int:
        return int(self._reg.value("program_cache.misses"))

    @property
    def traces(self) -> int:
        return int(self._reg.value("program_cache.traces"))

    def note_hit(self) -> None:
        self._reg.inc("program_cache.hits")

    def note_miss(self) -> None:
        self._reg.inc("program_cache.misses")

    def note_trace(self) -> None:
        self._reg.inc("program_cache.traces")

    def __repr__(self) -> str:
        return (f"ProgramCacheStats(hits={self.hits}, misses={self.misses}, "
                f"traces={self.traces})")


_PROGRAM_STATS = ProgramCacheStats(registry=_OBS_REGISTRY)
_PLAN_CACHE: dict = {}


def program_cache_stats() -> ProgramCacheStats:
    """Counters since process start / last :func:`reset_program_cache_stats`."""
    return _PROGRAM_STATS


def reset_program_cache_stats() -> ProgramCacheStats:
    """Zero the counters in place (held references observe the reset)."""
    _OBS_REGISTRY.reset(ProgramCacheStats._PREFIX)
    return _PROGRAM_STATS


def clear_program_cache() -> None:
    _PLAN_CACHE.clear()


def cached_plan(key: tuple, build: Callable[[], object]):
    """The plan for ``key`` (a context and a geometry), built on first use."""
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        _PROGRAM_STATS.note_miss()
        _PROGRAM_STATS.note_trace()
        plan = _PLAN_CACHE[key] = build()
    else:
        _PROGRAM_STATS.note_hit()
    return plan


# ---------------------------------------------------------------------------
# the tile-program primitive
# ---------------------------------------------------------------------------

# in_specs of tile_map: strings, not PartitionSpecs.  A "matrix" operand is
# cut into the grid's tiles (a DistMatrix of the context, or a tensor that is
# cut on the way in); a "replicated" one arrives whole on every tile's device
# (a table, a vector, a scalar).
MATRIX = "matrix"
REPLICATED = "replicated"


@dataclass(frozen=True)
class Tile:
    """One tile's window of the global block grid, visible to tile bodies."""

    rows: torch.Tensor  # (pr,) global row ids, on the tile's device
    cols: torch.Tensor  # (pc,) global col ids
    row_index: int  # shard index along the row axes
    col_index: int  # shard index along the col axes
    block_shape: tuple[int, int]  # (pr, pc)
    mesh_axes: tuple[str, ...]  # the context's row and col axis names

    @property
    def row0(self) -> int:
        return self.row_index * self.block_shape[0]

    @property
    def col0(self) -> int:
        return self.col_index * self.block_shape[1]

    def diag_mask(self) -> torch.Tensor:
        """(pr, pc) bool mask of global-diagonal entries in this tile."""
        return self.rows[:, None] == self.cols[None, :]

    def diagonal(self, blk: torch.Tensor) -> torch.Tensor:
        """The view of ``blk``'s global-diagonal entries (empty off the diagonal)."""
        return blk.diagonal(self.row0 - self.col0)


def _build_tiles(ctx, pr: int, pc: int) -> list:
    axes = tuple(ctx.row_axes) + tuple(ctx.col_axes)
    return [[Tile(rows=torch.arange(r * pr, (r + 1) * pr, device=ctx.device(r, c)),
                  cols=torch.arange(c * pc, (c + 1) * pc, device=ctx.device(r, c)),
                  row_index=r, col_index=c, block_shape=(pr, pc), mesh_axes=axes)
             for c in range(ctx.n_col_shards)] for r in range(ctx.n_row_shards)]


def _to(x, dev: torch.device):
    """``x`` on ``dev``: no copy when it is there already.  A copy to a card
    is asynchronous (a peer copy is ordered against both devices' current
    streams); a copy to the host waits for its data, so host code may read
    it at once."""
    if not isinstance(x, torch.Tensor) or x.device == dev:
        return x
    return x.to(dev, non_blocking=dev.type == "cuda")


def reduce_blocks(parts: list, home: torch.device) -> torch.Tensor:
    """Sum ``parts`` on ``home`` in list order (the fixed-order psum)."""
    acc = _to(parts[0], home)
    for p in parts[1:]:
        acc = acc + _to(p, home)
    return acc


def tile_map(
    ctx,
    fn: Callable[..., torch.Tensor],
    *operands,
    grid: tuple[int, int] | None = None,
    in_specs: Sequence[str] | None = None,
    reduce: str | None = None,
    out_dtype=None,
):
    """Run ``fn(tile, *blocks)`` over every tile of the ``ctx`` grid.

    Args:
      ctx: a :class:`~repro_torch.core.distmatrix.DistContext`.
      fn: tile body; gets a :class:`Tile` and each operand's block on the
        tile's device (``REPLICATED`` operands arrive whole) and returns the
        tile's output block.
      operands: DistMatrices of ``ctx``, tensors, or (replicated) scalars.
      grid: global (n_rows, n_cols); defaults to the first ``MATRIX``
        operand's shape.
      in_specs: ``MATRIX`` or ``REPLICATED`` per operand (default all
        ``MATRIX``).
      reduce: ``None`` stitches the tile outputs into a DistMatrix (the
        tensor itself on a 1x1 grid); ``"cols"`` sums each block row's
        outputs over the columns in order c = 0..C-1 on the home device and
        stacks the rows; ``"rows"`` the same over the rows.  A single part
        is returned as it is, with no copy.
      out_dtype: optional cast of each tile output.
    """
    if in_specs is None:
        in_specs = (MATRIX,) * len(operands)
    in_specs = tuple(in_specs)
    if len(in_specs) != len(operands):
        raise ValueError(f"{len(operands)} operands but {len(in_specs)} in_specs")
    if any(sp not in (MATRIX, REPLICATED) for sp in in_specs):
        raise ValueError(f"in_specs must be {MATRIX!r} or {REPLICATED!r}, got {in_specs}")
    if grid is None:
        for op, sp in zip(operands, in_specs):
            if sp == MATRIX:
                grid = (int(op.shape[0]), int(op.shape[1]))
                break
        if grid is None:
            raise ValueError("grid= is required when no operand is matrix-sharded")
    n0, n1 = grid
    R, C = ctx.n_row_shards, ctx.n_col_shards
    if n0 % R or n1 % C:
        raise ValueError(f"grid {tuple(grid)} must divide the {R}x{C} shard grid")
    if reduce not in (None, "cols", "rows"):
        raise ValueError(f"reduce must be None, 'cols' or 'rows', got {reduce!r}")
    pr, pc = n0 // R, n1 // C
    tiles = cached_plan((ctx, pr, pc), lambda: _build_tiles(ctx, pr, pc))

    blocks = []
    for op, sp in zip(operands, in_specs):
        if sp == MATRIX:
            if tuple(op.shape) != (n0, n1):
                raise ValueError(f"matrix operand {tuple(op.shape)} does not match grid {grid}")
            blocks.append(ctx.blocks(op))
        else:
            blocks.append({})  # per device, filled on first use
    outs = []
    for r in range(R):
        row = []
        for c in range(C):
            dev = ctx.device(r, c)
            args = []
            for op, sp, blk in zip(operands, in_specs, blocks):
                if sp == MATRIX:
                    args.append(blk[r][c])
                else:
                    if dev not in blk:
                        blk[dev] = _to(op, dev)
                    args.append(blk[dev])
            out = fn(tiles[r][c], *args)
            row.append(out if out_dtype is None else out.to(out_dtype))
        outs.append(row)
    if reduce is None:
        return ctx.assemble(outs)
    if reduce == "cols":
        parts = [reduce_blocks(row, ctx.home) for row in outs]
    else:
        parts = [reduce_blocks([outs[r][c] for r in range(R)], ctx.home) for c in range(C)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


# ---------------------------------------------------------------------------
# the streaming tile executor (out-of-core operands, one device)
# ---------------------------------------------------------------------------


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
