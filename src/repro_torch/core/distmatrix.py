"""Dense n x n matrices on a grid of devices: the chain GEMM schedules and the builders.

Port of :mod:`repro.core.distmatrix`, the paper's Spark block matrix
(``((row_id, col_id), M)``).  One process drives an R x C grid of devices
(:class:`DistContext`); a matrix on it is a :class:`DistMatrix`, an R x C
grid of tiles each on its grid device -- the port's form of a
``NamedSharding``-tiled ``jax.Array``.  A grid may repeat a device: a 2x2
grid on one card (or on the CPU) runs the same schedule code, every tile on
that device; with several cards the tiles move between them by peer copies.

Three GEMM schedules, as in the JAX package:

- ``summa``  -- each tile gathers A's row panel and B's column panel onto
                its device and runs one ``block_matmul``: R*C launches.
- ``cannon`` -- pre-skew the tiles, then R steps of a local ``block_matmul``
                and a neighbour shift, accumulating in fp32: R*C*R launches.
                Each step's shift is issued before its GEMMs; a shift between
                tiles on one device moves a list entry and copies nothing.
- ``xla``    -- the port has no compiler to leave the schedule to: on a grid
                it runs SUMMA's gather-and-multiply under its own name.

Every schedule counts the tile bytes it moves between grid positions in the
obs registry, by schedule: ``grid.<schedule>.gather_bytes`` / ``.gathers``
(SUMMA's row and column panels, the tiles of a panel that are not at the
gathering position) and ``grid.<schedule>.permute_bytes`` / ``.permutes``
(Cannon's skews and shifts, the tiles whose destination is another
position).  A move counts by logical position: tiles that share a device
(a 2x2 grid on one card, or on ``meta``) count what a grid of distinct
cards would move, though no copy is made.  :func:`grid_moves` reads them.

On a 1x1 grid (``ctx=None`` means :func:`trivial_context` of the operand's
device) a matrix is a plain tensor and all three schedules are one
``block_matmul`` call, exactly as before the grid existed.  The builders
and the elementwise passes have one implementation, a tile body run by
:func:`~repro_torch.core.tiles.tile_map`; on a 1x1 grid it runs once on
the whole matrix.
:func:`matmul_rowblock`, the solver's skinny mat-vec, is a plain product in
both packages; on a grid its (n, k) operand and result live whole on the
home device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.tiles import (
    MATRIX,
    REPLICATED,
    _to,
    cached_plan,
    is_streamable,
    tile_map,
    tile_stream,
)
from repro_torch.kernels import block_matmul as _bm
from repro_torch.obs import REGISTRY

SCHEDULES = ("xla", "summa", "cannon")

# Elements per row chunk when building A from node features: the (rows, n,
# dim) difference tensor of an n=10512 climate graph would be 5 GB at once.
_BUILD_CHUNK_ELEMS = 1 << 25


def _device(d) -> torch.device:
    """``d`` as a ``torch.device`` with its index ("cuda" is the current card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclass(frozen=True)
class DistContext:
    """An R x C grid of devices for distributed block matrices.

    ``devices[r][c]`` holds tile (r, c); rows are sharded over ``row_axes``
    ("data"), columns over ``col_axes`` ("model").  The home device,
    ``devices[0][0]``, holds the (n, k) vectors and the reduced results.
    The JAX context's ``matrix_spec``, ``rowblock_spec``, ``vector_spec``,
    ``sharding``, ``constrain``, ``put_rowblock`` and the ``pcast_varying``
    helper are left out: only JAX's sharding types need them.
    """

    devices: tuple[tuple[torch.device, ...], ...]
    row_axes: tuple[str, ...] = ("data",)
    col_axes: tuple[str, ...] = ("model",)

    @property
    def n_row_shards(self) -> int:
        return len(self.devices)

    @property
    def n_col_shards(self) -> int:
        return len(self.devices[0])

    @property
    def home(self) -> torch.device:
        return self.devices[0][0]

    @property
    def is_trivial(self) -> bool:
        return self.n_row_shards == 1 and self.n_col_shards == 1

    def device(self, r: int, c: int) -> torch.device:
        return self.devices[r][c]

    def block_shape(self, n0: int, n1: int) -> tuple[int, int]:
        R, C = self.n_row_shards, self.n_col_shards
        if n0 % R or n1 % C:
            raise ValueError(f"n={n0}x{n1} must divide the {R}x{C} shard grid")
        return n0 // R, n1 // C

    def put_matrix(self, x):
        """``x`` (a tensor or array) cut into this grid's tiles, each copied to
        its device: a :class:`DistMatrix`, or on a 1x1 grid a tensor on the
        home device."""
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
        if x.ndim != 2:
            raise ValueError(f"put_matrix: want a matrix, got shape {tuple(x.shape)}")
        return self.assemble(self._split(x))

    def _split(self, x: torch.Tensor) -> list:
        pr, pc = self.block_shape(*x.shape)
        out = []
        for r in range(self.n_row_shards):
            row = []
            for c in range(self.n_col_shards):
                blk = torch.empty((pr, pc), dtype=x.dtype, device=self.device(r, c))
                row.append(blk.copy_(x[r * pr:(r + 1) * pr, c * pc:(c + 1) * pc]))
            out.append(row)
        return out

    def blocks(self, x) -> list:
        """The R x C tiles of a matrix operand (a tensor is cut on the way in)."""
        if isinstance(x, DistMatrix):
            if x.ctx != self:
                raise ValueError("matrix operand lives on another device grid")
            return x.tiles
        if self.is_trivial:
            return [[_to(x, self.home)]]
        return self._split(x)

    def assemble(self, tiles: list):
        """The matrix of an R x C list of tiles (the tile itself on a 1x1 grid)."""
        if self.is_trivial:
            return tiles[0][0]
        return DistMatrix(self, tiles)

    def row_panel(self, x, row0: int, height: int):
        """Rows ``[row0, row0 + height)`` of the matrix ``x`` (a tensor or a
        DistMatrix of this grid) as this grid's R x C panel tiles of
        ``(height / R, n1 / C)``, each on its grid device: a DistMatrix, or
        on a 1x1 grid the row slice.  A DistMatrix's tile rows are
        ``height / R``-aligned, so each panel tile is a row slice of one
        resident tile."""
        if not isinstance(x, DistMatrix):
            x = x[row0:row0 + height]
            return _to(x, self.home) if self.is_trivial else self.put_matrix(x)
        R, C = self.n_row_shards, self.n_col_shards
        pr, br = height // R, x.block_shape[0]
        tiles = []
        for r in range(R):
            g0 = row0 + r * pr
            tiles.append([_to(x.tiles[g0 // br][c][g0 % br:g0 % br + pr], self.device(r, c))
                          for c in range(C)])
        return self.assemble(tiles)

    def to_dense(self, x) -> torch.Tensor:
        """One tensor on the home device."""
        return x.to_dense() if isinstance(x, DistMatrix) else _to(x, self.home)

    def to_numpy(self, x) -> np.ndarray:
        return self.to_dense(x).cpu().numpy()


def make_context(
    devices: Sequence,
    n_rows: int = 1,
    row_axes: Sequence[str] = ("data",),
    col_axes: Sequence[str] = ("model",),
) -> DistContext:
    """An ``n_rows x (len(devices) / n_rows)`` grid over ``devices``, row-major.

    A device may appear more than once: that is how one card (or the CPU)
    hosts a 2x2 grid.
    """
    flat = [_device(d) for d in devices]
    if n_rows < 1 or not flat or len(flat) % n_rows:
        raise ValueError(f"{len(flat)} devices do not make a grid of {n_rows} rows")
    n_cols = len(flat) // n_rows
    grid = tuple(tuple(flat[r * n_cols:(r + 1) * n_cols]) for r in range(n_rows))
    return DistContext(devices=grid, row_axes=tuple(row_axes), col_axes=tuple(col_axes))


def trivial_context(device: str | torch.device = "cuda") -> DistContext:
    """The 1x1 grid on ``device``: every path as on one device."""
    return make_context([device])


class DistMatrix:
    """An n0 x n1 matrix cut into a :class:`DistContext`'s R x C tiles, each
    on its grid device."""

    __slots__ = ("ctx", "tiles")

    def __init__(self, ctx: DistContext, tiles: list):
        R, C = ctx.n_row_shards, ctx.n_col_shards
        if len(tiles) != R or any(len(row) != C for row in tiles):
            raise ValueError(f"want {R}x{C} tiles")
        pr, pc = tiles[0][0].shape
        for r, row in enumerate(tiles):
            for c, t in enumerate(row):
                if tuple(t.shape) != (pr, pc) or t.device != ctx.device(r, c):
                    raise ValueError(f"tile ({r}, {c}) is {tuple(t.shape)} on {t.device}, want "
                                     f"{(pr, pc)} on {ctx.device(r, c)}")
        self.ctx = ctx
        self.tiles = [list(row) for row in tiles]

    @property
    def block_shape(self) -> tuple[int, int]:
        return tuple(self.tiles[0][0].shape)

    @property
    def shape(self) -> torch.Size:
        pr, pc = self.block_shape
        return torch.Size((pr * self.ctx.n_row_shards, pc * self.ctx.n_col_shards))

    @property
    def dtype(self) -> torch.dtype:
        return self.tiles[0][0].dtype

    @property
    def device(self) -> torch.device:
        """The home device (where vectors and reductions of this matrix live)."""
        return self.ctx.home

    def to(self, dtype: torch.dtype) -> "DistMatrix":
        """Each tile cast to ``dtype`` (the tiles themselves when it already is)."""
        return DistMatrix(self.ctx, [[t.to(dtype) for t in row] for row in self.tiles])

    def add_(self, other: "DistMatrix") -> "DistMatrix":
        """self += other, tile by tile, in place."""
        for mine, theirs in zip(self.tiles, self.ctx.blocks(other)):
            for t, o in zip(mine, theirs):
                t.add_(o)
        return self

    def to_dense(self) -> torch.Tensor:
        home = self.ctx.home
        return torch.cat([torch.cat([_to(t, home) for t in row], dim=1) for row in self.tiles])

    def numpy(self) -> np.ndarray:
        """The matrix on the host, stitched there tile by tile (no n^2 buffer
        on the home device)."""
        return np.concatenate([np.concatenate([t.cpu().numpy() for t in row], axis=1)
                               for row in self.tiles], axis=0)

    def free(self) -> None:
        """Release every tile's memory now (``donate``); the matrix is dead after."""
        for row in self.tiles:
            for t in row:
                t.untyped_storage().resize_(0)

    def __repr__(self) -> str:
        return (f"DistMatrix({tuple(self.shape)}, {self.dtype}, "
                f"{self.ctx.n_row_shards}x{self.ctx.n_col_shards} tiles of {self.block_shape})")


def grid_of(ctx: DistContext | None, *xs) -> DistContext | None:
    """The grid ``xs`` live on: ``ctx`` if given, else a DistMatrix operand's, else None."""
    if ctx is not None:
        return ctx
    for x in xs:
        if isinstance(x, DistMatrix):
            return x.ctx
    return None


def grid_or_none(ctx: DistContext | None) -> DistContext | None:
    """``ctx`` if it is a grid larger than 1x1, else None (the one-device paths)."""
    return None if ctx is None or ctx.is_trivial else ctx


def context_of(ctx: DistContext | None, x) -> DistContext:
    """The grid ``x`` runs on: ``ctx`` if given, ``x``'s own if it is a
    DistMatrix, else the 1x1 grid of ``x``'s device."""
    ctx = grid_of(ctx, x)
    return ctx if ctx is not None else trivial_context(x.device)


def on_grid(ctx: DistContext | None, x):
    """``x`` as a matrix of ``ctx``: a tensor is cut into a larger grid's tiles;
    on no grid or a 1x1 grid it is left as it is."""
    if ctx is None or ctx.is_trivial or isinstance(x, DistMatrix) or is_streamable(x):
        return x
    return ctx.put_matrix(x)


# ---------------------------------------------------------------------------
# matmul schedules
# ---------------------------------------------------------------------------


_MOVE_KINDS = ("gather", "permute")


def _count_moves(schedule: str, kind: str, nbytes: int, moves: int) -> None:
    REGISTRY.add_named({f"grid.{schedule}.{kind}_bytes": float(nbytes),
                        f"grid.{schedule}.{kind}s": float(moves)})


def grid_moves(registry=REGISTRY) -> dict:
    """Tile traffic between grid positions so far, by schedule:
    ``{schedule: {"gather_bytes", "gathers", "permute_bytes", "permutes"}}``
    (process-wide registry counters; take a difference around a run)."""
    return {s: {f"{k}{suffix}": registry.value(f"grid.{s}.{k}{suffix}")
                for k in _MOVE_KINDS for suffix in ("_bytes", "s")} for s in SCHEDULES}


def _tile_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_summa(a: DistMatrix, b: DistMatrix, out_dtype, schedule: str = "summa") -> DistMatrix:
    """Per tile: A's row panel and B's column panel gathered onto its device,
    one ``block_matmul``.  A panel is gathered once per (panel, device); the
    count is per grid position: each tile (r, c) receives the C - 1 tiles of
    A's row r and the R - 1 tiles of B's column c held at other positions."""
    ctx = a.ctx
    R, C = ctx.n_row_shards, ctx.n_col_shards
    a_tile, b_tile = _tile_bytes(a.tiles[0][0]), _tile_bytes(b.tiles[0][0])
    _count_moves(schedule, "gather", R * C * ((C - 1) * a_tile + (R - 1) * b_tile),
                 R * C * (C - 1 + R - 1))
    b_cols = {}
    out = []
    for r in range(R):
        a_rows = {}
        row = []
        for c in range(C):
            dev = ctx.device(r, c)
            if dev not in a_rows:
                a_rows[dev] = torch.cat([_to(t, dev) for t in a.tiles[r]], dim=1)
            if (c, dev) not in b_cols:
                b_cols[(c, dev)] = torch.cat([_to(b.tiles[i][c], dev) for i in range(R)], dim=0)
            row.append(_bm.block_matmul(a_rows[dev], b_cols[(c, dev)], out_dtype=out_dtype))
        out.append(row)
        del a_rows
    return DistMatrix(ctx, out)


def _cannon_perms(R: int, C: int):
    """(source, destination) tables over the flattened (row, col) tile index:
    the pre-skews and the per-step neighbour shifts (the JAX tables)."""
    skew_a = [(r * C + c, r * C + ((c - r) % C)) for r in range(R) for c in range(C)]
    skew_b = [(r * C + c, ((r - c) % R) * C + c) for r in range(R) for c in range(C)]
    shift_a = [(r * C + c, r * C + ((c - 1) % C)) for r in range(R) for c in range(C)]
    shift_b = [(r * C + c, ((r - 1) % R) * C + c) for r in range(R) for c in range(C)]
    return skew_a, skew_b, shift_a, shift_b


def _permute(blocks: list, perm, devices: list) -> list:
    """Move each block to its destination's device (no copy where it is one
    device); a block whose destination is another grid position counts as a
    ``cannon`` permute."""
    out = [None] * len(blocks)
    moved = 0
    for src, dst in perm:
        out[dst] = _to(blocks[src], devices[dst])
        moved += src != dst
    _count_moves("cannon", "permute", moved * _tile_bytes(blocks[0]), moved)
    return out


def _matmul_cannon(a: DistMatrix, b: DistMatrix, out_dtype) -> DistMatrix:
    ctx = a.ctx
    R, C = ctx.n_row_shards, ctx.n_col_shards
    if R != C:
        raise ValueError(
            f"cannon schedule needs a square device grid, got {R}x{C}; "
            "use schedule='summa' (or make the pod axis an outer sequence axis)"
        )
    skew_a, skew_b, shift_a, shift_b = cached_plan((ctx, "cannon"), lambda: _cannon_perms(R, C))
    devs = [ctx.device(r, c) for r in range(R) for c in range(C)]
    a_cur = _permute([t for row in a.tiles for t in row], skew_a, devs)
    b_cur = _permute([t for row in b.tiles for t in row], skew_b, devs)
    acc = [None] * len(devs)
    for step in range(R):
        if step + 1 < R:  # the next step's shift first, as the JAX loop issues it
            a_nxt, b_nxt = _permute(a_cur, shift_a, devs), _permute(b_cur, shift_b, devs)
        for i in range(len(devs)):
            prod = _bm.block_matmul(a_cur[i], b_cur[i], out_dtype=torch.float32)
            acc[i] = prod if acc[i] is None else acc[i].add_(prod)
        if step + 1 < R:
            a_cur, b_cur = a_nxt, b_nxt
    out = [t.to(out_dtype) for t in acc]
    return DistMatrix(ctx, [out[r * C:(r + 1) * C] for r in range(R)])


def matmul(a, b, *, schedule: str = "xla", out_dtype=None,
           ctx: DistContext | None = None):
    """C = A @ B through the ``block_matmul`` kernel (fp32 accumulation).

    Tensors (no grid or a 1x1 grid): one ``block_matmul`` call, whatever the
    schedule.  On a larger grid, ``schedule`` picks the tile program.
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; want one of {SCHEDULES}")
    out_dtype = out_dtype or a.dtype
    ctx = grid_of(ctx, a, b)
    a, b = on_grid(ctx, a), on_grid(ctx, b)
    if not isinstance(a, DistMatrix):
        return _bm.block_matmul(a, b, out_dtype=out_dtype)
    if a.ctx != b.ctx:
        raise ValueError("matmul: operands on different device grids")
    if schedule == "cannon":
        return _matmul_cannon(a, b, out_dtype)
    # "summa", and "xla" with no compiler to defer to (counted under its own name)
    return _matmul_summa(a, b, out_dtype, schedule)


def _rowblock_body(tile, blk: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(blk.to(torch.float32), x[tile.col0:tile.col0 + tile.block_shape[1]])


def matmul_rowblock(m, x: torch.Tensor, *, ctx: DistContext | None = None,
                    prefetch_depth: int | None = None) -> torch.Tensor:
    """(n x n) @ (n x k) with k << n, fp32 accumulation: the solver mat-vec.

    ``m`` is a tensor, a DistMatrix, or a snapshot handle (an out-of-core
    P1 / P2), whose row panels then stream onto ``x``'s device, or onto the
    tiles of ``ctx`` (a handle carries no grid), so the operator is never
    resident.  On a grid ``x`` and the result live on the home device; each
    block row's column partials are summed there in order c = 0..C-1.
    """
    xf = x.to(torch.float32)
    if is_streamable(m):
        out = tile_stream(_rowblock_body, m, xf, ctx=grid_or_none(ctx), device=x.device,
                          in_specs=(MATRIX, REPLICATED), reduce="cols",
                          prefetch_depth=prefetch_depth)
    elif isinstance(m, DistMatrix):
        out = tile_map(m.ctx, _rowblock_body, m, xf, in_specs=(MATRIX, REPLICATED),
                       reduce="cols")
    else:
        out = torch.matmul(m.to(torch.float32), xf)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# blockwise constructors -- the "never load the graph" builders
# ---------------------------------------------------------------------------


def _add_scaled_identity_body(tile, blk: torch.Tensor, s: float) -> torch.Tensor:
    out = blk.clone()
    tile.diagonal(out).add_(s)
    return out


def add_scaled_identity(x, scale: float = 1.0, *, ctx: DistContext | None = None):
    """x + scale * I as a new matrix, without materializing I."""
    ctx = context_of(ctx, x)
    return tile_map(ctx, _add_scaled_identity_body, on_grid(ctx, x), float(scale),
                    in_specs=(MATRIX, REPLICATED))


def _kernel_block(fi: torch.Tensor, fj: torch.Tensor, kernel_fn, dtype) -> torch.Tensor:
    """kernel_fn(fi, fj) as a (len(fi), len(fj)) block, in row chunks."""
    per_row = fj.shape[0] * max(1, fj.shape[1] if fj.ndim > 1 else 1)
    step = max(1, _BUILD_CHUNK_ELEMS // per_row)
    out = torch.empty((fi.shape[0], fj.shape[0]), dtype=dtype, device=fi.device)
    for r0 in range(0, fi.shape[0], step):
        out[r0:r0 + step] = kernel_fn(fi[r0:r0 + step], fj).to(dtype)
    return out


def _build_body(tile, f: torch.Tensor, kernel_fn, dtype, zero_diagonal: bool) -> torch.Tensor:
    (r0, c0), (pr, pc) = (tile.row0, tile.col0), tile.block_shape
    blk = _kernel_block(f[r0:r0 + pr], f[c0:c0 + pc], kernel_fn, dtype)
    if zero_diagonal:
        tile.diagonal(blk).zero_()
    return blk


def build_from_nodes(
    feats: torch.Tensor,
    kernel_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    *,
    dtype=torch.float32,
    zero_diagonal: bool = True,
    ctx: DistContext | None = None,
):
    """A[i, j] = kernel_fn(feats[i], feats[j]).

    Each tile is built in row chunks on its own device from the replicated
    feature table, so on a grid the n x n graph never exists in one place
    (on no grid, the one tile is the whole matrix on feats' device).
    """
    if ctx is None:
        ctx = trivial_context(feats.device)
    n = int(feats.shape[0])
    return tile_map(ctx, _build_body, feats, kernel_fn, dtype, zero_diagonal, grid=(n, n),
                    in_specs=(REPLICATED,) * 4)


def _unary_body(tile, blk: torch.Tensor, fn) -> torch.Tensor:
    return fn(blk, tile.rows, tile.cols)


def blockwise_unary(
    fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    x,
    *,
    out_dtype=None,
    ctx: DistContext | None = None,
    device=None,
    prefetch_depth: int | None = None,
):
    """Apply ``fn(block, global_rows, global_cols) -> block`` tile-locally.

    ``x`` is a tensor, a DistMatrix, or a snapshot handle; a handle's row
    panels stream onto ``device`` (or the tiles of ``ctx``) and the
    transformed panels are assembled there, so the raw input is never
    resident.
    """
    if is_streamable(x):  # a handle's dtype is numpy's: the panels' own unless asked
        return tile_stream(_unary_body, x, fn, ctx=grid_or_none(ctx), device=device,
                           in_specs=(MATRIX, REPLICATED), out_dtype=out_dtype,
                           prefetch_depth=prefetch_depth)
    ctx = context_of(ctx, x)
    x = on_grid(ctx, x)
    return tile_map(ctx, _unary_body, x, fn, in_specs=(MATRIX, REPLICATED),
                    out_dtype=out_dtype or x.dtype)
