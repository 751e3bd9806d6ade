"""Graph Laplacian pieces of a dense adjacency.

Counterpart of :mod:`repro.core.laplacian`.  These are elementwise passes,
so they are plain PyTorch, written once as tile bodies that
:func:`~repro_torch.core.tiles.tile_map` runs on each tile of a device
grid (a :class:`~repro_torch.core.distmatrix.DistMatrix`), or once on the
whole matrix on one device; degrees are row sums reduced over the columns.
Where a fresh buffer is being scaled, the scaling is done in place to
avoid a second n^2 temporary (442 MB at n=10512).
"""

from __future__ import annotations

import torch

from repro_torch.core.distmatrix import context_of, grid_or_none
from repro_torch.core.tiles import MATRIX, REPLICATED, is_streamable, tile_map, tile_stream


def _degrees_body(_, blk: torch.Tensor) -> torch.Tensor:  # a tile or a panel's row0
    return blk.to(torch.float32).sum(dim=1)


def _sym_scale_body(tile, blk, scale):
    """blk *= scale[rows] x scale[cols] in place: the D^{-1/2} . D^{-1/2} sandwich."""
    (r0, c0), (pr, pc) = (tile.row0, tile.col0), tile.block_shape
    return blk.mul_(scale[r0:r0 + pr, None]).mul_(scale[None, c0:c0 + pc])


def _norm_adj_body(tile, blk, inv_sqrt, u):
    s = _sym_scale_body(tile, blk.to(torch.float32, copy=True), inv_sqrt)  # fresh: in place
    if u is not None:  # in place: s -= u u^T without an n^2 temporary
        pr, pc = tile.block_shape
        s.addr_(u[tile.row0:tile.row0 + pr], u[tile.col0:tile.col0 + pc], alpha=-1.0)
    return s


def _laplacian_body(tile, blk, deg):
    lap = -blk.to(torch.float32)
    diag = tile.diagonal(lap)
    g0 = max(tile.row0, tile.col0)  # global id of the tile's first diagonal entry
    diag.add_(deg[g0:g0 + diag.shape[0]])
    return lap


def degrees(a, *, ctx=None, device=None, prefetch_depth: int | None = None) -> torch.Tensor:
    """d = A @ 1.

    ``a`` is a resident tensor, a DistMatrix or a snapshot handle; a handle
    streams its row panels onto ``device``, or onto the tiles of ``ctx``
    (row sums are row-parallel and split the columns as the resident grid
    does, so the result is the resident one).
    """
    if is_streamable(a):
        return tile_stream(_degrees_body, a, ctx=grid_or_none(ctx), device=device, reduce="cols",
                           prefetch_depth=prefetch_depth)
    return tile_map(context_of(ctx, a), _degrees_body, a, reduce="cols")


def volume(deg: torch.Tensor) -> torch.Tensor:
    """V_G = sum of degrees (a 0-dim float32 tensor)."""
    return deg.to(torch.float32).sum()


def inv_sqrt_degrees(deg: torch.Tensor) -> torch.Tensor:
    """D^{-1/2} with zero for isolated nodes."""
    return torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-30)), 0.0)


def sym_scale_(x, scale: torch.Tensor):
    """x[i, j] *= scale[i] * scale[j], in place (the D^{-1/2} . D^{-1/2} sandwich)."""
    return tile_map(context_of(None, x), _sym_scale_body, x, scale, in_specs=(MATRIX, REPLICATED))


def _map(body, a, *consts, ctx, prefetch_depth, out_dtype):
    """``body`` over the tiles of ``a``: resident, or streamed from a handle
    onto the tiles of ``ctx`` (assembled there, the input never resident)."""
    specs = (MATRIX,) + (REPLICATED,) * len(consts)
    if is_streamable(a):
        return tile_stream(body, a, *consts, ctx=ctx, in_specs=specs, out_dtype=out_dtype,
                           prefetch_depth=prefetch_depth)
    return tile_map(context_of(ctx, a), body, a, *consts, in_specs=specs, out_dtype=out_dtype)


def normalized_adjacency(a, deg: torch.Tensor, *, deflate: bool = True, dtype=torch.float32,
                         ctx=None, prefetch_depth: int | None = None):
    """S = D^{-1/2} A D^{-1/2}, optionally deflated to S~ = S - u u^T, u = sqrt(d / V_G).

    Deflation removes the known top eigenpair (eigenvalue 1), whose 2^d
    growth would otherwise swamp the useful part of the chain in rounding.
    ``a`` may be a snapshot handle, streamed onto the tiles of ``ctx``.
    """
    u = torch.sqrt(torch.clamp(deg, min=0.0) / volume(deg)) if deflate else None
    return _map(_norm_adj_body, a, inv_sqrt_degrees(deg), u, ctx=ctx,
                prefetch_depth=prefetch_depth, out_dtype=dtype)


def laplacian(a, deg: torch.Tensor, *, dtype=torch.float32, ctx=None,
              prefetch_depth: int | None = None):
    """L = D - A; ``a`` may be a snapshot handle, streamed onto the tiles of ``ctx``."""
    return _map(_laplacian_body, a, deg, ctx=ctx, prefetch_depth=prefetch_depth, out_dtype=dtype)
