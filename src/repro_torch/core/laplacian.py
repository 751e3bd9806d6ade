"""Graph Laplacian pieces of a dense adjacency on one device.

Counterpart of :mod:`repro.core.laplacian`.  These are elementwise passes,
so they are plain PyTorch.  Where a fresh n x n buffer is being scaled, the
scaling is done in place to avoid a second n^2 temporary (442 MB at
n=10512).
"""

from __future__ import annotations

import torch

from repro_torch.core.tiles import is_streamable, tile_stream


def _degrees_body(r0: int, blk: torch.Tensor) -> torch.Tensor:
    return blk.to(torch.float32).sum(dim=1)


def degrees(a, *, device=None, prefetch_depth: int | None = None) -> torch.Tensor:
    """d = A @ 1.

    ``a`` is a resident tensor or a snapshot handle; a handle streams its
    row panels onto ``device`` (row sums are row-parallel, so the result is
    the resident one).
    """
    if is_streamable(a):
        return tile_stream(_degrees_body, a, device=device, prefetch_depth=prefetch_depth)
    return _degrees_body(0, a)


def volume(deg: torch.Tensor) -> torch.Tensor:
    """V_G = sum of degrees (a 0-dim float32 tensor)."""
    return deg.to(torch.float32).sum()


def inv_sqrt_degrees(deg: torch.Tensor) -> torch.Tensor:
    """D^{-1/2} with zero for isolated nodes."""
    return torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-30)), 0.0)


def sym_scale_(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x[i, j] *= scale[i] * scale[j], in place (the D^{-1/2} . D^{-1/2} sandwich)."""
    return x.mul_(scale[:, None]).mul_(scale[None, :])


def normalized_adjacency(
    a: torch.Tensor, deg: torch.Tensor, *, deflate: bool = True, dtype=torch.float32
) -> torch.Tensor:
    """S = D^{-1/2} A D^{-1/2}, optionally deflated to S~ = S - u u^T, u = sqrt(d / V_G).

    Deflation removes the known top eigenpair (eigenvalue 1), whose 2^d
    growth would otherwise swamp the useful part of the chain in rounding.
    """
    vol = volume(deg)
    s = a.to(torch.float32, copy=True)  # fresh buffer: scaled in place below
    sym_scale_(s, inv_sqrt_degrees(deg))
    if deflate:
        u = torch.sqrt(torch.clamp(deg, min=0.0) / vol)
        s.addr_(u, u, alpha=-1.0)  # in place: s -= u u^T without an n^2 temporary
    return s.to(dtype)


def laplacian(a: torch.Tensor, deg: torch.Tensor, *, dtype=torch.float32) -> torch.Tensor:
    """L = D - A."""
    lap = -a.to(torch.float32)
    lap.diagonal().add_(deg)
    return lap.to(dtype)
