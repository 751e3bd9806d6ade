"""Dense n x n matrices on one device: the chain GEMM and its helpers.

Single-device counterpart of :mod:`repro.core.distmatrix`.  There is no mesh
here: ``schedule`` is accepted for symmetry with the JAX package and
ignored.  :func:`matmul` runs the hand-written fp32 CUDA GEMM for CUDA
tensors (its plain version for CPU tensors); :func:`matmul_rowblock`, the
solver's skinny mat-vec, is a plain product in both packages, per row panel
when the matrix streams from a store.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.tiles import is_streamable, tile_stream
from repro_torch.kernels import block_matmul as _bm

SCHEDULES = ("xla", "summa", "cannon")

# Elements per row chunk when building A from node features: the (rows, n,
# dim) difference tensor of an n=10512 climate graph would be 5 GB at once.
_BUILD_CHUNK_ELEMS = 1 << 25


def matmul(
    a: torch.Tensor, b: torch.Tensor, *, schedule: str = "xla", out_dtype=None
) -> torch.Tensor:
    """C = A @ B through the ``block_matmul`` kernel (fp32 accumulation)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; want one of {SCHEDULES}")
    return _bm.block_matmul(a, b, out_dtype=out_dtype or a.dtype)


def _rowblock_body(r0: int, blk: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(blk.to(torch.float32), x)


def matmul_rowblock(m, x: torch.Tensor, *, prefetch_depth: int | None = None) -> torch.Tensor:
    """(n x n) @ (n x k) with k << n, fp32 accumulation: the solver mat-vec.

    ``m`` may be a snapshot handle (an out-of-core P1 / P2): its row panels
    then stream onto ``x``'s device, so the operator is never resident.
    """
    xf = x.to(torch.float32)
    if is_streamable(m):
        out = tile_stream(_rowblock_body, m, device=x.device, consts=(xf,),
                          prefetch_depth=prefetch_depth)
    else:
        out = _rowblock_body(0, m, xf)
    return out.to(x.dtype)


def add_scaled_identity(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """x + scale * I as a new matrix, without materializing I."""
    out = x.clone()
    out.diagonal().add_(scale)
    return out


def build_from_nodes(
    feats: torch.Tensor,
    kernel_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    *,
    dtype=torch.float32,
    zero_diagonal: bool = True,
) -> torch.Tensor:
    """A[i, j] = kernel_fn(feats[i], feats[j]), built in row chunks on feats' device."""
    n = feats.shape[0]
    per_row = n * max(1, feats.shape[1] if feats.ndim > 1 else 1)
    step = max(1, _BUILD_CHUNK_ELEMS // per_row)
    a = torch.empty((n, n), dtype=dtype, device=feats.device)
    for r0 in range(0, n, step):
        a[r0:r0 + step] = kernel_fn(feats[r0:r0 + step], feats).to(dtype)
    if zero_diagonal:
        a.diagonal().zero_()
    return a
