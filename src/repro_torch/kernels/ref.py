"""Plain PyTorch versions of the three hand-written kernels.

Port of :mod:`repro.kernels.ref`.  The wrappers run these for CPU tensors,
and ``chip_smoke.py`` holds each CUDA kernel against them on the card.  The
edge projection and the CAD scorer work in row chunks so they also fit on
the card at n=10512: a whole (n, n, k) int64 hash tensor would be 15 GB.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import rng as crng

# Elements per row chunk of the (rows, n, k) hash tensor / (rows, n) tiles.
_CHUNK_ELEMS = 1 << 24


def _row_chunks(m: int, per_row: int):
    step = max(1, _CHUNK_ELEMS // max(per_row, 1))
    for r0 in range(0, m, step):
        yield r0, min(m, r0 + step)


def block_matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """C = A @ B with fp32 accumulation."""
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(out_dtype)


def edge_projection(a: torch.Tensor, *, seed: int, k: int) -> torch.Tensor:
    """Y[i, c] = sum_j sqrt(max(A_ij, 0)) Q_c[i, j] / sqrt(k)."""
    m, n = a.shape
    dev = a.device
    cols = torch.arange(n, device=dev, dtype=torch.int64)[None, :, None]
    ks = torch.arange(k, device=dev, dtype=torch.int64)[None, None, :]
    y = torch.empty((m, k), dtype=torch.float32, device=dev)
    for r0, r1 in _row_chunks(m, n * k):
        s = torch.sqrt(torch.clamp(a[r0:r1].to(torch.float32), min=0.0))
        rows = torch.arange(r0, r1, device=dev, dtype=torch.int64)[:, None, None]
        q = crng.edge_rademacher(seed, rows, cols, ks)
        y[r0:r1] = torch.sum(s[:, :, None] * q, dim=1)
    return y * (1.0 / math.sqrt(k))


def _dist(zi: torch.Tensor, zj: torch.Tensor, vol) -> torch.Tensor:
    zi = zi.to(torch.float32)
    zj = zj.to(torch.float32)
    sq_i = torch.sum(zi * zi, dim=-1)
    sq_j = torch.sum(zj * zj, dim=-1)
    return vol * (sq_i[:, None] + sq_j[None, :] - 2.0 * (zi @ zj.T))


def cad_scores_tile(a1, a2, z1i, z1j, z2i, z2j, vol1, vol2) -> torch.Tensor:
    """Partial row scores (m,) of one (m, n) adjacency tile."""
    m, n = a1.shape
    out = torch.empty((m,), dtype=torch.float32, device=a1.device)
    for r0, r1 in _row_chunks(m, n):
        de = torch.abs(a1[r0:r1].to(torch.float32) - a2[r0:r1].to(torch.float32)) * torch.abs(
            _dist(z1i[r0:r1], z1j, vol1) - _dist(z2i[r0:r1], z2j, vol2)
        )
        out[r0:r1] = torch.sum(de, dim=1)
    return out


def cad_scores(a1, a2, z1, z2, vol1, vol2) -> torch.Tensor:
    """Node anomaly scores F (n,) from two embeddings (square case)."""
    return cad_scores_tile(a1, a2, z1, z1, z2, z2, vol1, vol2)
