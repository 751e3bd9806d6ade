"""Power-iteration estimate of rho(S~^{2^d}), the Richardson contraction.

Port of :mod:`repro.core.solvers.power`.  ``G = I - P2`` is similar to the
symmetric ``S~^{2^d}``; its spectrum on the 1-orthogonal subspace lies in
``[0, rho]``.  The start vector is the same numpy draw as the JAX package's,
moved to P2's device, so both estimate from the same ``v0``.  A store-backed
P2 (an out-of-core operator) is wrapped in a
:class:`~repro_torch.store.CachingHandle`, so the whole estimate costs one
real scratch pass; the other passes replay panels from host RAM.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.distmatrix import matmul_rowblock
from repro_torch.core.tiles import is_streamable

DEFAULT_POWER_ITERS = 16


def estimate_rho(
    p2,
    *,
    iters: int = DEFAULT_POWER_ITERS,
    seed: int = 0,
    device: str | torch.device | None = None,
    prefetch_depth: int | None = None,
    ctx=None,
) -> float:
    """Spectral-radius estimate of ``G = I - P2``, clamped to ``[0, 0.999]``.

    ``p2`` is a tensor, a DistMatrix or a snapshot handle; a handle's
    iterate lives on ``device`` (a grid's home device), its panels stream
    onto the tiles of ``ctx``.
    """
    if iters < 1:
        raise ValueError(f"power iters must be >= 1, got {iters}")
    n = int(p2.shape[0])
    rng = np.random.default_rng(seed)
    v0 = rng.normal(size=(n, 1)).astype(np.float32)
    v0 -= v0.mean(axis=0, keepdims=True)
    v0 /= max(float(np.linalg.norm(v0)), 1e-30)
    handle = p2
    if is_streamable(p2):
        from repro_torch.store import CachingHandle  # the store is optional

        handle = CachingHandle(p2)
    else:
        device = p2.device
    v = torch.from_numpy(v0).to(device)

    nrm = None
    for _ in range(iters):  # stays on the device; one host sync at the end
        gv = v - matmul_rowblock(handle, v, ctx=ctx, prefetch_depth=prefetch_depth)
        gv = gv - gv.mean(dim=0, keepdim=True)
        nrm = torch.sqrt(torch.sum(gv * gv))
        v = gv / torch.clamp(nrm, min=1e-30)
    rho = float(nrm)
    if not math.isfinite(rho) or rho < 1e-12:
        return 0.0  # G annihilated the iterate: the contraction is effectively zero
    return float(min(rho, 0.999))
