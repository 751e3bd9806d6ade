"""Power-iteration estimate of rho(S~^{2^d}), the Richardson contraction.

Port of :mod:`repro.core.solvers.power`.  ``G = I - P2`` is similar to the
symmetric ``S~^{2^d}``; its spectrum on the 1-orthogonal subspace lies in
``[0, rho]``.  The start vector is the same numpy draw as the JAX package's,
moved to P2's device, so both estimate from the same ``v0``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.distmatrix import matmul_rowblock

DEFAULT_POWER_ITERS = 16


def estimate_rho(p2: torch.Tensor, *, iters: int = DEFAULT_POWER_ITERS, seed: int = 0) -> float:
    """Spectral-radius estimate of ``G = I - P2``, clamped to ``[0, 0.999]``."""
    if iters < 1:
        raise ValueError(f"power iters must be >= 1, got {iters}")
    n = int(p2.shape[0])
    rng = np.random.default_rng(seed)
    v0 = rng.normal(size=(n, 1)).astype(np.float32)
    v0 -= v0.mean(axis=0, keepdims=True)
    v0 /= max(float(np.linalg.norm(v0)), 1e-30)
    v = torch.from_numpy(v0).to(p2.device)

    nrm = None
    for _ in range(iters):  # stays on the device; one host sync at the end
        gv = v - matmul_rowblock(p2, v)
        gv = gv - gv.mean(dim=0, keepdim=True)
        nrm = torch.sqrt(torch.sum(gv * gv))
        v = gv / torch.clamp(nrm, min=1e-30)
    rho = float(nrm)
    if not math.isfinite(rho) or rho < 1e-12:
        return 0.0  # G annihilated the iterate: the contraction is effectively zero
    return float(min(rho, 0.999))
