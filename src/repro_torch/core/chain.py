"""Peng-Spielman inverse-chain product (paper Algorithm 2, ChainProduct).

Resident, single-device port of :mod:`repro.core.chain`:

    P = (I + S)(I + S^2)(I + S^4) ... (I + S^{2^{d-1}})  ~=  (I - S)^{-1}

(the product telescopes: (I - S) P = I - S^{2^d}), giving the approximate
Laplacian pseudo-inverse Z^ = D^{-1/2} P D^{-1/2} (the symmetric sandwich;
see the JAX module for the erratum against the paper's Alg. 2 line 8).

Cost: 2(d-1) + 1 dense n x n GEMMs, every one through the hand-written fp32
``block_matmul`` CUDA kernel on the card.  ``fuse_l=True`` forms
P2 = Z^ D - Z^ A instead of materializing L.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import laplacian as lap
from repro_torch.core.distmatrix import add_scaled_identity, matmul
from repro_torch.obs import REGISTRY


def chain_build_count() -> int:
    """Chain operators built since process start (the ``chain.builds`` counter)."""
    return int(REGISTRY.value("chain.builds"))


@dataclass
class ChainOperator:
    """Precomputed pieces so every solver iteration is a mat-vec.

    ``rho`` is the power-iteration estimate of rho(S~^{2^d}), measured once
    at build time and read by the Chebyshev solver.
    """

    p1: torch.Tensor  # (n, n)  Z^ = D^{-1/2} P D^{-1/2}
    p2: torch.Tensor  # (n, n)  Z^ @ L
    deg: torch.Tensor  # (n,)
    vol: torch.Tensor  # 0-dim V_G
    rho: float | None = None


def chain_product(
    a: torch.Tensor,
    d_len: int,
    *,
    schedule: str = "cannon",
    dtype=torch.float32,
    deflate: bool = True,
    fuse_l: bool = False,
) -> ChainOperator:
    """Build the chain operator of the resident adjacency ``a``."""
    if d_len < 1:
        raise ValueError("chain length d must be >= 1")
    n = int(a.shape[0])
    n_gemms = 2 * (d_len - 1) + 1
    REGISTRY.add_named({
        "chain.builds": 1.0,
        "chain.gemm_flops": n_gemms * 2.0 * float(n) ** 3,
        "chain.gemm_bytes": n_gemms * 3.0 * float(n) ** 2 * 4.0,
    })

    def mm(x, y):
        return matmul(x, y, schedule=schedule, out_dtype=dtype)

    deg = lap.degrees(a)
    vol = lap.volume(deg)
    s = lap.normalized_adjacency(a, deg, deflate=deflate, dtype=dtype)

    t = s
    p = add_scaled_identity(s, 1.0)  # I + S
    del s
    for _ in range(1, d_len):
        t = mm(t, t)  # S^{2^k}
        # P (I + T) = P T + P: add P into the fresh product in place, so no
        # third n^2 buffer holds the sum.
        p = mm(p, t).add_(p)
    del t

    p1 = lap.sym_scale_(p, lap.inv_sqrt_degrees(deg))  # in place: P is not needed again
    del p
    if fuse_l:
        # P2 = Z^ (D - A) = (Z^ col-scaled by d) - Z^ @ A
        p2 = mm(p1, a.to(dtype))
        p2.neg_().add_(p1 * deg[None, :])
    else:
        p2 = mm(p1, lap.laplacian(a, deg, dtype=dtype))

    from repro_torch.core.solvers.power import estimate_rho

    return ChainOperator(p1=p1, p2=p2, deg=deg, vol=vol, rho=estimate_rho(p2))
