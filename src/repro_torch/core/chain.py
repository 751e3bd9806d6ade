"""Peng-Spielman inverse-chain product (paper Algorithm 2, ChainProduct).

Single-device port of :mod:`repro.core.chain`:

    P = (I + S)(I + S^2)(I + S^4) ... (I + S^{2^{d-1}})  ~=  (I - S)^{-1}

(the product telescopes: (I - S) P = I - S^{2^d}), giving the approximate
Laplacian pseudo-inverse Z^ = D^{-1/2} P D^{-1/2} (the symmetric sandwich;
see the JAX module for the erratum against the paper's Alg. 2 line 8).

Cost: 2(d-1) + 1 dense n x n GEMMs, every one through the hand-written fp32
``block_matmul`` CUDA kernel on the card.  ``fuse_l=True`` forms
P2 = Z^ D - Z^ A instead of materializing L.  ``oocore=True`` runs the chain
against store-backed working matrices instead
(:func:`repro_torch.core.oochain.chain_product_oocore`).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import torch

from repro_torch.core import laplacian as lap
from repro_torch.core.distmatrix import add_scaled_identity, matmul
from repro_torch.core.tiles import is_streamable, tile_stream
from repro_torch.obs import REGISTRY


def chain_build_count() -> int:
    """Chain operators built since process start (the ``chain.builds`` counter)."""
    return int(REGISTRY.value("chain.builds"))


@dataclass
class ChainOperator:
    """Precomputed pieces so every solver iteration is a mat-vec.

    ``p1`` / ``p2`` are device tensors, or snapshot handles into a scratch
    store when the operator was built out-of-core; the solver then streams
    them per panel.  ``rho`` is the power-iteration estimate of
    rho(S~^{2^d}), measured once at build time and read by the Chebyshev
    solver.  ``prefetch_depth`` and ``use_gemm_kernel`` ride along for the
    streamed consumers: the staging depth and whether solves go through the
    ``stream_gemm`` / ``fused_panel_matvec`` kernels.
    """

    p1: torch.Tensor  # (n, n)  Z^ = D^{-1/2} P D^{-1/2}  (tensor or handle)
    p2: torch.Tensor  # (n, n)  Z^ @ L                    (tensor or handle)
    deg: torch.Tensor  # (n,)
    vol: torch.Tensor  # 0-dim V_G
    rho: float | None = None
    prefetch_depth: int = 2
    use_gemm_kernel: bool = False

    def release_scratch(self) -> None:
        """Retire store-backed P1 / P2 from their scratch store (no-op when
        resident).  A failed removal warns: scoring already succeeded and
        the scratch is disposable, but a growing scratch dir must show."""
        for buf in (self.p1, self.p2):
            store = getattr(buf, "store", None)
            if store is not None and hasattr(buf, "snap_id"):
                try:
                    store.remove_snapshot(buf.snap_id)
                except (OSError, ValueError, KeyError) as e:
                    warnings.warn(
                        f"release_scratch: could not remove snapshot {buf.snap_id!r} "
                        f"from its scratch store ({e!r})",
                        RuntimeWarning,
                        stacklevel=2,
                    )


def _load(r0: int, blk: torch.Tensor) -> torch.Tensor:
    return blk


def chain_product(
    a,
    d_len: int,
    *,
    schedule: str = "cannon",
    dtype=torch.float32,
    deflate: bool = True,
    fuse_l: bool = False,
    oocore: bool = False,
    oocore_work=None,
    oocore_panel_rows: int | None = None,
    tile_codec: str = "raw",
    prefetch_depth: int | None = None,
    use_gemm_kernel: bool = False,
    device=None,
) -> ChainOperator:
    """Build the chain operator of ``a``: a device tensor or a snapshot handle.

    Resident (``oocore=False``), a handle is streamed panel by panel onto
    ``device`` and the chain runs on the assembled tensor.  ``oocore=True``
    spills S / T / P through a scratch :class:`~repro_torch.store.TileStore`
    (``oocore_work``: a store, a directory, or None for host RAM) so device
    residency is a few row panels; see
    :func:`repro_torch.core.oochain.chain_product_oocore` for the panel-I/O
    knobs.  ``device`` is read only for a handle (a tensor's own device is
    used otherwise).
    """
    if d_len < 1:
        raise ValueError("chain length d must be >= 1")
    n = int(a.shape[0])
    n_gemms = 2 * (d_len - 1) + 1
    REGISTRY.add_named({
        "chain.builds": 1.0,
        "chain.gemm_flops": n_gemms * 2.0 * float(n) ** 3,
        "chain.gemm_bytes": n_gemms * 3.0 * float(n) ** 2 * 4.0,
    })
    if not is_streamable(a):
        device = a.device
    if oocore:
        from repro_torch.core.oochain import chain_product_oocore

        return chain_product_oocore(
            a, d_len, deflate=deflate, fuse_l=fuse_l, work=oocore_work,
            panel_rows=oocore_panel_rows, tile_codec=tile_codec,
            prefetch_depth=prefetch_depth, use_gemm_kernel=use_gemm_kernel, device=device,
        )
    if is_streamable(a):
        a = tile_stream(_load, a, device=device, prefetch_depth=prefetch_depth)

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
