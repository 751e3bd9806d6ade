"""Peng-Spielman inverse-chain product (paper Algorithm 2, ChainProduct).

Port of :mod:`repro.core.chain`:

    P = (I + S)(I + S^2)(I + S^4) ... (I + S^{2^{d-1}})  ~=  (I - S)^{-1}

(the product telescopes: (I - S) P = I - S^{2^d}), giving the approximate
Laplacian pseudo-inverse Z^ = D^{-1/2} P D^{-1/2} (the symmetric sandwich;
see the JAX module for the erratum against the paper's Alg. 2 line 8).

Cost: 2(d-1) + 1 dense n x n GEMMs, every one through the hand-written fp32
``block_matmul`` CUDA kernel on the card; on a device grid each is a tile
program of ``schedule`` (:func:`repro_torch.core.distmatrix.matmul`).
``fuse_l=True`` forms
P2 = Z^ D - Z^ A instead of materializing L.  ``oocore=True`` runs the chain
against store-backed working matrices instead
(:func:`repro_torch.core.oochain.chain_product_oocore`).  ``level_sink``
keeps the chain's levels for incremental delta updates
(:mod:`repro_torch.core.delta_chain`).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import torch

from repro_torch.core import laplacian as lap
from repro_torch.core.distmatrix import (
    ITEM_9B,
    DistContext,
    add_scaled_identity,
    grid_of,
    matmul,
    on_grid,
)
from repro_torch.core.tiles import is_streamable, tile_stream
from repro_torch.obs import REGISTRY


# The count is a view over the registry's ``chain.builds`` counter, which the
# run reports read too; a reset moves this base instead of clearing the counter.
_BUILD_BASE = 0.0  # ``chain.builds`` at the last reset_chain_build_count()


def chain_build_count() -> int:
    """Chain operators built since process start or the last reset."""
    return int(REGISTRY.value("chain.builds") - _BUILD_BASE)


def reset_chain_build_count() -> None:
    """Restart :func:`chain_build_count` from 0 (the registry counter keeps going)."""
    global _BUILD_BASE
    _BUILD_BASE = REGISTRY.value("chain.builds")


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

    An incremental update (:func:`repro_torch.core.delta_chain.try_delta_update`)
    keeps the base chain's ``p1`` / ``p2`` and sets the low-rank correction:
    the operator then stands for P1' = diag(p1_scale) P1 diag(p1_scale) +
    u1 v1^T and P2' = P2 + u2 v2^T, which the solver applies as rank-r
    epilogues around every product.  ``shared_base`` marks P1 / P2 as a live
    base chain's, shared with other operators: :meth:`release_scratch` then
    leaves them alone, and ``BaseChain.release`` is their one owner.
    """

    p1: torch.Tensor  # (n, n)  Z^ = D^{-1/2} P D^{-1/2}  (tensor or handle)
    p2: torch.Tensor  # (n, n)  Z^ @ L                    (tensor or handle)
    deg: torch.Tensor  # (n,)
    vol: torch.Tensor  # 0-dim V_G
    rho: float | None = None
    prefetch_depth: int = 2
    use_gemm_kernel: bool = False
    p1_scale: torch.Tensor | None = None  # (n,)
    u1: torch.Tensor | None = None  # (n, r)
    v1: torch.Tensor | None = None  # (n, r)
    u2: torch.Tensor | None = None  # (n, r)
    v2: torch.Tensor | None = None  # (n, r)
    shared_base: bool = False

    def release_scratch(self) -> None:
        """Retire store-backed P1 / P2 from their scratch store (no-op when
        resident, or while ``shared_base`` is set).  A failed removal warns:
        scoring already succeeded and the scratch is disposable, but a
        growing scratch dir must show."""
        if self.shared_base:
            return
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
    level_sink: dict | None = None,
    ctx: DistContext | None = None,
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

    ``level_sink`` (a caller's dict) keeps the levels the incremental delta
    path multiplies against: on return ``level_sink["t"]`` holds T_0 ..
    T_{d-1} and ``level_sink["p"]`` P_1 .. P_{d-2} (P_0 = I + T_0 is applied
    implicitly, the last P is never needed), as tensors, or as scratch
    snapshots out of core.  The caller owns their lifetime
    (``BaseChain.release``).

    ``ctx`` (or ``a`` itself being a DistMatrix) runs the resident chain on
    a device grid with ``schedule``; P1 and P2 are then DistMatrices and
    deg / vol live on the home device.  ``oocore``, ``fuse_l``, ``level_sink``
    and a snapshot handle stay single-device (ROADMAP item 9b) and raise on
    a larger grid.
    """
    if d_len < 1:
        raise ValueError("chain length d must be >= 1")
    n = int(a.shape[0])
    n_gemms = 2 * (d_len - 1) + 1
    REGISTRY.add_named({
        "chain.builds": 1.0,
        "chain.gemm_flops": n_gemms * 2.0 * float(n) ** 3,
        "chain.gemm_bytes": n_gemms * 3.0 * float(n) ** 2 * 4.0,
        # one fresh n^2 matrix per GEMM plus the S~ assembly
        "chain.scratch_bytes": (n_gemms + 1) * float(n) ** 2 * 4.0,
    })
    ctx = grid_of(ctx, a)
    if ctx is not None and not ctx.is_trivial and (
            oocore or fuse_l or level_sink is not None or is_streamable(a)):
        raise NotImplementedError(
            f"chain_product with oocore, fuse_l, level_sink or a snapshot handle: {ITEM_9B}")
    a = on_grid(ctx, a)
    if not is_streamable(a):
        device = a.device
    if oocore:
        from repro_torch.core.oochain import chain_product_oocore

        return chain_product_oocore(
            a, d_len, deflate=deflate, fuse_l=fuse_l, work=oocore_work,
            panel_rows=oocore_panel_rows, tile_codec=tile_codec,
            prefetch_depth=prefetch_depth, use_gemm_kernel=use_gemm_kernel, device=device,
            level_sink=level_sink,
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
    if level_sink is not None:
        level_sink["t"], level_sink["p"] = [t], []
    for lvl in range(1, d_len):
        t = mm(t, t)  # S^{2^k}
        # P (I + T) = P T + P: add P into the fresh product in place, so no
        # third n^2 buffer holds the sum.  Every level is a fresh tensor, so
        # a retained one is never written again.
        p_prev, p = p, mm(p, t).add_(p)
        if level_sink is not None:
            level_sink["t"].append(t)
            if lvl > 1:  # P_0 = I + T_0 is applied implicitly
                level_sink["p"].append(p_prev)
        del p_prev
    del t

    # in place: the last P is never retained and not needed again
    p1 = lap.sym_scale_(p, lap.inv_sqrt_degrees(deg))
    del p
    if fuse_l:
        # P2 = Z^ (D - A) = (Z^ col-scaled by d) - Z^ @ A
        p2 = mm(p1, a.to(dtype))
        p2.neg_().add_(p1 * deg[None, :])
    else:
        p2 = mm(p1, lap.laplacian(a, deg, dtype=dtype))

    from repro_torch.core.solvers.power import estimate_rho

    return ChainOperator(p1=p1, p2=p2, deg=deg, vol=vol, rho=estimate_rho(p2))
