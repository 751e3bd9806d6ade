"""Incremental delta-chain updates: skip the O(n^3) rebuild on small drift.

Port of :mod:`repro.core.delta_chain` (one device).  A slowly drifting
transition changes the chain operator by a small-norm perturbation, so
instead of rebuilding the chain:

1. **Sketch** ``dS = S~' - S~`` against a counter-generated Rademacher test
   matrix (dS is never formed): a randomized range-finder compresses it to a
   rank-r factorisation ``U0 V0^T``, and the same sketch gives the drift
   monitor ``||dS W||_F / ||S~ W||_F``.
2. **Propagate** the correction through the squaring recurrence.  With
   ``T_l = T_{l-1}^2`` and ``P_l = P_{l-1}(I + T_l)`` (all T_l symmetric):

       dT_l = [T U, U] [V, T V + V (U^T V)]^T               (rank 2r)
       dP_l = [E, P Ut + E (F^T Ut)] [F + T_l F, Vt]^T      (rank 2r)

   where (U, V) = dT_{l-1}, (E, F) = dP_{l-1}, (Ut, Vt) = dT_l.  Every
   product against a base level is a skinny n x w pass through
   :func:`repro_torch.core.distmatrix.matmul_rowblock` (a plain product, per
   row panel for store-backed levels), so a level costs O(n^2 r) instead of
   O(n^3); each level recompresses 2r -> r by QR and a small SVD.
3. **Correct the operator.**  ``P1' = diag(s) P1 diag(s) + E~ F~^T`` is
   exact (s = sqrt(deg) / sqrt(deg'), E~ = D'^{-1/2} E); ``dP2 = P1' L' -
   P1 L`` is compressed by a two-pass range-finder on its implicit forward
   and adjoint applies (the base L x comes from the retained T_0 = S~, so no
   base adjacency is kept).  The corrected
   :class:`~repro_torch.core.chain.ChainOperator` carries ``(p1_scale, u1,
   v1, u2, v2)``, which every solver applies as rank-r epilogues.

The small factor algebra (QR and SVD of (n, <= 2r + 2) factors) runs in
float64 numpy on the host, as in the reference, so the drift decision and
the truncations see the same numbers in both packages; the n^2 passes run
on the operator's device.  No kernel is launched here.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import laplacian as lap
from repro_torch.core import rng as crng
from repro_torch.core.chain import ChainOperator, chain_product
from repro_torch.core.distmatrix import matmul_rowblock
from repro_torch.obs import REGISTRY

# Range-finder oversampling: the sketch is delta_rank + DELTA_OVERSAMPLE
# columns wide; the extra columns absorb the tail so the leading r directions
# are captured accurately (Halko/Martinsson/Tropp's few-column margin).
DELTA_OVERSAMPLE = 2


class _GemmLedger:
    """Logical FLOP / byte counts of the chain phase's passes (fp32, counted
    at dispatch, not measured: a stable ratio between rebuild and delta).

    * ``flops``: a skinny (n, n) x (n, w) pass is ``2 n^2 w``;
    * ``bytes``: operand plus result traffic, ``(n^2 + 2 n w) * 4``;
    * ``scratch``: bytes materialized, only the (n, w) result, ``n w * 4``.
    """

    def __init__(self) -> None:
        self.flops = 0.0
        self.bytes = 0.0
        self.scratch = 0.0

    def skinny(self, n: int, w: int) -> None:
        self.flops += 2.0 * n * n * w
        self.bytes += (n * n + 2.0 * n * w) * 4.0
        self.scratch += n * w * 4.0


def full_build_gemm_cost(n: int, d_len: int) -> tuple[float, float, float]:
    """(flops, bytes, scratch) of one full chain build.

    ``2 (d-1) + 1`` dense n x n GEMMs; scratch also counts the S~ assembly,
    so ``2 d`` fresh n^2 matrices in all.
    """
    gemms = 2 * (d_len - 1) + 1
    return (
        gemms * 2.0 * n**3,
        gemms * 3.0 * n * n * 4.0,
        (gemms + 1) * n * n * 4.0,
    )


@dataclass
class BaseChain:
    """A full chain build plus the retained levels delta updates multiply against.

    ``t_levels`` holds T_0 .. T_{d-1} (T_0 = S~), ``p_levels`` P_1 .. P_{d-2}:
    tensors, or scratch snapshot handles out of core.  ``op`` is the base
    operator with ``shared_base=True``, so no per-snapshot
    ``release_scratch()`` retires scratch that corrected operators still
    stream; :meth:`release` is the one place the base dies.
    """

    op: ChainOperator
    t_levels: list = field(default_factory=list)
    p_levels: list = field(default_factory=list)
    d_len: int = 1
    deflate: bool = True
    released: bool = False

    def release(self) -> None:
        """Retire the base: the operator's scratch and every retained level.

        Idempotent: a second call does nothing (no double removal).  The base
        operator stays marked shared, so an embedding that still holds it
        does not try to remove the same scratch again when it leaves the
        sequence's window.
        """
        if self.released:
            return
        self.released = True
        for buf in (self.op.p1, self.op.p2, *self.t_levels, *self.p_levels):
            store = getattr(buf, "store", None)
            if store is not None and hasattr(buf, "snap_id"):
                try:
                    store.remove_snapshot(buf.snap_id)
                except (OSError, ValueError, KeyError) as e:
                    warnings.warn(
                        f"BaseChain.release: could not remove scratch snapshot "
                        f"{buf.snap_id!r} ({e!r})",
                        RuntimeWarning,
                        stacklevel=2,
                    )
        self.t_levels, self.p_levels = [], []


def build_base_chain(a, cfg, *, device=None) -> BaseChain:
    """A full chain build of ``a`` that also keeps the levels delta updates
    need.  Counts one ``chain.full_rebuilds``.  ``device`` is read only for a
    snapshot handle, as in :func:`~repro_torch.core.chain.chain_product`."""
    sink: dict = {}
    op = chain_product(
        a, cfg.d, schedule=cfg.schedule, dtype=cfg.dtype, deflate=cfg.deflate,
        fuse_l=cfg.fuse_l, oocore=cfg.oocore, oocore_work=cfg.oocore_dir,
        oocore_panel_rows=cfg.oocore_panel_rows, tile_codec=cfg.tile_codec,
        prefetch_depth=cfg.prefetch_depth, use_gemm_kernel=cfg.use_gemm_kernel,
        device=device, level_sink=sink,
    )
    op.shared_base = True
    REGISTRY.add_named({"chain.full_rebuilds": 1.0})
    return BaseChain(op=op, t_levels=list(sink.get("t", ())), p_levels=list(sink.get("p", ())),
                     d_len=cfg.d, deflate=cfg.deflate)


def truncate_factors(u: np.ndarray, v: np.ndarray, r: int) -> tuple[np.ndarray, np.ndarray]:
    """Best rank-r recompression of ``u @ v.T`` (exact, O(n r^2)).

    QR both factors and SVD the small core: ``u v^T = qu (ru rv^T) qv^T``;
    the top r singular triplets of the core give the optimal rank-r
    approximation of the product.
    """
    qu, ru = np.linalg.qr(u.astype(np.float64))
    qv, rv = np.linalg.qr(v.astype(np.float64))
    w, s, zt = np.linalg.svd(ru @ rv.T)
    rr = min(int(r), s.size)
    u_t = qu @ (w[:, :rr] * s[:rr])
    v_t = qv @ zt[:rr].T
    return u_t.astype(np.float32), v_t.astype(np.float32)


def _rademacher_omega(n: int, m: int, seed: int, device=None) -> np.ndarray:
    """(n, m) +/-1 test matrix from the counter hash: ``hash_u32(seed, row,
    col) >> 31``, bitwise the reference's.  Hashed on ``device`` (integer
    arithmetic, exact anywhere) and returned on the host."""
    rows = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(m, dtype=torch.int64, device=device)[None, :]
    h = crng.hash_u32(int(seed) & crng.MASK, rows, cols)
    return (1.0 - 2.0 * (h >> 31).to(torch.float32)).cpu().numpy()


class _Passes:
    """Skinny passes against n x n operands (tensors or handles), on ``device``,
    with ledger accounting."""

    def __init__(self, device: torch.device, depth, ledger: _GemmLedger):
        self.device = device
        self.depth = depth
        self.ledger = ledger

    def mm(self, mat, x_np: np.ndarray) -> np.ndarray:
        """mat @ x for an (n, w) host operand, as float32 on the host."""
        n, w = int(mat.shape[0]), int(x_np.shape[1])
        self.ledger.skinny(n, w)
        x = torch.from_numpy(np.ascontiguousarray(x_np, np.float32)).to(self.device)
        out = matmul_rowblock(mat, x, prefetch_depth=self.depth)
        return out.cpu().numpy()


def try_delta_update(base: BaseChain, a, cfg) -> ChainOperator | None:
    """Corrected operator for snapshot ``a`` against ``base``, or ``None``.

    ``None`` means the sketched drift ``||dS W||_F / ||S~ W||_F`` exceeded
    ``cfg.delta_budget`` and the caller must rebuild.  Deltas are always
    measured against the last full rebuild (never delta on delta), so one
    budget bounds both per-transition and accumulated drift.  ``a`` is a
    tensor on the base's device or a snapshot handle.
    """
    n = int(a.shape[0])
    r = int(cfg.delta_rank)
    m = r + DELTA_OVERSAMPLE
    depth = cfg.prefetch_depth
    dev = base.op.deg.device
    ledger = _GemmLedger()
    ps = _Passes(dev, depth, ledger)

    t_lv, p_lv = base.t_levels, base.p_levels
    if len(t_lv) != base.d_len:
        raise ValueError(
            f"base chain retained {len(t_lv)} T levels for d={base.d_len}; "
            f"was it built with build_base_chain()?"
        )

    # -- the snapshot's degree data (the corrected operator needs it anyway) --
    deg_new = lap.degrees(a, device=dev, prefetch_depth=depth)
    vol_new = lap.volume(deg_new)
    deg_n = deg_new.cpu().numpy().astype(np.float64)
    vol_n = float(vol_new)
    inv_sqrt_n = np.where(deg_n > 0, 1.0 / np.sqrt(np.maximum(deg_n, 1e-30)), 0.0)
    deg_b = base.op.deg.cpu().numpy().astype(np.float64)
    vol_b = float(base.op.vol)
    sqrt_b = np.sqrt(np.maximum(deg_b, 0.0))

    def s_new(x: np.ndarray) -> np.ndarray:
        """S~' x from the raw snapshot: D'^{-1/2} A' D'^{-1/2} x (- u' u'^T x)."""
        y = inv_sqrt_n[:, None] * ps.mm(a, (inv_sqrt_n[:, None] * x).astype(np.float32))
        if base.deflate:
            u = np.sqrt(np.maximum(deg_n, 0.0) / max(vol_n, 1e-30))
            y = y - u[:, None] * (u @ x)
        return y.astype(np.float32)

    # -- 1. sketch dS and measure the drift -----------------------------------
    omega = _rademacher_omega(n, m, cfg.seed + 0x5EED, dev)
    s_base_w = ps.mm(t_lv[0], omega)  # S~ W (base, retained T_0)
    s_new_w = s_new(omega)  # S~' W (implicit, from the raw snapshot)
    dy = s_new_w - s_base_w
    base_norm = max(float(np.linalg.norm(s_base_w)), 1e-30)
    drift = float(np.linalg.norm(dy)) / base_norm
    REGISTRY.append("chain.drift", drift)
    REGISTRY.set_gauge("chain.drift_last", drift)
    if drift > float(cfg.delta_budget):
        REGISTRY.add_named({"chain.drift_fallbacks": 1.0})
        return None

    # Range-finder: dS ~= Q (dS Q)^T (dS symmetric).  Zero drift gives rank-0
    # factors, which the truncation handles.
    q, _ = np.linalg.qr(dy.astype(np.float64))
    q = q.astype(np.float32)
    w0 = s_new(q) - ps.mm(t_lv[0], q)  # dS Q
    u_t, v_t = truncate_factors(q, w0, r)  # dT_0 = dS ~= u_t v_t^T

    # -- 2. propagate through the squaring recurrence -------------------------
    e_f, f_f = u_t.copy(), v_t.copy()  # dP_0 = dS (P_0 = I + T_0)
    for lvl in range(1, base.d_len):
        # dT_lvl from dT_{lvl-1}: one width-2r pass against base T_{lvl-1}
        uv = ps.mm(t_lv[lvl - 1], np.concatenate([u_t, v_t], axis=1))
        tu, tv = uv[:, : u_t.shape[1]], uv[:, u_t.shape[1]:]
        u2r = np.concatenate([tu, u_t], axis=1)
        v2r = np.concatenate([v_t, tv + v_t @ (u_t.T @ v_t)], axis=1)
        ut_new, vt_new = truncate_factors(u2r, v2r, r)
        # dP_lvl: P_{lvl-1} @ Ut (P_0 applied implicitly as I + T_0)
        if lvl == 1:
            pu = ut_new + ps.mm(t_lv[0], ut_new)
        else:
            pu = ps.mm(p_lv[lvl - 2], ut_new)
        tf = ps.mm(t_lv[lvl], f_f)  # T_lvl @ F
        e2r = np.concatenate([e_f, pu + e_f @ (f_f.T @ ut_new)], axis=1)
        f2r = np.concatenate([f_f + tf, vt_new], axis=1)
        e_f, f_f = truncate_factors(e2r, f2r, r)
        u_t, v_t = ut_new, vt_new

    # -- 3. corrected P1 (exact): diag(s) P1 diag(s) + E~ F~^T -----------------
    p1_scale = (sqrt_b * inv_sqrt_n).astype(np.float32)
    u1 = (inv_sqrt_n[:, None] * e_f).astype(np.float32)
    v1 = (inv_sqrt_n[:, None] * f_f).astype(np.float32)

    def p1_corr(x: np.ndarray) -> np.ndarray:
        """P1' x through the base P1 plus the exact correction."""
        y = p1_scale[:, None] * ps.mm(base.op.p1, (p1_scale[:, None] * x).astype(np.float32))
        return (y + u1 @ (v1.T @ x)).astype(np.float32)

    def l_new(x: np.ndarray) -> np.ndarray:
        """L' x = deg' . x - A' x from the raw snapshot."""
        return (deg_n[:, None] * x - ps.mm(a, x)).astype(np.float32)

    def l_base(x: np.ndarray) -> np.ndarray:
        """Base L x from the retained T_0 (no base adjacency is kept):
        A = D^{1/2} (T_0 [+ u u^T]) D^{1/2} with u = sqrt(deg / V_G)."""
        ax = sqrt_b[:, None] * ps.mm(t_lv[0], (sqrt_b[:, None] * x).astype(np.float32))
        if base.deflate:
            du = deg_b / max(np.sqrt(max(vol_b, 1e-30)), 1e-30)  # sqrt(d) . u
            ax = ax + du[:, None] * (du @ x)
        return (deg_b[:, None] * x - ax).astype(np.float32)

    # -- 4. dP2 = P1' L' - P1 L by a two-pass range-finder ---------------------
    omega2 = _rademacher_omega(n, m, cfg.seed + 0xD2, dev)
    fwd = p1_corr(l_new(omega2)) - ps.mm(base.op.p2, omega2)
    q2, _ = np.linalg.qr(fwd.astype(np.float64))
    q2 = q2.astype(np.float32)
    # adjoint on Q: dP2^T q = L'(P1' q) - L(P1 q); the two base-P1 products
    # share one width-2m pass over P1.
    both = ps.mm(base.op.p1, np.concatenate([p1_scale[:, None] * q2, q2], axis=1))
    p1q_scaled, p1q = both[:, : q2.shape[1]], both[:, q2.shape[1]:]
    p1c_q = p1_scale[:, None] * p1q_scaled + u1 @ (v1.T @ q2)
    v2_full = l_new(p1c_q) - l_base(p1q)
    u2, v2 = truncate_factors(q2, v2_full, r)

    REGISTRY.add_named({
        "chain.incremental_updates": 1.0,
        "chain.gemm_flops": ledger.flops,
        "chain.gemm_bytes": ledger.bytes,
        "chain.scratch_bytes": ledger.scratch,
        "chain.delta_gemm_flops": ledger.flops,
        "chain.delta_gemm_bytes": ledger.bytes,
    })

    def put(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(dev)

    return ChainOperator(
        p1=base.op.p1,
        p2=base.op.p2,
        deg=deg_new,
        vol=vol_new,
        prefetch_depth=base.op.prefetch_depth,
        # The base's rho: the corrected spectrum moves by O(||dS||), which
        # the Chebyshev interval adaptation and CG absorb; re-measuring would
        # cost power iterations per transition (and the solver would
        # power-iterate the uncorrected P2 to get it).
        rho=base.op.rho,
        use_gemm_kernel=base.op.use_gemm_kernel,
        p1_scale=put(p1_scale),
        u1=put(u1),
        v1=put(v1),
        u2=put(u2),
        v2=put(v2),
        shared_base=True,
    )
