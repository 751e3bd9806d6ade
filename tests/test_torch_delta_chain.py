"""The port's incremental delta chain against the JAX package (CPU, plain kernels).

The same numpy adjacencies go to both packages.  Tolerances, each stated
where it is used:

* ``_rademacher_omega``: bitwise;
* ``truncate_factors``: the product u v^T within 1e-5 x its largest entry
  (both packages run the same float64 numpy algebra on the same input; only
  the final float32 rounding of each factor can differ); the optimality case
  is the reference test's (rtol 1e-4, atol 1e-4);
* ``try_delta_update`` on one JAX-built base carried across by ``interop``:
  the drift within 1e-6 relative to the sketch norm ||S~ W|| (the drift is
  ||dS W|| / ||S~ W||, and dS W is a difference of two fp32 passes, so its
  rounding is relative to the passes); ``p1_scale`` within 1e-6 relative, and the
  products u1 v1^T and u2 v2^T within 1e-5 x the largest entry of the
  operator each corrects (P1, P2; factors are fixed only up to a rotation,
  so products are compared; dP2 = P1' L' - P1 L is a difference of fp32
  passes, so its rounding scales with P2, not with the correction);
* the corrected operator's solve, from the JAX-built corrected operator:
  solutions within 1e-4 x max|y| (same steps, same arithmetic);
* whole incremental sequences: scores at the reference's acceptance
  tolerance (rtol 1e-3, atol 1e-3 of the commute-distance scale V_G E||z||^2,
  ``tests/test_delta_chain.py``) and the chain counters of every push equal.
"""

import warnings
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.core import CommuteConfig as JConfig
from repro.core import build_base_chain as j_build_base
from repro.core import chain_product as j_chain
from repro.core import detect_sequence_anomalies as j_detect_seq
from repro.core import solve as j_solve
from repro.core import truncate_factors as j_truncate
from repro.core import try_delta_update as j_try_delta
from repro.core.delta_chain import _rademacher_omega as j_omega
from repro.core.solvers import SolverSpec as JSpec
from repro.graphs import gmm_snapshot_sequence as j_gmm
from repro.obs.metrics import REGISTRY as J_REGISTRY
from repro.store import TileStore as JStore
from repro_torch.core import (
    CommuteConfig,
    SequenceDetector,
    build_base_chain,
    chain_product,
    commute_time_embedding,
    detect_sequence_anomalies,
    full_build_gemm_cost,
    truncate_factors,
    try_delta_update,
)
from repro_torch.core.delta_chain import _rademacher_omega
from repro_torch.core.solvers import SolverSpec, solve
from repro_torch.interop import base_chain_from_numpy, chain_operator_from_numpy
from repro_torch.obs import REGISTRY
from repro_torch.store import TileStore

# Localized drift (3 movers a step) keeps dS near low rank, the regime the
# delta path is for (tests/test_delta_chain.py's sequence).
_DRIFT_KW = dict(seed=5, noise=0.02, inject_steps=set(), drift_nodes=3)
_CFG_KW = dict(eps_rp=1e-2, d=3, q=8, k_override=4, solver="cg", solver_tol=1e-5,
               warm_start=True)
_INC_KW = dict(incremental_chain=True, delta_rank=6, delta_budget=0.1)
_COUNTERS = ("builds", "full_rebuilds", "incremental_updates", "drift_fallbacks",
             "gemm_flops", "gemm_bytes", "scratch_bytes", "delta_gemm_flops",
             "delta_gemm_bytes")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _drifting(ctx, n, t_steps) -> list[np.ndarray]:
    return [np.array(a) for a in j_gmm(ctx, n, t_steps, **_DRIFT_KW).snapshots()]


def _abrupt(ctx, n) -> np.ndarray:
    """A structurally different draw (tests/test_delta_chain.py:168)."""
    return np.array(next(j_gmm(ctx, n, 2, seed=99, noise=0.02, inject_steps=set()).snapshots()))


def _chain_counters(metrics: dict | None) -> dict:
    return {f: float((metrics or {}).get(f"chain.{f}", 0.0)) for f in _COUNTERS}


def _scale(snap: np.ndarray, cfg: CommuteConfig) -> float:
    """The commute-distance scale V_G E||z_i||^2 (the reference's atol anchor)."""
    emb = commute_time_embedding(_t(snap), replace(cfg, oocore=False), device="cpu")
    z = emb.z.numpy().astype(np.float64)
    return float(emb.vol) * float((z * z).sum(1).mean())


def _product(u, v) -> np.ndarray:
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    return u @ v.T


def _close(got, want, rtol, floor):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor * np.abs(want).max())


# ---------------------------------------------------------------------------
# the factor algebra
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m,seed", [(48, 8, 0x5EED), (300, 6, 0xD2), (7, 3, 2**32 + 5)])
def test_rademacher_omega_bitwise(n, m, seed):
    want = j_omega(n, m, seed)
    got = _rademacher_omega(n, m, seed)
    assert got.dtype == np.float32 and got.shape == (n, m)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("r", [1, 3, 6, 12])
def test_truncate_factors_matches_jax(r):
    rng = np.random.default_rng(r)
    u = rng.normal(size=(64, 8)).astype(np.float32)
    v = rng.normal(size=(64, 8)).astype(np.float32)
    ut, vt = truncate_factors(u, v, r)
    jut, jvt = j_truncate(u, v, r)
    assert ut.shape == jut.shape and vt.shape == jvt.shape and ut.dtype == np.float32
    _close(_product(ut, vt), _product(jut, jvt), 0, 1e-5)  # 1e-5 x max entry


def test_truncate_factors_is_optimal_rank_r():
    """The residual of the rank-r recompression equals the singular-value tail
    of u v^T (tests/test_delta_chain.py:227, same tolerance)."""
    rng = np.random.default_rng(0)
    u = rng.normal(size=(40, 6)).astype(np.float32)
    v = rng.normal(size=(40, 6)).astype(np.float32)
    prod = _product(u, v)
    s = np.linalg.svd(prod, compute_uv=False)
    for r in (2, 4, 6):
        ut, vt = truncate_factors(u, v, r)
        assert ut.shape == (40, r) and vt.shape == (40, r)
        err = np.linalg.norm(prod - _product(ut, vt))
        np.testing.assert_allclose(err, np.linalg.norm(s[r:]), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the level sink and one delta update, against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("oocore", [False, True], ids=["resident", "oocore"])
@pytest.mark.parametrize("d", [1, 3, 5])
def test_level_sink_matches_jax(ctx1, d, oocore):
    """T_0..T_{d-1} and P_1..P_{d-2} retained by both packages (chain
    tolerance of tests/test_torch_chain_solver.py: rtol 1e-4, floor 1e-4 x
    max); out of core the scratch keeps exactly those levels plus P1 / P2."""
    a = _drifting(ctx1, 48, 2)[0]
    jsink, sink = {}, {}
    if oocore:
        ja = JStore.create(None, n=48, grid=4).put_snapshot("a", a)
        ta = TileStore.create(None, n=48, grid=4).put_snapshot("a", a)
        j_chain(ctx1, ja, d, oocore=True, level_sink=jsink)
        op = chain_product(ta, d, oocore=True, device="cpu", level_sink=sink)
        assert len(op.p1.store.snapshot_ids) == 2 + d + max(d - 2, 0)
        host = [h.to_numpy() for h in sink["t"] + sink["p"]]
        jsink = {k: [h.to_numpy() for h in v] for k, v in jsink.items()}
    else:
        j_chain(ctx1, ctx1.put_matrix(a), d, schedule="xla", level_sink=jsink)
        chain_product(_t(a), d, level_sink=sink)
        host = [x.numpy() for x in sink["t"] + sink["p"]]
    assert len(sink["t"]) == d and len(sink["p"]) == max(d - 2, 0)
    for got, want in zip(host, [np.asarray(x) for x in jsink["t"] + jsink["p"]], strict=True):
        _close(got, want, 1e-4, 1e-4)


def _carried_base(jbase):
    """A JAX resident BaseChain carried into the port through interop."""
    jop = jbase.op
    op = chain_operator_from_numpy(np.asarray(jop.p1), np.asarray(jop.p2), np.asarray(jop.deg),
                                   float(jop.vol), jop.rho, device="cpu")
    return base_chain_from_numpy([np.asarray(t) for t in jbase.t_levels],
                                 [np.asarray(p) for p in jbase.p_levels], op,
                                 jbase.d_len, jbase.deflate)


@pytest.mark.parametrize("d,rank", [(3, 4), (5, 6)])
def test_try_delta_update_matches_jax(ctx1, d, rank):
    snaps = _drifting(ctx1, 64, 3)
    jcfg = JConfig(**(_CFG_KW | {"d": d}), schedule="xla", incremental_chain=True,
                   delta_rank=rank)
    cfg = CommuteConfig(**(_CFG_KW | {"d": d}), incremental_chain=True, delta_rank=rank)
    jbase = j_build_base(ctx1, ctx1.put_matrix(snaps[0]), jcfg)
    base = _carried_base(jbase)
    for a in snaps[1:]:
        jop = j_try_delta(ctx1, jbase, ctx1.put_matrix(a), jcfg)
        jdrift = J_REGISTRY.gauge("chain.drift_last")
        op = try_delta_update(base, _t(a), cfg)
        drift = REGISTRY.gauge("chain.drift_last")
        assert jop is not None and op is not None and op.shared_base
        # within 1e-6 relative to ||S~ W||, the drift's own denominator: its
        # numerator ||dS W|| is a difference of two fp32 passes, whose
        # rounding scales with the passes, not with the (small) difference
        assert drift == pytest.approx(jdrift, rel=0, abs=1e-6)
        assert op.rho == jop.rho and op.p1 is base.op.p1 and op.p2 is base.op.p2
        _close(op.p1_scale.numpy(), jop.p1_scale, 1e-6, 0)
        _close(op.deg.numpy(), jop.deg, 1e-6, 0)
        # each correction within 1e-5 x the largest entry of the operator it
        # corrects (P1' = s P1 s + u1 v1^T, P2' = P2 + u2 v2^T)
        for u, v, ju, jv, p in ((op.u1, op.v1, jop.u1, jop.v1, jop.p1),
                                (op.u2, op.v2, jop.u2, jop.v2, jop.p2)):
            np.testing.assert_allclose(_product(u, v), _product(ju, jv), rtol=0,
                                       atol=1e-5 * np.abs(np.asarray(p)).max())


@pytest.mark.parametrize("method", ["richardson", "chebyshev", "cg"])
def test_corrected_operator_solve_matches_jax(ctx1, method):
    """The JAX-built corrected operator through interop into the port's
    resident solver: the chi build with p1_scale/u1/v1 and u2 v2^T in every
    P2 product (fixed q: same steps; solutions within 1e-4 x max|y|)."""
    snaps = _drifting(ctx1, 64, 2)
    jcfg = JConfig(**_CFG_KW, schedule="xla", **_INC_KW)
    jbase = j_build_base(ctx1, ctx1.put_matrix(snaps[0]), jcfg)
    jop = j_try_delta(ctx1, jbase, ctx1.put_matrix(snaps[1]), jcfg)
    corr = {k: np.asarray(getattr(jop, k)) for k in ("p1_scale", "u1", "v1", "u2", "v2")}
    op = chain_operator_from_numpy(np.asarray(jop.p1), np.asarray(jop.p2), np.asarray(jop.deg),
                                   float(jop.vol), jop.rho, device="cpu", **corr)
    assert op.shared_base
    b = np.random.default_rng(3).normal(size=(64, 4)).astype(np.float32)
    jy, jrep = j_solve(ctx1, jop, ctx1.put_rowblock(b), JSpec(method=method), fixed_q=6)
    y, rep = solve(op, torch.from_numpy(b), SolverSpec(method=method), fixed_q=6)
    assert rep.iterations == jrep.iterations
    _close(y.numpy(), jy, 1e-4, 1e-4)


def test_interop_rejects_partial_correction():
    z = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError, match="all together"):
        chain_operator_from_numpy(z, z, np.ones(4), 4.0, 0.5, device="cpu",
                                  p1_scale=np.ones(4), u1=z[:, :1])


# ---------------------------------------------------------------------------
# whole incremental sequences against the JAX package
# ---------------------------------------------------------------------------


def _j_snapshots(ctx, snaps, storage):
    if storage == "resident":
        return [ctx.put_matrix(a) for a in snaps]
    store = JStore.create(None, n=snaps[0].shape[0], grid=4)
    return [store.put_snapshot(f"t{t:03d}", a) for t, a in enumerate(snaps)]


def _t_snapshots(snaps, storage):
    if storage == "resident":
        return [_t(a) for a in snaps]
    store = TileStore.create(None, n=snaps[0].shape[0], grid=4)
    return [store.put_snapshot(f"t{t:03d}", a) for t, a in enumerate(snaps)]


@pytest.mark.parametrize("storage,kernel", [("resident", False), ("oocore", False),
                                            ("oocore", True)],
                         ids=["resident", "oocore", "oocore-kernel"])
@pytest.mark.parametrize("method", ["richardson", "chebyshev", "cg"])
def test_incremental_sequence_matches_jax(ctx1, method, storage, kernel):
    """Incremental runs of both packages on the same drifting sequence, with
    a drift fallback at the last push: scores at the reference's acceptance
    tolerance and every push's chain counters equal.  The JAX package runs
    its XLA streamed path out of core (its kernel path's streamed solve does
    not pass its own tests on the CPU); the port runs both of its routes."""
    n = 48
    snaps = [*_drifting(ctx1, n, 3), _abrupt(ctx1, n)]
    kw = _CFG_KW | {"solver": method, "solver_tol": 1e-4 if method != "cg" else 1e-5}
    oo = storage == "oocore"
    jcfg = JConfig(**kw, schedule="xla", oocore=oo, **_INC_KW)
    cfg = CommuteConfig(**kw, oocore=oo, use_gemm_kernel=kernel, **_INC_KW)
    jres = j_detect_seq(ctx1, _j_snapshots(ctx1, snaps, storage), jcfg, top_k=5)
    res = detect_sequence_anomalies(_t_snapshots(snaps, storage), cfg, top_k=5, device="cpu")
    scale = _scale(snaps[0], cfg)
    for t, (tr, jtr) in enumerate(zip(res.transitions, jres.transitions, strict=True)):
        np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jtr.scores), rtol=1e-3,
                                   atol=1e-3 * scale, err_msg=f"transition {t}")
    assert _chain_counters(res.warmup_metrics) == _chain_counters(jres.warmup_metrics)
    got = [_chain_counters(m) for m in res.transition_metrics]
    assert got == [_chain_counters(m) for m in jres.transition_metrics]
    assert [m["incremental_updates"] for m in got] == [1, 1, 0]
    assert [m["drift_fallbacks"] for m in got] == [0, 0, 1]


# ---------------------------------------------------------------------------
# the reference's own bars, held by the port alone
# ---------------------------------------------------------------------------


def test_incremental_gemm_flops_and_scratch_at_least_3x_less(ctx1):
    """Every incremental transition's chain FLOPs and materialized scratch
    (``chain.gemm_flops`` / ``chain.scratch_bytes``) are >= 3x below one
    full build's at n=96, d=3, rank 6 (tests/test_delta_chain.py:132)."""
    n = 96
    cfg = CommuteConfig(**(_CFG_KW | {"k_override": 6}), **_INC_KW)
    res = detect_sequence_anomalies([_t(a) for a in _drifting(ctx1, n, 3)], cfg, top_k=5,
                                    device="cpu")
    full_flops, _, full_scratch = full_build_gemm_cost(n, cfg.d)
    assert _chain_counters(res.warmup_metrics)["full_rebuilds"] == 1
    for t, m in enumerate(res.transition_metrics):
        c = _chain_counters(m)
        assert c["incremental_updates"] == 1 and c["drift_fallbacks"] == 0, t
        assert 0 < c["gemm_flops"] <= full_flops / 3.0, (t, c["gemm_flops"], full_flops)
        assert 0 < c["scratch_bytes"] <= full_scratch / 3.0, (t, c["scratch_bytes"])


def test_drift_monitor_falls_back_on_abrupt_change(ctx1):
    """A structurally different snapshot trips the drift monitor: one fallback
    and one full rebuild (the new base); the quiet transitions stay deltas."""
    n = 48
    snaps = [*_drifting(ctx1, n, 3), _abrupt(ctx1, n)]
    cfg = CommuteConfig(**_CFG_KW, **_INC_KW)
    res = detect_sequence_anomalies([_t(a) for a in snaps], cfg, top_k=5, device="cpu")
    assert _chain_counters(res.warmup_metrics)["full_rebuilds"] == 1
    per_t = [_chain_counters(m) for m in res.transition_metrics]
    assert [m["incremental_updates"] for m in per_t] == [1, 1, 0]
    assert [m["drift_fallbacks"] for m in per_t] == [0, 0, 1]
    assert [m["full_rebuilds"] for m in per_t] == [0, 0, 1]
    assert res.chain_builds == 2
    for tr in res.transitions:
        assert torch.isfinite(tr.scores).all()


def test_shared_base_scratch_lifecycle_oocore(ctx1):
    """The base chain owns the out-of-core scratch: a corrected operator's
    ``release_scratch()`` is a no-op, ``BaseChain.release()`` empties the
    scratch once, and a second release is a clean no-op."""
    cfg = CommuteConfig(**_CFG_KW, oocore=True, **_INC_KW)
    snaps = _t_snapshots(_drifting(ctx1, 48, 2), "oocore")
    base = build_base_chain(snaps[0], cfg, device="cpu")
    store = base.op.p1.store
    live = set(store.snapshot_ids)
    assert len(live) == 2 + cfg.d + (cfg.d - 2)  # P1, P2, T levels, P levels

    corrected = try_delta_update(base, snaps[1], cfg)
    assert corrected is not None and corrected.shared_base
    corrected.release_scratch()
    base.op.release_scratch()
    assert set(store.snapshot_ids) == live

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        base.release()
        assert store.snapshot_ids == []
        base.release()


def test_finalize_releases_the_base_oocore(ctx1, tmp_path):
    """After finalize() the on-disk scratch holds no snapshot: no retained
    level leaks."""
    work = tmp_path / "scratch"
    cfg = CommuteConfig(**_CFG_KW, oocore=True, oocore_dir=str(work), **_INC_KW)
    det = SequenceDetector(cfg, top_k=5, device="cpu")
    for h in _t_snapshots(_drifting(ctx1, 48, 3), "oocore"):
        det.push(h)
    # the base's P1, P2 and retained levels; the embeddings' operators share them
    assert len(TileStore.open(work).snapshot_ids) == 2 + cfg.d + (cfg.d - 2)
    det.finalize()
    assert TileStore.open(work).snapshot_ids == []


def test_donate_with_shared_base_frees_no_base_tensor(ctx1):
    """``donate=True`` frees the outgoing adjacency and embedding but no
    tensor of the shared base chain; scores equal the run without donate."""
    cfg = CommuteConfig(**_CFG_KW, **_INC_KW)
    snaps = _drifting(ctx1, 48, 4)
    keep = detect_sequence_anomalies([_t(a) for a in snaps], cfg, top_k=5, device="cpu")
    owned = [torch.tensor(a) for a in snaps]  # memory torch owns, so it can be freed
    det = SequenceDetector(cfg, top_k=5, donate=True, device="cpu")
    for a in owned:
        det.push(a)
    base = det._base
    assert owned[0].untyped_storage().nbytes() == 0  # left the two-snapshot window
    for x in (base.op.p1, base.op.p2, base.op.deg, *base.t_levels, *base.p_levels):
        assert x.untyped_storage().nbytes() > 0
    res = det.finalize()
    assert base.released
    for a, b in zip(res.transitions, keep.transitions, strict=True):
        np.testing.assert_array_equal(a.scores.numpy(), b.scores.numpy())


@pytest.mark.slow
@pytest.mark.parametrize("storage", ["resident", "oocore"])
@pytest.mark.parametrize("rank", [4, 8])
def test_incremental_sweep_rank_storage(ctx1, rank, storage):
    """Heavy sweep: delta rank x storage at n=96, T=4, warm-started CG -- the
    port's incremental scores at the reference's tolerance of its own full
    rebuild, zero fallbacks."""
    n, t_steps = 96, 4
    oo = storage == "oocore"
    full_cfg = CommuteConfig(**(_CFG_KW | {"k_override": 6}), oocore=oo)
    inc_cfg = replace(full_cfg, incremental_chain=True, delta_rank=rank, delta_budget=0.1)
    snaps = _drifting(ctx1, n, t_steps)
    full = detect_sequence_anomalies(_t_snapshots(snaps, storage), full_cfg, top_k=5,
                                     device="cpu")
    inc = detect_sequence_anomalies(_t_snapshots(snaps, storage), inc_cfg, top_k=5,
                                    device="cpu")
    scale = _scale(snaps[0], full_cfg)
    for t, (f, i) in enumerate(zip(full.transitions, inc.transitions, strict=True)):
        np.testing.assert_allclose(i.scores.numpy(), f.scores.numpy(), rtol=1e-3,
                                   atol=1e-3 * scale, err_msg=f"rank={rank} {storage} {t}")
    per_t = [_chain_counters(m) for m in inc.transition_metrics]
    assert sum(m["incremental_updates"] for m in per_t) == t_steps - 1
    assert sum(m["drift_fallbacks"] for m in per_t) == 0


@pytest.mark.slow
def test_reference_and_port_share_the_accuracy_limit(ctx1):
    """At n=2048, T=4 and the CLI's rank 4 (d=6, q=10, eps 1e-3, richardson),
    the third delta's scores miss the reference's own acceptance tolerance
    against the full rebuild (rtol 1e-3, atol 1e-3 of V_G E||z||^2) in both
    packages alike: the limit is the algorithm's (the rank-r sketch of dS
    drops the degree-scaling part every neighbour of a mover carries), not
    the port's.  Each transition's largest error, as a fraction of the
    scale, agrees between the packages within 10% (plus 2e-5 absolute)."""
    n = 2048
    snaps = [np.array(a) for a in j_gmm(ctx1, n, 4, **_DRIFT_KW).snapshots()]
    jcfg = JConfig(eps_rp=1e-3, d=6, q=10, schedule="xla")
    cfg = CommuteConfig(eps_rp=1e-3, d=6, q=10)
    scale = _scale(snaps[0], cfg)
    errs = {}
    for name, run in (
        ("jax", lambda c: j_detect_seq(ctx1, [ctx1.put_matrix(a) for a in snaps], c, top_k=20)),
        ("port", lambda c: detect_sequence_anomalies([_t(a) for a in snaps], c, top_k=20,
                                                     device="cpu")),
    ):
        base_cfg = jcfg if name == "jax" else cfg
        full = run(base_cfg)
        inc = run(replace(base_cfg, incremental_chain=True))
        excess, frac = [], []
        for f, i in zip(full.transitions, inc.transitions, strict=True):
            fs = np.asarray(f.scores, np.float64)
            diff = np.abs(np.asarray(i.scores, np.float64) - fs)
            frac.append(diff.max() / scale)
            excess.append((diff - 1e-3 * np.abs(fs) - 1e-3 * scale).max())
        assert excess[0] < 0 and excess[2] > 0, (name, excess)
        errs[name] = frac
    np.testing.assert_allclose(errs["port"], errs["jax"], rtol=0.1, atol=2e-5)
