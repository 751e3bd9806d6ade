"""The port's out-of-core path against the JAX package's (CPU, plain kernels).

The same numpy adjacencies go to both packages, through stores each package
writes itself.  The port's kernel path (``use_gemm_kernel``) runs the plain
versions of ``stream_gemm`` / ``fused_panel_matvec`` here; the JAX package
is held on its XLA streamed path (``use_gemm_kernel=False``), because its
own kernel-path streamed solve does not pass its tests on the CPU.

Tolerances: chain operator (P1, P2, deg, vol, rho) rtol 1e-4 with an
absolute floor of 1e-4 x the largest entry (entries cross zero); with the
bf16 scratch codec the floor is 2^-8 x the largest entry (one bf16 ulp)
for P1 and 2^-6 for P2, because each chain level is rounded to bf16 in both
packages and an entry whose accumulation order differs can round to the
neighbouring bf16 value; such a flip in P1 reaches P2 = P1 L scaled by a
degree, and moves the rho estimate by up to 1e-3 relative.
Solutions and scores rtol 1e-4 with a 1e-4 x max floor; top-k ids
identical; iteration counts equal under fixed q.  The port's fused kernel
path measures the residual from ``gy - y``, as its plain path does, so a
fixed-q solve runs every step; the JAX kernel path reduces it from the
kernel's fp32 moments ``ss - |cs|^2 / n``, which cancel to <= 0 at the
fp32 floor and end the solve early.
"""

import numpy as np
import pytest
import torch

from repro.core import CommuteConfig as JConfig
from repro.core import SequenceDetector as JDetector
from repro.core.chain import chain_product as j_chain
from repro.core.solvers import SolverSpec as JSpec
from repro.core.solvers import solve as j_solve
from repro.graphs import gmm_graph_sequence
from repro.graphs import gmm_snapshot_sequence as j_gmm
from repro.store import TileStore as JStore
from repro_torch.core import CommuteConfig, SequenceDetector, chain_product, detect_anomalies
from repro_torch.core.solvers import SolverSpec, solve
from repro_torch.core.tiles import reset_stream_stats, stream_stats
from repro_torch.launch import caddelag_run
from repro_torch.store import TileStore

N = 64
GRID = 4  # 16-row store panels; the scratch grid is 2 (32-row panels)


def _close(got, want, rtol=1e-4, floor=1e-4):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor * np.abs(want).max())


@pytest.fixture(scope="module")
def adj(ctx1) -> np.ndarray:
    """GMM similarity graph (well-separated clusters: the solve needs iterations)."""
    return np.array(gmm_graph_sequence(ctx1, n=N, seed=0).a1)


def _handles(a: np.ndarray, codec: str = "raw"):
    n = a.shape[0]
    jh = JStore.create(None, n=n, grid=GRID, codec=codec).put_snapshot("a", a)
    th = TileStore.create(None, n=n, grid=GRID, codec=codec).put_snapshot("a", a)
    return jh, th


def _rhs(k=4, seed=100):
    return np.random.default_rng(seed).normal(size=(N, k)).astype(np.float32)


@pytest.mark.parametrize("codec", ["raw", "bf16"])
@pytest.mark.parametrize("d,n", [
    pytest.param(3, N, id="3"), pytest.param(6, N, id="6"), pytest.param(1, N, id="1"),
    # 15-row store tiles and scratch panels: ragged against every kernel tile
    pytest.param(3, 60, id="3-n60"),
])
@pytest.mark.parametrize("kernel", [False, True])
def test_oocore_chain_matches_jax(ctx1, adj, d, n, codec, kernel):
    a = adj if n == N else np.array(gmm_graph_sequence(ctx1, n=n, seed=0).a1)
    jh, th = _handles(a, codec)
    jop = j_chain(ctx1, jh, d, oocore=True, tile_codec=codec)
    op = chain_product(th, d, oocore=True, tile_codec=codec, use_gemm_kernel=kernel, device="cpu")
    bf16 = codec == "bf16"
    _close(op.p1.to_numpy(), jop.p1.to_numpy(), floor=2.0**-8 if bf16 else 1e-4)
    _close(op.p2.to_numpy(), jop.p2.to_numpy(), floor=2.0**-6 if bf16 else 1e-4)
    _close(op.deg.numpy(), jop.deg)
    _close(float(op.vol), float(jop.vol))
    assert op.rho == pytest.approx(jop.rho, rel=1e-3 if bf16 else 1e-4, abs=1e-6)
    assert op.p1.store.manifest.codec == codec and op.use_gemm_kernel == kernel
    assert len(op.p1.store.snapshot_ids) == 2  # only P1 / P2 survive the build


def test_oocore_fuse_l_and_resident_input_match_jax(ctx1, adj):
    jh, th = _handles(adj)
    jop = j_chain(ctx1, jh, 3, oocore=True, fuse_l=True)
    for a in (th, torch.from_numpy(adj)):  # a handle, and a resident tensor
        op = chain_product(a, 3, oocore=True, fuse_l=True, device="cpu")
        _close(op.p2.to_numpy(), jop.p2.to_numpy())
        _close(op.p1.to_numpy(), jop.p1.to_numpy())


def test_resident_chain_from_a_handle_equals_the_tensor(adj):
    _, th = _handles(adj)
    from_handle = chain_product(th, 3, device="cpu")
    from_tensor = chain_product(torch.from_numpy(adj), 3)
    assert torch.equal(from_handle.p2, from_tensor.p2)


@pytest.mark.parametrize("codec", ["raw", "bf16"])
@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("method", ["richardson", "chebyshev", "cg"])
def test_streamed_solve_matches_jax_xla(ctx1, adj, method, codec, kernel):
    jh, th = _handles(adj, codec)
    jop = j_chain(ctx1, jh, 6, oocore=True, tile_codec=codec)
    op = chain_product(th, 6, oocore=True, tile_codec=codec, use_gemm_kernel=kernel, device="cpu")
    b = _rhs()
    jy, jrep = j_solve(ctx1, jop, ctx1.put_rowblock(b), JSpec(method=method), fixed_q=6)
    y, rep = solve(op, torch.from_numpy(b), SolverSpec(method=method), fixed_q=6)
    _close(y.numpy(), jy)
    assert rep.iterations == jrep.iterations == 5
    assert rep.streamed and jrep.streamed
    if not kernel:  # the same passes over the same panels
        assert (rep.panels, rep.bytes_h2d, rep.bytes_read) == (jrep.panels, jrep.bytes_h2d,
                                                                jrep.bytes_read)


@pytest.mark.parametrize("kernel", [False, True])
def test_streamed_adaptive_chebyshev_to_tolerance_matches_jax(ctx1, adj, kernel):
    jh, th = _handles(adj)
    jop = j_chain(ctx1, jh, 3, oocore=True)
    op = chain_product(th, 3, oocore=True, use_gemm_kernel=kernel, device="cpu")
    b = _rhs()
    spec = dict(method="chebyshev", tolerance=1e-4, max_iters=60)
    jy, jrep = j_solve(ctx1, jop, ctx1.put_rowblock(b), JSpec(**spec))
    y, rep = solve(op, torch.from_numpy(b), SolverSpec(**spec))
    assert abs(rep.iterations - jrep.iterations) <= 1 and rep.converged == jrep.converged
    assert rep.rho_final == pytest.approx(jrep.rho_final, rel=1e-3)
    _close(y.numpy(), jy, rtol=1e-3, floor=1e-3)


@pytest.mark.parametrize("method", ["richardson", "cg"])
def test_oocore_matches_resident(adj, method):
    _, th = _handles(adj)
    b = torch.from_numpy(_rhs())
    res_op = chain_product(torch.from_numpy(adj), 6)
    y_res, _ = solve(res_op, b, SolverSpec(method=method), fixed_q=6)
    for kernel in (False, True):
        op = chain_product(th, 6, oocore=True, use_gemm_kernel=kernel, device="cpu")
        y, _ = solve(op, b, SolverSpec(method=method), fixed_q=6)
        _close(y.numpy(), y_res.numpy())


def test_kernel_path_is_one_panel_pass_per_iteration(adj):
    _, th = _handles(adj, "bf16")
    op = chain_product(th, 3, oocore=True, tile_codec="bf16", use_gemm_kernel=True, device="cpu")
    n_panels = N // int(op.p2.panel_rows)
    st = stream_stats()
    p0 = st.panels
    _, rep = solve(op, torch.from_numpy(_rhs()), SolverSpec(), fixed_q=5)
    # one chi pass (P1) + one pass per iteration (P2), nothing else
    assert st.panels - p0 == rep.panels == n_panels * (rep.iterations + 1)


def test_fixed_q_kernel_solve_runs_every_step_past_the_moments_floor():
    """A climate graph whose residual reaches the fp32 floor within three
    steps, where the kernel's fp32 moments cancel to <= 0: the fixed-q kernel
    solve, which measures the residual from gy - y, still runs q - 1 steps,
    like the plain streamed solve."""
    from repro_torch.core.embedding import edge_projection
    from repro_torch.graphs import climate_snapshot_sequence

    a = next(iter(climate_snapshot_sequence(8, 12, t_steps=2, device="cpu").snapshots()))
    h = TileStore.create(None, n=a.shape[0], grid=GRID).put_snapshot("a", a.numpy())
    op = chain_product(h, 6, oocore=True, use_gemm_kernel=True, device="cpu")
    b = edge_projection(h, 0, 8, device="cpu")
    (y_k, rep_k), (y_p, rep_p) = (solve(op, b, SolverSpec(), fixed_q=10, use_gemm_kernel=k)
                                  for k in (True, False))
    assert rep_k.iterations == rep_p.iterations == 9
    assert min(rep_k.residuals) > 0
    _close(y_k.numpy(), y_p.numpy())


def test_bf16_kernel_path_halves_solve_h2d(adj):
    """Stored-form bf16 panels: per-pass H2D <= 0.55x the host-decoded fp32 path."""
    _, th = _handles(adj, "bf16")
    b = torch.from_numpy(_rhs())
    reps, saved = {}, {}
    for kernel in (False, True):
        op = chain_product(th, 6, oocore=True, tile_codec="bf16", use_gemm_kernel=kernel,
                           device="cpu")
        s0 = stream_stats().bytes_h2d_saved
        y, reps[kernel] = solve(op, b, SolverSpec(), fixed_q=6)
        saved[kernel] = stream_stats().bytes_h2d_saved - s0
    per_pass = {k: r.bytes_h2d / r.panels for k, r in reps.items()}
    assert per_pass[True] <= 0.55 * per_pass[False]
    assert saved[True] > 0 and saved[False] == 0
    op = chain_product(th, 3, oocore=True, use_gemm_kernel=True, device="cpu")  # raw scratch
    s0 = stream_stats().bytes_h2d_saved
    solve(op, b, SolverSpec(), fixed_q=4)
    assert stream_stats().bytes_h2d_saved == s0  # raw ships fp32 either way


@pytest.mark.parametrize("kernel", [False, True])
def test_solver_batch_replays_bitwise_and_reads_less(adj, kernel):
    _, th = _handles(adj)
    op = chain_product(th, 6, oocore=True, use_gemm_kernel=kernel, device="cpu")
    b = torch.from_numpy(_rhs())
    y1, r1 = solve(op, b, SolverSpec(), fixed_q=10)
    y4, r4 = solve(op, b, SolverSpec(), fixed_q=10, solver_batch=4)
    assert torch.equal(y1, y4)
    assert r4.bytes_read * 2 <= r1.bytes_read and r4.panels == r1.panels


def test_oocore_device_residency_is_panels(adj):
    _, th = _handles(adj)
    reset_stream_stats()
    op = chain_product(th, 3, oocore=True, use_gemm_kernel=True, device="cpu")
    ph = op.p2.panel_rows
    assert 0 < stream_stats().peak_live_bytes <= 4 * ph * N * 4


@pytest.mark.parametrize("codec,kernel", [("raw", True), ("bf16", True), ("raw", False)])
def test_sequence_over_store_matches_jax(ctx1, codec, kernel):
    snaps = [np.array(a) for a in j_gmm(ctx1, N, 3, seed=1, inject_p=0.02).snapshots()]
    jstore = JStore.create(None, n=N, grid=GRID, codec=codec)
    tstore = TileStore.create(None, n=N, grid=GRID, codec=codec)
    for i, a in enumerate(snaps):
        jstore.put_snapshot(f"t{i}", a)
        tstore.put_snapshot(f"t{i}", a)
    jcfg = JConfig(d=6, q=10, schedule="xla", oocore=True, tile_codec=codec)
    cfg = CommuteConfig(d=6, q=10, oocore=True, tile_codec=codec, use_gemm_kernel=kernel)
    jres = JDetector(ctx1, jcfg, top_k=8).run(jstore.iter_snapshots())
    res = SequenceDetector(cfg, top_k=8, device="cpu").run(tstore.iter_snapshots())
    assert res.chain_builds == 3 and len(res.transitions) == 2
    for tr, jtr in zip(res.transitions, jres.transitions):
        _close(tr.scores.numpy(), jtr.scores)
        assert tr.top_idx.tolist() == np.asarray(jtr.top_idx).tolist()
        assert [r.iterations for r in tr.solve_reports] == [9, 9]
    assert res.global_top_idx.tolist() == np.asarray(jres.global_top_idx).tolist()
    assert res.global_top_step.tolist() == np.asarray(jres.global_top_step).tolist()
    _close(res.global_top_val, np.asarray(jres.global_top_val))
    assert tstore.snapshot_ids == ["t0", "t1", "t2"]  # the user's store is never touched


def test_scratch_is_retired_as_operators_die(tmp_path, adj):
    a2 = adj.copy()
    a2[:8, :8] *= 1.5
    store = TileStore.create(tmp_path / "snaps", n=N, grid=GRID)
    h1, h2 = store.put_snapshot("a", adj), store.put_snapshot("b", a2)
    cfg = CommuteConfig(d=3, q=4, oocore=True, oocore_dir=str(tmp_path / "scratch"),
                        use_gemm_kernel=True)
    res = detect_anomalies(h1, h2, cfg, top_k=5, device="cpu")
    assert res.scores.shape == (N,) and torch.isfinite(res.scores).all()
    assert TileStore.open(tmp_path / "scratch").snapshot_ids == []
    det = SequenceDetector(cfg, top_k=5, device="cpu")
    det.run([h1, h2, h1])
    # only the newest operator's P1 / P2 are still live
    assert len(TileStore.open(tmp_path / "scratch").snapshot_ids) == 2


def test_cli_oocore_runs(tmp_path, capsys):
    caddelag_run.main(["--device", "cpu", "--store", str(tmp_path / "st"), "--oocore-chain",
                       "--use-gemm-kernel", "--tile-codec", "bf16", "--n", "64", "--t-steps",
                       "3", "--d", "3", "--q", "4"])
    out = capsys.readouterr().out
    assert "3 chain builds for 2 transitions" in out
    assert "codec=bf16" in out and "saved by on-device decode" in out
    assert "MB scratch" in out and "NOT-CONVERGED" not in out
    assert TileStore.open(tmp_path / "st").snapshot_ids == ["t0000", "t0001", "t0002"]
