"""The port's out-of-core, store-streamed and incremental paths on a device grid,
against the JAX package's 2x2 mesh, on the CPU.

The port's grids put every tile on the one CPU device
(``make_context(["cpu"] * 4, 2)`` is 2x2); the JAX side is
``tests/conftest.py``'s ``ctx22`` and ``ctx1`` (and a 2x1 mesh made here).
The same numpy inputs, made from a seed, go to both.  Tolerances are the
JAX tests' own, named where they are used:

* ``tile_stream`` against ``tile_map`` on the same grid: bitwise (the JAX
  ``tile_stream`` docstring's contract), and its ``ValueError`` texts equal
  to the JAX ones;
* streamed against resident detects and sequences on one grid: bitwise
  (``tests/test_store.py``); either against the JAX ``ctx22`` run: rtol 1e-3,
  atol 1e-2 (``test_cad_sharded_matches_single``);
* the out-of-core chain's scores against the resident build: rtol 1e-4,
  atol 1e-3 (``test_oocore_chain_scores_allclose``,
  ``test_solver_batch_cuts_scratch_reads_scores_allclose``), the streamed
  fuse_l product likewise (``test_streamed_fuse_l_close_and_counted``);
* solvers: rtol 1e-4, atol 1e-3 against the fixed-q baseline
  (``test_methods_allclose_to_fixed_q_baseline``), residual norms rel 1e-5
  (``test_residual_norm_streamed_matches_resident``), the kernel-path streamed
  solve rtol 1e-4, atol 1e-4 against the JAX XLA streamed path
  (``test_fused_solve_allclose_vs_two_pass_driver``; the JAX kernel path is
  the seed's red one, ROADMAP "Standing notes");
* the delta chain: rtol 1e-3, atol 1e-3 of the commute-distance scale
  (``test_incremental_scores_allclose_full_rebuild``);
* queries on an artifact published from the grid: ``tests/test_query.py``'s
  (commute blocks rtol 1e-4, atol 1e-3; the exact oracle's median relative
  error under 0.25; top-k values rtol 1e-4, atol 1e-4 and the brute force's ids).
"""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core import CommuteConfig as JConfig
from repro.core import detect_anomalies as j_detect
from repro.core import detect_sequence_anomalies as j_detect_seq
from repro.core.chain import chain_product as j_chain
from repro.core.distmatrix import make_context as j_make_context
from repro.core.embedding import commute_time_embedding as j_embedding
from repro.core.solvers import SolverSpec as JSpec
from repro.core.solvers import solve as j_solve
from repro.core.tiles import tile_stream as j_tile_stream
from repro.graphs import gmm_graph_sequence as j_gmm_graph
from repro.graphs import gmm_snapshot_sequence as j_gmm_snapshots
from repro.store import TileStore as JStore
from repro_torch.core import (
    CommuteConfig,
    DistMatrix,
    SequenceDetector,
    blockwise_unary,
    chain_build_count,
    chain_product,
    commute_block,
    commute_distance_block,
    commute_time_embedding,
    detect_anomalies,
    detect_sequence_anomalies,
    edge_projection,
    estimate_solution,
    exact_commute_distances,
    make_context,
    matmul_rowblock,
    nearest_neighbors,
    reset_stream_stats,
    residual_norm,
    stream_stats,
    tile_map,
    tile_stream,
    top_anomalies_from_store,
    trivial_context,
)
from repro_torch.core import laplacian as lap
from repro_torch.core.distmatrix import _rowblock_body
from repro_torch.core.embedding import _edge_projection_body
from repro_torch.core.solvers import SolverSpec, solve
from repro_torch.core.tiles import MATRIX, REPLICATED
from repro_torch.graphs import gmm_snapshot_sequence, store_snapshot_sequence
from repro_torch.store import EmbeddingStore, PanelPipeline, TileStore

CPU = dict(device="cpu")
# tests/test_store.py's knobs: plumbing, not convergence
CFG = CommuteConfig(eps_rp=1e-2, d=3, q=3, schedule="xla", k_override=4)
J_CFG = JConfig(eps_rp=1e-2, d=3, q=3, schedule="xla", k_override=4)


@pytest.fixture(scope="module")
def g22():
    return make_context(["cpu"] * 4, 2)


@pytest.fixture(scope="module")
def g21():
    return make_context(["cpu"] * 2, 2)


@pytest.fixture(scope="module")
def ctx21():
    """A 2x1 JAX mesh (two fake CPU devices)."""
    return j_make_context(Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model")))


def _sym(n: int, seed: int) -> np.ndarray:
    a = np.abs(np.random.default_rng(seed).normal(size=(n, n))).astype(np.float32)
    a = (a + a.T) / 2.0
    np.fill_diagonal(a, 0.0)
    return a


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _stores(snaps, grid, codec="raw"):
    """The same snapshots in a port store and a JAX store (RAM-backed)."""
    n = snaps[0].shape[0]
    ts = TileStore.create(None, n=n, grid=grid, codec=codec)
    js = JStore.create(None, n=n, grid=grid, codec=codec)
    th = [ts.put_snapshot(f"t{i}", a) for i, a in enumerate(snaps)]
    jh = [js.put_snapshot(f"t{i}", a) for i, a in enumerate(snaps)]
    return th, jh


# ---------------------------------------------------------------------------
# tile_stream on a grid: the tile_map bodies over streamed panels
# ---------------------------------------------------------------------------


def _body_degrees(tile, blk):
    return blk.to(torch.float32).sum(dim=1)


_STREAM_BODIES = {
    "degrees": (_body_degrees, (), (MATRIX,)),
    "edge_projection": (_edge_projection_body, (7, 5), (MATRIX, REPLICATED, REPLICATED)),
    "rowblock": (_rowblock_body, "x", (MATRIX, REPLICATED)),
}


@pytest.mark.parametrize("grid_name", ["g22", "g21"])
@pytest.mark.parametrize("body", sorted(_STREAM_BODIES))
def test_tile_stream_equals_tile_map_bitwise(request, grid_name, body):
    """Each panel tile splits the columns as the resident tile does, so a
    row-parallel body streamed from a store equals the resident grid's
    result bitwise (48-row panels of 24 rows a tile, against 24-row tiles)."""
    g = request.getfixturevalue(grid_name)
    a = _sym(96, 1)
    h = TileStore.create(None, n=96, grid=2).put_snapshot("a", a)
    fn, consts, specs = _STREAM_BODIES[body]
    if consts == "x":
        consts = (torch.from_numpy(np.random.default_rng(2).normal(size=(96, 3)).astype(np.float32)),)
    got = tile_stream(fn, h, *consts, ctx=g, in_specs=specs, reduce="cols")
    want = tile_map(g, fn, g.put_matrix(a), *consts, in_specs=specs, reduce="cols")
    assert got.device == g.home and torch.equal(got, want)


def test_handle_paths_on_a_grid_equal_the_resident_grid_bitwise(g22):
    a = _sym(64, 3)
    h = TileStore.create(None, n=64, grid=4).put_snapshot("a", a)
    ad = g22.put_matrix(a)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(64, 2)).astype(np.float32))
    assert torch.equal(lap.degrees(h, ctx=g22), lap.degrees(ad))
    assert torch.equal(edge_projection(h, 0, 6, ctx=g22), edge_projection(ad, 0, 6))
    assert torch.equal(matmul_rowblock(h, x, ctx=g22), matmul_rowblock(ad, x))
    deg = lap.degrees(ad)
    for got, want in ((lap.normalized_adjacency(h, deg, ctx=g22), lap.normalized_adjacency(ad, deg)),
                      (lap.laplacian(h, deg, ctx=g22), lap.laplacian(ad, deg))):
        assert isinstance(got, DistMatrix) and got.ctx == g22
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_tile_stream_reduce_none_assembles_the_grid_tiles(g22):
    a = _sym(64, 5)
    h = TileStore.create(None, n=64, grid=8).put_snapshot("a", a)  # 8-row panels, 4-row tiles

    def fn(b, rows, cols):
        return b * (rows[:, None] + 2 * cols[None, :]).to(torch.float32)

    got = blockwise_unary(fn, h, ctx=g22)
    want = blockwise_unary(fn, g22.put_matrix(a))
    assert isinstance(got, DistMatrix) and got.block_shape == (32, 32)
    for gr, wr in zip(got.tiles, want.tiles):
        for gt, wt in zip(gr, wr):
            assert gt.is_contiguous() and torch.equal(gt, wt)


def _err(fn, *args, **kw) -> str:
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


def test_tile_stream_errors_are_the_jax_texts(ctx22, g22):
    a = _sym(60, 6)
    th, jh = _stores([a], grid=4)  # 15-row tiles
    x = np.zeros((60, 1), np.float32)
    # 15-row panels and 2 row shards: lcm 30 divides 60, but 24 does not
    for kw in ({"panel_rows": 24}, {"panel_rows": 15}):
        assert _err(tile_stream, _rowblock_body, th[0], torch.from_numpy(x), ctx=g22,
                    in_specs=(MATRIX, REPLICATED), reduce="cols", **kw) == _err(
            j_tile_stream, ctx22, lambda t, b, v: b @ v, jh[0], x,
            in_specs=(ctx22.matrix_spec, jax.sharding.PartitionSpec(None, None)),
            reduce="cols", **kw)
    assert _err(tile_stream, _body_degrees, th[0], ctx=g22, reduce="rows") == _err(
        j_tile_stream, ctx22, lambda t, b: b.sum(1), jh[0], reduce="rows")
    # a store whose tiles do not tile n0 with the row shards: no common height
    th7 = TileStore.create(None, n=63, grid=3).put_snapshot("a", _sym(63, 7))
    jh7 = JStore.create(None, n=63, grid=3).put_snapshot("a", _sym(63, 7))
    assert _err(tile_stream, _body_degrees, th7, ctx=g22, reduce="cols") == _err(
        j_tile_stream, ctx22, lambda t, b: b.sum(1), jh7, reduce="cols")


@pytest.mark.parametrize("encoded", [False, True], ids=["fp32", "bf16-bits"])
def test_pipeline_grid_tiles_are_the_host_panels_slices(g22, encoded):
    """Each grid tile is contiguous, bitwise the host panel's slice; the
    counters are the one-device pipeline's (a panel counts once)."""
    a = _sym(64, 8)
    codec = "bf16" if encoded else "raw"
    h = TileStore.create(None, n=64, grid=4, codec=codec).put_snapshot("a", a)
    got, counts = [], []
    for grid in (g22, None):
        st = reset_stream_stats()
        with PanelPipeline([h], range(0, 64, 16), 16, grid=grid, device="cpu", stats=st,
                           encoded=encoded) as pipe:
            got.append([(r0, p) for r0, (p,) in pipe])
        counts.append(st.snapshot())
    assert counts[0] == counts[1]
    for (r0, dm), (r1, whole) in zip(*got):
        assert r0 == r1 and isinstance(dm, DistMatrix) and dm.block_shape == (8, 32)
        for r in range(2):
            for c in range(2):
                t = dm.tiles[r][c]
                assert t.is_contiguous() and t.dtype == whole.dtype
                assert torch.equal(t, whole[r * 8:(r + 1) * 8, c * 32:(c + 1) * 32])


# ---------------------------------------------------------------------------
# streamed == resident on one grid, bitwise (tests/test_store.py)
# ---------------------------------------------------------------------------


def test_streamed_detect_bitwise_equals_resident(ctx22, g22):
    n = 32
    a1, a2 = _sym(n, 3), _sym(n, 4)
    (h1, h2), (j1, j2) = _stores([a1, a2], grid=4)
    res_r = detect_anomalies(_t(a1), _t(a2), CFG, top_k=5, ctx=g22)
    res_s = detect_anomalies(h1, h2, CFG, top_k=5, ctx=g22)
    assert torch.equal(res_s.scores, res_r.scores) and torch.equal(res_s.top_idx, res_r.top_idx)
    res_m = detect_anomalies(_t(a1), h2, CFG, top_k=5, ctx=g22)  # mixed endpoints stream too
    assert torch.equal(res_m.scores, res_r.scores)
    j = j_detect(ctx22, j1, j2, J_CFG, top_k=5)
    _close(res_s.scores.numpy(), j.scores, 1e-3, 1e-2)


def test_streamed_sequence_bitwise_equals_resident(ctx22, g22):
    n, t_steps = 32, 3
    snaps = [_sym(n, 10 + t) for t in range(t_steps)]
    th, jh = _stores(snaps, grid=2)
    res_r = detect_sequence_anomalies([_t(s) for s in snaps], CFG, top_k=5, ctx=g22)
    builds0 = chain_build_count()
    res_s = detect_sequence_anomalies(th, CFG, top_k=5, ctx=g22)
    assert chain_build_count() - builds0 == t_steps  # one chain build per snapshot
    for a, b in zip(res_r.transitions, res_s.transitions, strict=True):
        assert torch.equal(a.scores, b.scores)
    np.testing.assert_array_equal(res_r.global_top_val, res_s.global_top_val)
    jres = j_detect_seq(ctx22, jh, J_CFG, top_k=5)
    for tr, jtr in zip(res_s.transitions, jres.transitions, strict=True):
        _close(tr.scores.numpy(), jtr.scores, 1e-3, 1e-2)


def test_trivial_context_streams_as_no_grid(g22):
    """A 1x1 context takes the one-device paths: bitwise the ctx=None run."""
    (h1, h2), _ = _stores([_sym(32, 20), _sym(32, 21)], grid=4)
    cfg = replace(CFG, oocore=True, use_gemm_kernel=True)
    a = detect_anomalies(h1, h2, cfg, top_k=5, **CPU)
    b = detect_anomalies(h1, h2, cfg, top_k=5, ctx=trivial_context("cpu"))
    assert torch.equal(a.scores, b.scores)


# ---------------------------------------------------------------------------
# the out-of-core chain on a grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_oocore_chain_scores_allclose(ctx22, g22, kernel, tmp_path):
    """Scores allclose to the resident build on the 2x2 grid, adjacency AND
    chain streamed, the K steps tile by tile; and to the JAX ctx22 run."""
    n = 32
    a1, a2 = _sym(n, 40), _sym(n, 41)
    (h1, h2), (j1, j2) = _stores([a1, a2], grid=4)
    cfg_oo = replace(CFG, oocore=True, use_gemm_kernel=kernel)
    res_r = detect_anomalies(_t(a1), _t(a2), CFG, top_k=5, ctx=g22)
    res_o = detect_anomalies(h1, h2, cfg_oo, top_k=5, ctx=g22)
    _close(res_o.scores, res_r.scores, 1e-4, 1e-3)
    res_m = detect_anomalies(_t(a1), _t(a2), cfg_oo, top_k=5, ctx=g22)  # resident input
    _close(res_m.scores, res_r.scores, 1e-4, 1e-3)
    j = j_detect(ctx22, j1, j2, replace(J_CFG, oocore=True), top_k=5)
    _close(res_o.scores, j.scores, 1e-4, 1e-3)


def test_oocore_operator_records_the_grid_and_matches_jax(ctx1, ctx22, g22):
    a = _clustered(ctx1, 64)  # well-separated clusters: rho is far above the fp32 floor
    (h,), (jh,) = _stores([a], grid=4)
    op = chain_product(h, 3, oocore=True, ctx=g22)
    jop = j_chain(ctx22, jh, 3, oocore=True)
    assert op.ctx == g22 and op.p2.panel_rows == jop.p2.panel_rows
    for mine, theirs in ((op.p1, jop.p1), (op.p2, jop.p2)):
        want = theirs.to_numpy()
        _close(mine.to_numpy(), want, 1e-4, 1e-4 * np.abs(want).max())
    assert op.rho == pytest.approx(jop.rho, rel=1e-3)
    op.release_scratch()


@pytest.mark.parametrize("fuse_l", [False, True], ids=["L", "fuse_l"])
def test_grid_chain_from_a_handle_matches_the_resident_grid(g22, fuse_l):
    """Resident chain on a grid from a handle (every pass streamed; the
    fuse_l product P1 A accumulated panel by panel, allclose as in
    tests/test_store.py's streamed fuse_l); level_sink keeps DistMatrices."""
    a = _sym(64, 43)
    (h,), _ = _stores([a], grid=4)
    sink_h, sink_r = {}, {}
    oh = chain_product(h, 3, fuse_l=fuse_l, ctx=g22, level_sink=sink_h)
    orr = chain_product(_t(a), 3, fuse_l=fuse_l, ctx=g22, level_sink=sink_r)
    assert isinstance(oh.p2, DistMatrix) and oh.ctx == g22
    if fuse_l:
        _close(oh.p2.numpy(), orr.p2.numpy(), 1e-4, 1e-3 * np.abs(orr.p2.numpy()).max())
    else:
        np.testing.assert_array_equal(oh.p2.numpy(), orr.p2.numpy())
    assert [len(sink_h["t"]), len(sink_h["p"])] == [3, 1]
    for x, y in zip(sink_h["t"] + sink_h["p"], sink_r["t"] + sink_r["p"]):
        assert isinstance(x, DistMatrix)
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_solver_batch_cuts_scratch_reads_scores_allclose(g22):
    n, d, q = 32, 3, 9
    a1, a2 = _sym(n, 70), _sym(n, 71)
    (h1, h2), _ = _stores([a1, a2], grid=4)
    op = chain_product(h1, d, oocore=True, ctx=g22)
    y = edge_projection(h1, 0, 4, ctx=g22)
    reads, sols = {}, {}
    for batch in (1, 4):
        reset_stream_stats()
        sols[batch] = estimate_solution(op, y, q, solver_batch=batch)
        reads[batch] = stream_stats().bytes_read
    op.release_scratch()
    assert reads[1] >= 2 * reads[4]
    assert torch.equal(sols[1], sols[4])  # replayed panels are bitwise
    cfg_oo = replace(CFG, oocore=True, solver_batch=4, prefetch_depth=4)
    res_r = detect_anomalies(_t(a1), _t(a2), CFG, top_k=5, ctx=g22)
    res_o = detect_anomalies(h1, h2, cfg_oo, top_k=5, ctx=g22)
    _close(res_o.scores, res_r.scores, 1e-4, 1e-3)


# ---------------------------------------------------------------------------
# solvers on a grid (tests/test_solver.py, tests/test_stream_gemm.py)
# ---------------------------------------------------------------------------


def _clustered(ctx1, n=64, seed=0) -> np.ndarray:
    return np.array(j_gmm_graph(ctx1, n=n, seed=seed).a1)


def _rhs(n, k=4, seed=0) -> np.ndarray:
    b = np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)
    return b - b.mean(0, keepdims=True)


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_methods_allclose_to_fixed_q_baseline_oocore(ctx1, g22, kernel):
    n, d, tol = 64, 5, 3e-5
    a = _clustered(ctx1, n)
    h = TileStore.create(None, n=n, grid=8).put_snapshot("a", a)
    op = chain_product(h, d, oocore=True, use_gemm_kernel=kernel, ctx=g22)
    b = torch.from_numpy(_rhs(n))
    sols, reports = {}, {}
    for method in ("richardson", "chebyshev", "cg"):
        sols[method], reports[method] = solve(op, b, SolverSpec(method=method, tolerance=tol))
        assert reports[method].converged and reports[method].streamed, reports[method]
    ref = estimate_solution(op, b, reports["richardson"].iterations + 1)
    for method, x in sols.items():
        _close(x, ref, 1e-4, 1e-3)
    op.release_scratch()


def test_residual_norm_streamed_matches_resident(ctx1, g22):
    n = 64
    a = g22.put_matrix(_clustered(ctx1, n))
    deg = lap.degrees(a)
    l_mat = lap.laplacian(a, deg)
    l_handle = TileStore.create(None, n=n, grid=8).put_snapshot("L", l_mat.numpy())
    op = chain_product(a, 6, schedule="xla")
    b = torch.from_numpy(_rhs(n))
    x = estimate_solution(op, b, 8)
    r_res = float(residual_norm(l_mat, x, b))
    r_str = float(residual_norm(l_handle, x, b, prefetch_depth=2, ctx=g22))
    assert r_str == pytest.approx(r_res, rel=1e-5)
    assert r_res < 0.5


@pytest.mark.parametrize("codec", ["raw", "bf16"])
@pytest.mark.parametrize("method", ["richardson", "cg"])
@pytest.mark.parametrize("grid", ["22", "21"])
def test_kernel_path_streamed_solve_matches_jax_xla(request, ctx1, grid, method, codec):
    """The streamed solve through stream_gemm per tile (2x2: C partials summed
    on the home device, plain epilogue) or fused_panel_matvec per row tile
    (2x1), against the JAX XLA streamed path on the same mesh shape."""
    g = request.getfixturevalue(f"g{grid}")
    jctx = request.getfixturevalue(f"ctx{grid}")
    n = 64
    a = _sym(n, 0)
    (h,), (jh,) = _stores([a], grid=4, codec=codec)
    op = chain_product(h, 3, oocore=True, tile_codec=codec, use_gemm_kernel=True, ctx=g)
    jop = j_chain(jctx, jh, 3, oocore=True, tile_codec=codec)
    b = np.random.default_rng(100).normal(size=(n, 4)).astype(np.float32)
    y, rep = solve(op, torch.from_numpy(b), SolverSpec(method=method), fixed_q=5)
    jy, jrep = j_solve(jctx, jop, jctx.put_rowblock(b), JSpec(method=method), fixed_q=5)
    _close(y.numpy(), jy, 1e-4, 1e-4)
    assert rep.iterations == jrep.iterations == 4 and rep.streamed
    op.release_scratch()


def test_kernel_path_launches_per_tile(g22, g21, monkeypatch):
    """The SUMMA K step is R*C stream_gemm calls of (ph/R x ph) @ (ph x n/C);
    a C = 1 solve iteration is one fused_panel_matvec per row tile."""
    from repro_torch.kernels import stream_gemm as sg

    calls = {"gemm": [], "fused": []}
    gemm, fused = sg.stream_gemm, sg.fused_panel_matvec
    monkeypatch.setattr(sg, "stream_gemm", lambda a, b, *r, **k: (
        calls["gemm"].append((tuple(a.shape), tuple(b.shape))), gemm(a, b, *r, **k))[1])
    monkeypatch.setattr(sg, "fused_panel_matvec", lambda p, *r: (
        calls["fused"].append(tuple(p.shape)), fused(p, *r))[1])
    n = 64
    (h,), _ = _stores([_sym(n, 9)], grid=2)  # 32-row store panels; the scratch grid is 2
    op = chain_product(h, 2, oocore=True, use_gemm_kernel=True, ctx=g22)
    g = n // 32
    assert calls["gemm"] == [((16, 32), (32, 32))] * (3 * g * g * 4)  # 3 GEMMs at d=2
    calls["gemm"].clear()
    op21 = chain_product(h, 2, oocore=True, use_gemm_kernel=True, ctx=g21)
    calls["gemm"].clear()
    solve(op21, torch.from_numpy(_rhs(n, 3)), SolverSpec(), fixed_q=3)
    assert calls["fused"] == [(16, n)] * (2 * g * 2)  # 2 steps x g panels x 2 row tiles
    assert calls["gemm"] == [((16, n), (n, 3))] * (g * 2)  # the chi build
    for o in (op, op21):
        o.release_scratch()


# ---------------------------------------------------------------------------
# the delta chain on a grid (tests/test_delta_chain.py)
# ---------------------------------------------------------------------------

_DRIFT_KW = dict(seed=5, noise=0.02, inject_steps=set(), drift_nodes=3)
_INC_BASE = dict(eps_rp=1e-2, d=3, q=8, k_override=4, solver="cg", solver_tol=1e-5,
                 warm_start=True)
_INC = dict(incremental_chain=True, delta_rank=6, delta_budget=0.1)


@pytest.mark.parametrize("storage", ["resident", "oocore"])
def test_incremental_scores_allclose_full_rebuild(ctx1, ctx22, g22, storage):
    """On the 2x2 grid, resident and out of core: incremental scores within
    rtol 1e-3, atol 1e-3 of V_G E|z|^2 of the full rebuild's, every push
    after the first a delta; and of the JAX ctx22 incremental run's."""
    n, t_steps = 48, 3
    snaps = [np.array(a) for a in j_gmm_snapshots(ctx1, n, t_steps, **_DRIFT_KW).snapshots()]
    oo = storage == "oocore"
    th, jh = _stores(snaps, grid=4)
    t_in = th if oo else [_t(s) for s in snaps]
    full_cfg = CommuteConfig(**_INC_BASE, oocore=oo)
    full = detect_sequence_anomalies(t_in, full_cfg, top_k=5, ctx=g22)
    inc = detect_sequence_anomalies(t_in, replace(full_cfg, **_INC), top_k=5, ctx=g22)
    emb = commute_time_embedding(_t(snaps[0]), replace(full_cfg, oocore=False), ctx=g22)
    z = emb.z.numpy().astype(np.float64)
    scale = float(emb.vol) * float((z * z).sum(1).mean())
    jinc = j_detect_seq(ctx22, jh if oo else [ctx22.put_matrix(s) for s in snaps],
                        JConfig(**_INC_BASE, schedule="xla", oocore=oo, **_INC), top_k=5)
    for t, (f, i, j) in enumerate(zip(full.transitions, inc.transitions, jinc.transitions,
                                      strict=True)):
        _close(i.scores, f.scores, 1e-3, 1e-3 * scale)
        _close(i.scores, j.scores, 1e-3, 1e-3 * scale)
    assert inc.warmup_metrics.get("chain.full_rebuilds") == 1
    assert sum(m.get("chain.incremental_updates", 0) for m in inc.transition_metrics) == t_steps - 1


# ---------------------------------------------------------------------------
# stores written and published from a grid; queries on them (tests/test_query.py)
# ---------------------------------------------------------------------------


def test_store_snapshot_sequence_of_a_grid_sequence(g22):
    seq = gmm_snapshot_sequence(32, 2, seed=0, inject_p=0.02, ctx=g22, **CPU)
    store = TileStore.create(None, n=32, grid=4)
    ids = store_snapshot_sequence(store, seq)
    for sid, a in zip(ids, seq.snapshots()):
        np.testing.assert_array_equal(store.snapshot(sid).to_numpy(), a.numpy())


QCFG = CommuteConfig(eps_rp=1e-3, d=8, q=12, schedule="xla", k_override=64)


@pytest.fixture(scope="module")
def grid_artifact(ctx1):
    """tests/test_query.py's n=128 embedding, computed on the port's 2x2 grid
    and published from its home device; and the adjacency."""
    g = make_context(["cpu"] * 4, 2)
    a = np.array(j_gmm_graph(ctx1, 128, seed=0, inject_p=0.02).a1)
    emb = commute_time_embedding(_t(a), QCFG, ctx=g)
    store = EmbeddingStore.create(None, n=128, k=64, seed=QCFG.seed)
    store.put_embedding("t0000", emb.z, float(emb.vol), emb.op.deg)
    return store, emb, a


def test_grid_embedding_matches_jax_ctx22(ctx22, grid_artifact):
    _, emb, a = grid_artifact
    j = j_embedding(ctx22, ctx22.put_matrix(a), JConfig(eps_rp=1e-3, d=8, q=12, schedule="xla",
                                                        k_override=64))
    z, jz = emb.z.numpy(), np.asarray(j.z)
    _close(z, jz, 1e-3, 1e-3 * np.abs(jz).max())


def test_store_commute_block_matches_resident(grid_artifact):
    store, emb, _ = grid_artifact
    rows, cols = np.arange(0, 128, 7), np.arange(3, 128, 11)
    resident = commute_distance_block(emb, rows, cols).numpy()
    _close(commute_block(store, rows, cols), resident, 1e-4, 1e-3)


def test_store_block_approximates_exact(grid_artifact):
    store, _, a = grid_artifact
    exact = exact_commute_distances(a)
    idx = np.arange(128)
    approx = commute_block(store, idx, idx)
    mask = ~np.eye(128, dtype=bool)
    rel = np.abs(approx - exact)[mask] / np.maximum(exact[mask], 1e-9)
    assert np.median(rel) < 0.25, f"median rel err {np.median(rel)}"


@pytest.mark.parametrize("corrected", [False, True], ids=["raw", "corrected"])
def test_top_anomalies_matches_bruteforce(grid_artifact, corrected):
    store, _, _ = grid_artifact
    h = store.latest()
    res = top_anomalies_from_store(store, 12, corrected=corrected, **CPU)
    z = h.to_numpy().astype(np.float64)
    dist2 = ((z - z.mean(0)) ** 2).sum(1)
    brute = dist2 - h.inv_deg().mean() - h.inv_deg() if corrected else h.vol * dist2
    order = np.argsort(-brute)[:12]
    _close(res.val, brute[order], 1e-4, 1e-4)
    assert set(res.idx.tolist()) == set(order.tolist())
    assert res.panels == 128 // h.panel_rows and res.emb_id == "t0000"


def test_nearest_neighbors_matches_bruteforce(grid_artifact):
    store, _, _ = grid_artifact
    h = store.latest()
    node = 41
    res = nearest_neighbors(store, node, 8, **CPU)
    z = h.to_numpy().astype(np.float64)
    d = h.vol * ((z - z[node]) ** 2).sum(1)
    d[node] = np.inf
    order = np.argsort(d)[:8]
    _close(res.val, d[order], 1e-4, 1e-3)
    assert set(res.idx.tolist()) == set(order.tolist()) and node not in res.idx


@pytest.mark.parametrize("oocore", [False, True], ids=["resident", "oocore"])
def test_detector_publishes_from_a_grid(g22, oocore):
    """SequenceDetector(ctx=) with an emb_store: each snapshot's Z goes from
    the home device to the store; queries equal the one-device run's ids."""
    cfg = CommuteConfig(eps_rp=1e-2, d=3, q=3, k_override=6, oocore=oocore)
    stores = {}
    for name, ctx in (("grid", g22), ("one", None)):
        stores[name] = EmbeddingStore.create(None, n=64, k=6, seed=cfg.seed)
        seq = gmm_snapshot_sequence(64, 3, seed=0, inject_p=0.02, **CPU)
        snaps = seq.snapshots()
        if oocore:
            ts = TileStore.create(None, n=64, grid=4)
            snaps = [ts.put_snapshot(f"t{i}", a.numpy()) for i, a in enumerate(snaps)]
        SequenceDetector(cfg, emb_store=stores[name], ctx=ctx, **CPU).run(snaps)
    assert stores["grid"].embedding_ids == stores["one"].embedding_ids == ["t0000", "t0001",
                                                                            "t0002"]
    for eid in ("t0000", "t0002"):
        res = {k: top_anomalies_from_store(s, 5, emb_id=eid, **CPU) for k, s in stores.items()}
        np.testing.assert_array_equal(res["grid"].idx, res["one"].idx)
        _close(res["grid"].val, res["one"].val, 1e-3, 0)
