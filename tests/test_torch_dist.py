"""The port's device grid against the JAX package's 2x2 mesh, on the CPU.

The port's 2x2 grid puts all four tiles on the one CPU device
(``make_context(["cpu"] * 4, 2)``); the JAX side is ``tests/conftest.py``'s
``ctx22`` (four fake CPU devices) and ``ctx1``.  The same numpy inputs, made
from a seed, go to both.  Tolerances are the JAX tests' own:

* GEMM schedules: rtol 1e-5, atol 1e-4 (``test_matmul_schedules_agree``);
* tile_map, builders, degrees: rtol 1e-5, atol 1e-5 or 1e-4 (``tests/test_tiles.py``);
* edge projection: 1e-5 across grids, and the plain version bitwise against
  the hashed field;
* chain operator: ``tests/test_torch_chain_solver.py``'s rtol 1e-4 with an
  absolute floor of 1e-4 x the largest entry;
* scores: rtol 1e-3, atol 1e-2 (``test_cad_sharded_matches_single``,
  ``test_sequence_sharded_matches_single``).
"""

import math
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CommuteConfig as JConfig
from repro.core import chain_product as j_chain_product
from repro.core import detect_anomalies as j_detect
from repro.core import detect_sequence_anomalies as j_detect_seq
from repro.core import laplacian as j_lap
from repro.core.distmatrix import build_from_nodes as j_build
from repro.core.distmatrix import matmul as j_matmul
from repro.core.embedding import edge_projection as j_edge_projection
from repro.core.tiles import tile_map as j_tile_map
from repro.graphs import gmm_graph_sequence as j_gmm_graph
from repro.graphs import gmm_snapshot_sequence as j_gmm_snapshots
from repro_torch.core import (
    SCHEDULES,
    CommuteConfig,
    DistMatrix,
    SequenceDetector,
    Tile,
    add_scaled_identity,
    blockwise_unary,
    build_from_nodes,
    chain_product,
    clear_program_cache,
    detect_anomalies,
    detect_sequence_anomalies,
    edge_projection,
    make_context,
    matmul,
    matmul_rowblock,
    program_cache_stats,
    tile_map,
    trivial_context,
)
from repro_torch.core import laplacian as lap
from repro_torch.core import rng as crng
from repro_torch.core.tiles import REPLICATED, _to
from repro_torch.graphs import gmm_graph_sequence, gmm_snapshot_sequence
from repro_torch.kernels import ref
from repro_torch.launch import caddelag_run
from repro_torch.launch.mesh import make_device_grid, mesh_chip_count
from repro_torch.store import EmbeddingStore, TileStore

CPU4 = ["cpu"] * 4


@pytest.fixture(scope="module")
def g22():
    return make_context(CPU4, 2)


@pytest.fixture(scope="module")
def g1():
    return trivial_context("cpu")


@pytest.fixture(params=["g1", "g22"])
def grid(request):
    return request.getfixturevalue(request.param)


def _dense(x) -> np.ndarray:
    return x.numpy() if isinstance(x, DistMatrix) else np.asarray(x)


def _sym(n: int, seed: int) -> np.ndarray:
    a = np.abs(np.random.default_rng(seed).normal(size=(n, n))).astype(np.float32)
    a = (a + a.T) / 2.0
    np.fill_diagonal(a, 0.0)
    return a


def _close(got, want, rtol, scale_tol):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=scale_tol * np.abs(want).max())


# ---------------------------------------------------------------------------
# the context and the GEMM schedules
# ---------------------------------------------------------------------------


def test_context_shape_and_round_trip(g22):
    assert (g22.n_row_shards, g22.n_col_shards, g22.home) == (2, 2, torch.device("cpu"))
    assert hash(g22) == hash(make_context(CPU4, 2)) and g22 == make_context(CPU4, 2)
    a = np.arange(64, dtype=np.float32).reshape(8, 8)
    x = g22.put_matrix(a)
    assert isinstance(x, DistMatrix) and x.block_shape == (4, 4) and tuple(x.shape) == (8, 8)
    np.testing.assert_array_equal(g22.to_numpy(x), a)
    np.testing.assert_array_equal(x.tiles[1][0].numpy(), a[4:, :4])
    t = trivial_context("cpu").put_matrix(a)  # a 1x1 grid's matrix is a tensor
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), a)
    with pytest.raises(ValueError, match="divide"):
        g22.put_matrix(np.zeros((7, 8), np.float32))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_matmul_schedules_agree(ctx22, g22, schedule):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, 64)).astype(np.float32)
    b = rng.normal(size=(64, 64)).astype(np.float32)
    want = np.asarray(j_matmul(ctx22, ctx22.put_matrix(a), ctx22.put_matrix(b), schedule=schedule))
    got = matmul(g22.put_matrix(a), g22.put_matrix(b), schedule=schedule)
    assert isinstance(got, DistMatrix)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-5, atol=1e-4)


def test_cannon_requires_square_grid():
    ctx14 = make_context(CPU4, 1)
    a = ctx14.put_matrix(np.eye(64, dtype=np.float32))
    with pytest.raises(ValueError, match="square"):
        matmul(a, a, schedule="cannon")


@pytest.mark.parametrize("rows", [1, 2])
def test_summa_and_rowblock_on_a_two_tile_grid(rows):
    ctx = make_context(["cpu"] * 2, rows)
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(32, 32)).astype(np.float32) for _ in range(2))
    x = rng.normal(size=(32, 3)).astype(np.float32)
    np.testing.assert_allclose(matmul(ctx.put_matrix(a), ctx.put_matrix(b),
                                      schedule="summa").numpy(), a @ b, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(matmul_rowblock(ctx.put_matrix(a), torch.from_numpy(x)).numpy(),
                               a @ x, rtol=1e-5, atol=1e-4)


def test_tensors_with_a_grid_context_are_cut_into_tiles(g22):
    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(rng.normal(size=(16, 16)).astype(np.float32)) for _ in range(2))
    got = matmul(a, b, schedule="cannon", ctx=g22)
    assert isinstance(got, DistMatrix)
    np.testing.assert_allclose(got.numpy(), (a @ b).numpy(), rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# tile_map and the blockwise builders (tests/test_tiles.py)
# ---------------------------------------------------------------------------


def test_tile_map_identity_grid(grid):
    out = tile_map(grid, lambda tile: tile.diag_mask().to(torch.float32), grid=(32, 32),
                   in_specs=())
    np.testing.assert_array_equal(_dense(out), np.eye(32, dtype=np.float32))


def test_tile_map_row_reduce(ctx22, grid):
    x = np.random.default_rng(0).normal(size=(32, 32)).astype(np.float32)
    out = tile_map(grid, lambda tile, blk: blk.sum(dim=1), grid.put_matrix(x), reduce="cols")
    want = np.asarray(j_tile_map(ctx22, lambda tile, blk: blk.sum(axis=1), ctx22.put_matrix(x),
                                 reduce="cols"))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), x.sum(1), rtol=1e-5, atol=1e-5)


def test_tile_map_rejects_nondivisible(g22):
    with pytest.raises(ValueError, match="divide"):
        tile_map(g22, lambda tile: torch.zeros(tile.block_shape), grid=(31, 31), in_specs=())


def test_tile_map_requires_grid_without_matrix_operand(g1):
    with pytest.raises(ValueError, match="grid"):
        tile_map(g1, lambda tile, f: f, torch.zeros(8, 2), in_specs=(REPLICATED,))


def test_tile_fields(g22):
    seen = {}

    def body(tile, blk):
        seen[(tile.row_index, tile.col_index)] = tile
        return blk

    tile_map(g22, body, g22.put_matrix(np.zeros((8, 6), np.float32)))
    t = seen[(1, 0)]
    assert isinstance(t, Tile) and t.block_shape == (4, 3) and t.mesh_axes == ("data", "model")
    assert t.rows.tolist() == [4, 5, 6, 7] and t.cols.tolist() == [0, 1, 2]
    assert (t.row0, t.col0) == (4, 0)
    assert not t.diag_mask().any() and seen[(0, 0)].diag_mask().sum() == 3


def test_single_part_reduce_is_returned_without_a_copy(g1):
    """On a 1x1 grid a reduce has one part: the body's own output comes back."""
    x = torch.arange(12.0).reshape(3, 4)
    for reduce in ("cols", "rows"):
        assert tile_map(g1, lambda tile, blk: blk, x, reduce=reduce) is x


def test_plan_cache_is_keyed_on_geometry(g22):
    """Bodies share a geometry's plan: a fresh closure on a known geometry
    hits, a new geometry misses once."""
    clear_program_cache()
    st = program_cache_stats()
    x = g22.put_matrix(np.ones((8, 8), np.float32))
    h0, m0, t0 = st.hits, st.misses, st.traces
    for scale in (1.0, 2.0):
        blockwise_unary(lambda blk, r, c, s=scale: blk * s, x)
    assert (st.misses - m0, st.traces - t0, st.hits - h0) == (1, 1, 1)
    tile_map(g22, lambda tile: torch.zeros(tile.block_shape), grid=(16, 16), in_specs=())
    assert (st.misses - m0, st.traces - t0) == (2, 2)


class _SpyTo(torch.Tensor):
    """Records each ``Tensor.to`` call's destination and ``non_blocking``; copies nothing."""

    seen: list = []

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.Tensor.to:
            cls.seen.append((args[1], (kwargs or {}).get("non_blocking")))
            return args[0]
        return super().__torch_function__(func, types, args, kwargs)


@pytest.mark.parametrize("src,dst,non_blocking", [("meta", "cpu", False),
                                                   ("cpu", "cuda:0", True)])
def test_copies_to_the_host_wait_for_their_data(src, dst, non_blocking):
    """A grid may mix device types: a copy to the host is synchronous, so host
    code after it (a cat, a sum) reads landed data; a copy to a card stays
    asynchronous, ordered on the card's stream."""
    x = torch.zeros(3, device=src).as_subclass(_SpyTo)
    _SpyTo.seen.clear()
    _to(x, torch.device(dst))
    assert _SpyTo.seen == [(torch.device(dst), non_blocking)]


def test_build_from_nodes_matches_dense(ctx22, grid):
    feats = np.random.default_rng(1).normal(size=(32, 3)).astype(np.float32)
    want = np.asarray(j_build(ctx22, jnp.asarray(feats),
                              lambda xi, xj: jnp.sum(xi[:, None, :] * xj[None, :, :], -1)))
    out = _dense(build_from_nodes(torch.from_numpy(feats),
                                  lambda xi, xj: torch.sum(xi[:, None, :] * xj[None, :, :], -1),
                                  ctx=grid))
    dense = feats @ feats.T
    np.fill_diagonal(dense, 0.0)
    np.testing.assert_allclose(out, dense, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


def test_blockwise_unary_global_ids(grid):
    """fn sees global row/col ids whatever the grid, and on a streamed handle."""
    x = grid.put_matrix(np.zeros((16, 16), np.float32))
    fn = lambda blk, r, c: blk + r[:, None] * 100.0 + c[None, :]  # noqa: E731
    r, c = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    np.testing.assert_allclose(_dense(blockwise_unary(fn, x)), r * 100.0 + c)
    store = TileStore.create(None, n=16, grid=4)
    h = store.put_snapshot("t0", np.zeros((16, 16), np.float32))
    np.testing.assert_allclose(blockwise_unary(fn, h, device="cpu").numpy(), r * 100.0 + c)


def test_add_scaled_identity(grid):
    out = _dense(add_scaled_identity(grid.put_matrix(np.ones((16, 16), np.float32)), 2.5))
    np.testing.assert_allclose(out, np.ones((16, 16)) + 2.5 * np.eye(16))


@pytest.mark.parametrize("shape", [(16, 16), (16, 8)])
def test_add_scaled_identity_on_rectangular_tiles(shape):
    ctx = make_context(["cpu"] * 2, 1)  # 1x2: tiles of 16 x 8 (or 16 x 4)
    out = add_scaled_identity(ctx.put_matrix(np.zeros(shape, np.float32)), 1.0).numpy()
    np.testing.assert_array_equal(out, np.eye(*shape, dtype=np.float32))


def test_degrees_laplacian_and_normalized_adjacency(ctx22, g22):
    a = np.abs(np.random.default_rng(2).normal(size=(32, 32))).astype(np.float32)
    want = np.asarray(j_lap.degrees(ctx22, ctx22.put_matrix(a)))
    deg = lap.degrees(g22.put_matrix(a))
    np.testing.assert_allclose(deg.numpy(), a.sum(1), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(deg.numpy(), want, rtol=1e-5, atol=1e-4)
    jdeg = jnp.asarray(want)
    for deflate in (True, False):
        jm = j_lap.normalized_adjacency(ctx22, ctx22.put_matrix(a), jdeg, deflate=deflate)
        got = lap.normalized_adjacency(g22.put_matrix(a), deg, deflate=deflate)
        np.testing.assert_allclose(got.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    got = lap.laplacian(g22.put_matrix(a), deg)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_lap.laplacian(ctx22, ctx22.put_matrix(a),
                                                                       jdeg)), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# edge projection: per tile at its global (row0, col0)
# ---------------------------------------------------------------------------


def test_edge_projection_grid_matches_jax_and_one_tile(ctx22, g22):
    a = _sym(32, 3)
    want = np.asarray(j_edge_projection(ctx22, ctx22.put_matrix(a), seed=7, k=4))
    one = edge_projection(torch.from_numpy(a), 7, 4).numpy()
    got = edge_projection(g22.put_matrix(a), 7, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), one, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("row0,col0", [(0, 0), (0, 24), (24, 0), (8, 40)])
def test_ref_edge_projection_col0_is_the_hashed_field(row0, col0):
    """The plain version at (row0, col0) is bitwise sqrt(A) . Q summed over the
    field of global ids, and column blocks add up to the whole row."""
    seed, k, m, n = 5, 6, 16, 24
    a = torch.from_numpy(np.abs(np.random.default_rng(4).normal(size=(m, n))).astype(np.float32))
    q = crng.edge_rademacher(seed, torch.arange(row0, row0 + m)[:, None, None],
                             torch.arange(col0, col0 + n)[None, :, None],
                             torch.arange(k)[None, None, :])
    want = torch.sum(torch.sqrt(torch.clamp(a, min=0.0))[:, :, None] * q, dim=1) * (1.0 / math.sqrt(k))
    got = ref.edge_projection(a, seed=seed, k=k, row0=row0, col0=col0)
    assert torch.equal(got, want)
    halves = (ref.edge_projection(a[:, :12].contiguous(), seed=seed, k=k, row0=row0, col0=col0)
              + ref.edge_projection(a[:, 12:].contiguous(), seed=seed, k=k, row0=row0,
                                    col0=col0 + 12))
    torch.testing.assert_close(halves, got, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the chain, CAD scores and the sequence on the grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["summa", "cannon"])
def test_chain_product_grid_matches_jax(ctx22, g22, schedule):
    a = np.array(j_gmm_graph(ctx22, n=64, seed=64).a1)
    jop = j_chain_product(ctx22, ctx22.put_matrix(a), 6, schedule=schedule)
    op = chain_product(g22.put_matrix(a), 6, schedule=schedule)
    assert isinstance(op.p1, DistMatrix) and isinstance(op.p2, DistMatrix)
    _close(op.p1.numpy(), jop.p1, 1e-4, 1e-4)
    _close(op.p2.numpy(), jop.p2, 1e-4, 1e-4)
    _close(op.deg.numpy(), jop.deg, 1e-4, 0)
    _close(float(op.vol), float(jop.vol), 1e-4, 0)
    assert op.rho == pytest.approx(jop.rho, rel=1e-4, abs=1e-6)


CFG_CAD = CommuteConfig(eps_rp=1e-2, d=6, q=8, schedule="summa")


def test_detect_anomalies_grid_matches_one_device(g22, g1):
    seq1 = gmm_graph_sequence(64, seed=3, inject_p=0.02, device="cpu")
    seq2 = gmm_graph_sequence(64, seed=3, inject_p=0.02, ctx=g22)
    assert isinstance(seq2.a1, DistMatrix)
    np.testing.assert_allclose(seq2.a2.numpy(), seq1.a2.numpy(), rtol=1e-6, atol=1e-7)
    r1 = detect_anomalies(seq1.a1, seq1.a2, CFG_CAD, top_k=5, device="cpu")
    r2 = detect_anomalies(seq2.a1, seq2.a2, CFG_CAD, top_k=5)
    assert r2.scores.device == torch.device("cpu") and tuple(r2.scores.shape) == (64,)
    np.testing.assert_allclose(r2.scores.numpy(), r1.scores.numpy(), rtol=1e-3, atol=1e-2)


@pytest.mark.slow
def test_detect_anomalies_grid_matches_jax(ctx22, g22):
    jseq = j_gmm_graph(ctx22, n=64, seed=3, inject_p=0.02)
    jcfg = JConfig(eps_rp=1e-2, d=6, q=8, schedule="summa")
    want = np.asarray(j_detect(ctx22, jseq.a1, jseq.a2, jcfg, top_k=5).scores)
    seq = gmm_graph_sequence(64, seed=3, inject_p=0.02, ctx=g22)
    got = detect_anomalies(seq.a1, seq.a2, CFG_CAD, top_k=5)
    np.testing.assert_allclose(got.scores.numpy(), want, rtol=1e-3, atol=1e-2)


CFG_SEQ = CommuteConfig(eps_rp=1e-2, d=6, q=8, schedule="xla")


@pytest.mark.parametrize("schedule", ["xla", "cannon"])
def test_sequence_grid_matches_jax_and_one_device(ctx22, g22, schedule):
    jcfg = JConfig(eps_rp=1e-2, d=6, q=8, schedule=schedule)
    cfg = CommuteConfig(eps_rp=1e-2, d=6, q=8, schedule=schedule)
    jres = j_detect_seq(ctx22, j_gmm_snapshots(ctx22, 64, 3, seed=3).snapshots(), jcfg, top_k=5)
    one = detect_sequence_anomalies(gmm_snapshot_sequence(64, 3, seed=3, device="cpu").snapshots(),
                                    cfg, top_k=5, device="cpu")
    res = detect_sequence_anomalies(gmm_snapshot_sequence(64, 3, seed=3, ctx=g22).snapshots(),
                                    cfg, top_k=5, ctx=g22)
    assert res.n_snapshots == 3 and len(res.transitions) == 2
    for got, want, ref1 in zip(res.transitions, jres.transitions, one.transitions):
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-3,
                                   atol=1e-2)
        np.testing.assert_allclose(got.scores.numpy(), ref1.scores.numpy(), rtol=1e-3, atol=1e-2)


def test_sequence_plan_cache_steady_state(g22):
    """The first two snapshots build the grid's plans (one a geometry);
    snapshots 3 and 4 reuse every plan: hits, no misses, no builds."""
    cfg = CommuteConfig(eps_rp=1e-2, d=3, q=3, schedule="cannon", k_override=4)
    det = SequenceDetector(cfg, top_k=5, ctx=g22)
    st = program_cache_stats()
    for t in range(2):
        det.push(g22.put_matrix(_sym(32, 10 + t)))
    for t in range(2, 4):
        h0, m0, t0 = st.hits, st.misses, st.traces
        det.push(g22.put_matrix(_sym(32, 10 + t)))
        assert st.misses == m0 and st.traces == t0, f"snapshot {t} built a plan"
        assert st.hits > h0
    assert len(det.finalize().transitions) == 3


def test_sequence_donate_frees_every_tile(g22):
    det = SequenceDetector(CFG_SEQ, top_k=5, donate=True, ctx=g22)
    snaps = [g22.put_matrix(_sym(32, t)) for t in range(2)]
    det.push(snaps[0])
    det.push(snaps[1])
    assert all(t.untyped_storage().nbytes() == 0 for row in snaps[0].tiles for t in row)
    assert all(t.untyped_storage().nbytes() > 0 for row in snaps[1].tiles for t in row)


# ---------------------------------------------------------------------------
# the trivial context is today's path, bitwise
# ---------------------------------------------------------------------------


def test_trivial_context_is_bitwise_the_plain_call(g1):
    a = torch.from_numpy(_sym(32, 7))
    op0 = chain_product(a, 4, schedule="cannon")
    op1 = chain_product(a, 4, schedule="cannon", ctx=g1)
    for x, y in ((op0.p1, op1.p1), (op0.p2, op1.p2), (op0.deg, op1.deg)):
        assert isinstance(y, torch.Tensor) and torch.equal(x, y)
    assert op0.rho == op1.rho
    b = torch.from_numpy(_sym(32, 8))
    assert torch.equal(matmul(a, b, schedule="summa"), matmul(a, b, schedule="summa", ctx=g1))
    cfg = CommuteConfig(eps_rp=1e-2, d=3, q=3, k_override=4)
    r0 = detect_anomalies(a, b, cfg, device="cpu")
    r1 = detect_anomalies(a, b, cfg, device="cpu", ctx=g1)
    assert torch.equal(r0.scores, r1.scores)
    s0 = detect_sequence_anomalies([a, b], cfg, device="cpu")
    s1 = detect_sequence_anomalies([a, b], cfg, device="cpu", ctx=g1)
    assert torch.equal(s0.transitions[0].scores, s1.transitions[0].scores)
    assert torch.equal(build_from_nodes(a[:, :3].contiguous(), torch.cdist, ctx=g1),
                       build_from_nodes(a[:, :3].contiguous(), torch.cdist))


# ---------------------------------------------------------------------------
# the CLI, and the store, out-of-core, incremental and embedding-store paths
# (refused on a grid until ROADMAP item 9b, now run on it)
# ---------------------------------------------------------------------------


def _cli_topk(capsys, *extra) -> list:
    caddelag_run.main(["--device", "cpu", "--n", "64", "--t-steps", "3", "--d", "3", "--q", "4",
                       *extra])
    line = [ln for ln in capsys.readouterr().out.splitlines() if "sequence-wide top-" in ln]
    return line[0].split(":", 1)[1].strip()


@pytest.mark.parametrize("schedule", ["summa", "cannon"])
def test_cli_grid_topk_equals_one_device(capsys, schedule):
    one = _cli_topk(capsys, "--data", "1", "--model", "1")
    grid = _cli_topk(capsys, "--data", "2", "--model", "2", "--schedule", schedule)
    assert grid == one


def test_make_device_grid_on_cpu():
    ctx = make_device_grid(2, 3, "cpu")
    assert (ctx.n_row_shards, ctx.n_col_shards, mesh_chip_count(ctx)) == (2, 3, 6)
    assert {d for row in ctx.devices for d in row} == {torch.device("cpu")}
    with pytest.raises(ValueError, match="data, model >= 1"):
        make_device_grid(0, 2, "cpu")


@pytest.mark.parametrize("flag", [["--store", "unused"], ["--oocore-chain"],
                                  ["--incremental-chain", "--drift-nodes", "3"],
                                  ["--emb-store", "unused"]],
                         ids=["store", "oocore-chain", "incremental-chain", "emb-store"])
def test_cli_single_device_paths_refuse_a_grid(tmp_path, capsys, flag):
    """Each path that once refused a grid (ROADMAP item 9b) now runs on a 2x2
    grid, and its sequence-wide top-k equals the 1x1 run's."""
    tops = []
    for grid in ("1", "2"):
        args = [str(tmp_path / f"{f}{grid}") if f == "unused" else f for f in flag]
        tops.append(_cli_topk(capsys, "--data", grid, "--model", grid, *args))
    assert tops[0] == tops[1]
    if flag[0] == "--emb-store":
        assert EmbeddingStore.open(tmp_path / "unused2").embedding_ids == ["t0000", "t0001",
                                                                           "t0002"]


def test_core_single_device_paths_refuse_a_grid(g22, g1):
    """The core paths that once refused a grid now run on it and match the
    1x1 grid: the out-of-core, fuse_l and level_sink chains, a handle's
    chain, and SequenceDetector with incremental_chain, emb_store and
    handles (chain: rtol 1e-4, floor 1e-4 x the largest entry; scores:
    rtol 1e-3, atol 1e-2, as above)."""
    a = _sym(32, 1)
    store = TileStore.create(None, n=32, grid=2)
    h = store.put_snapshot("t0", a)
    for kw in ({"oocore": True}, {"fuse_l": True}, {"level_sink": {}}, {"oocore": True,
                                                                        "level_sink": {}}):
        ops = [chain_product(src, 3, **kw, ctx=g) for g, src in ((g22, g22.put_matrix(a)),
                                                                 (g1, torch.from_numpy(a)))]
        for x, y in ((ops[0].p1, ops[1].p1), (ops[0].p2, ops[1].p2)):
            _close(*(m.to_numpy() if hasattr(m, "to_numpy") else _dense(m) for m in (x, y)),
                   1e-4, 1e-4)
        assert ops[0].ctx == g22 and ops[1].ctx is None
        for op in ops:
            op.release_scratch()
    _close(chain_product(h, 3, ctx=g22).p2.numpy(), chain_product(h, 3, ctx=g1).p2, 1e-4, 1e-4)
    snaps = [_sym(32, s) for s in (1, 2, 3)]
    hs = [store.put_snapshot(f"s{i}", x) for i, x in enumerate(snaps)]
    cfgs = (replace(CFG_SEQ, incremental_chain=True, delta_budget=10.0), CFG_SEQ)
    for cfg in cfgs:
        for src in (hs, [torch.from_numpy(x) for x in snaps]):
            runs = []
            for g in (g22, g1):
                emb = EmbeddingStore.create(None, n=32, k=cfg.k_rp(32), seed=cfg.seed)
                runs.append(SequenceDetector(cfg, ctx=g, emb_store=emb).run(src))
                assert emb.embedding_ids == ["t0000", "t0001", "t0002"]
            for x, y in zip(runs[0].transitions, runs[1].transitions, strict=True):
                np.testing.assert_allclose(x.scores.numpy(), y.scores.numpy(), rtol=1e-3,
                                           atol=1e-2)
