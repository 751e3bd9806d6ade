"""The port's query read path against the JAX package's.

Inputs are made once with numpy and handed to both packages; the JAX
``panel_topk_update`` runs in Pallas interpret mode, as tests/test_query.py
runs it.  Bars: identical ids; values bitwise where the arithmetic is exact
(quarter-grid data) and at rtol 1e-5 otherwise for one kernel call; the
JAX tests' own tolerances for whole queries.  Where the JAX kernel repeats
ids (topk > 2 x panel rows, see ROADMAP Queue 3) the port is held against a
float64 brute force instead.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import query as jq
from repro.kernels.emb_query import panel_topk_update as j_update
from repro.kernels.emb_query import topk_init as j_init
from repro.store.embstore import EmbeddingStore as JEmbStore
from repro.store.tilestore import _f32_to_bf16_u16
from repro_torch.core import CommuteConfig, SequenceDetector, query
from repro_torch.core.embedding import commute_time_embedding, exact_commute_distances
from repro_torch.core.tiles import reset_stream_stats, stream_stats
from repro_torch.graphs import gmm_snapshot_sequence
from repro_torch.kernels import emb_query as eq
from repro_torch.kernels import ref
from repro_torch.obs import REGISTRY
from repro_torch.store import EmbeddingStore

CPU = dict(device="cpu")


# ---------------------------------------------------------------------------
# one kernel call: the plain version against the JAX kernel
# ---------------------------------------------------------------------------


def _call_inputs(data: str, seed=0, q=2, k=8, ph=32):
    rng = np.random.default_rng(seed)
    if data == "exact":
        # quarter-grid values: every product and sum is exact in fp32 (and in
        # bf16), so duplicated rows tie exactly in both packages
        zq = rng.integers(-6, 7, size=(q, k)).astype(np.float32) / 4
        za = rng.integers(-6, 7, size=(ph, k)).astype(np.float32) / 4
        zb = rng.integers(-6, 7, size=(ph, k)).astype(np.float32) / 4
        zb[10] = zb[3]  # tie inside the panel
        zb[20] = za[7]  # tie between the running state and the panel
        zb[25] = zb[26] = zb[27] = zb[3]
        inv_a = rng.integers(1, 8, size=(1, ph)).astype(np.float32) / 8
        inv_b = rng.integers(1, 8, size=(1, ph)).astype(np.float32) / 8
        inv_b[0, [10, 20, 25, 26, 27]] = inv_b[0, 3]
        inv_b[0, 20] = inv_a[0, 7]
        inv_q = np.full((q, 1), 0.25, np.float32)
        vol = 3.0
    else:
        zq = rng.normal(size=(q, k)).astype(np.float32)
        za = rng.normal(size=(ph, k)).astype(np.float32)
        zb = rng.normal(size=(ph, k)).astype(np.float32)
        zb[10] = zb[3]
        inv_a = rng.uniform(0.1, 1.0, size=(1, ph)).astype(np.float32)
        inv_b = rng.uniform(0.1, 1.0, size=(1, ph)).astype(np.float32)
        inv_q = rng.uniform(0.1, 1.0, size=(q, 1)).astype(np.float32)
        vol = 37.25
    exclude = np.array([[ph + 5], [-1]], np.int32)[:q]  # a global id inside panel B
    return zq, za, zb, inv_a, inv_b, inv_q, vol, exclude


def _jax_call(state, zq, zp, inv_q, inv_p, vol, row0, ex, **kw):
    v, i = j_update(jnp.asarray(state[0]), jnp.asarray(state[1]), jnp.asarray(zq),
                    jnp.asarray(zp), jnp.asarray(inv_q), jnp.asarray(inv_p), vol, row0,
                    jnp.asarray(ex), interpret=True, **kw)
    return np.asarray(v), np.asarray(i)


def _torch_call(state, zq, zp, inv_q, inv_p, vol, row0, ex, **kw):
    zp = torch.from_numpy(zp.view(np.int16) if zp.dtype == np.uint16 else zp)
    v, i = eq.panel_topk_update(
        torch.from_numpy(np.array(state[0])), torch.from_numpy(np.array(state[1])),
        torch.from_numpy(zq), zp,
        torch.from_numpy(inv_q), torch.from_numpy(inv_p), vol, row0, torch.from_numpy(ex), **kw)
    return v.numpy(), i.numpy()


@pytest.mark.parametrize("data", ["exact", "random"])
@pytest.mark.parametrize("largest", [True, False], ids=["largest", "smallest"])
@pytest.mark.parametrize("corrected", [False, True], ids=["raw", "corrected"])
@pytest.mark.parametrize("enc", ["fp32", "bf16"])
def test_plain_panel_topk_update_matches_jax(enc, corrected, largest, data):
    zq, za, zb, inv_a, inv_b, inv_q, vol, ex = _call_inputs(data)
    if enc == "bf16":
        za, zb = _f32_to_bf16_u16(za), _f32_to_bf16_u16(zb)
    topk, ph = 10, zb.shape[0]
    kw = dict(topk=topk, corrected=corrected, largest=largest)
    init = tuple(np.asarray(x) for x in j_init(zq.shape[0], topk, largest=largest))
    # a seeded running state: panel A merged into the empty state by the JAX kernel
    state = _jax_call(init, zq, za, inv_q, inv_a, vol, 0, ex, **kw)
    assert (state[1] >= 0).all()
    t_state = _torch_call(init, zq, za, inv_q, inv_a, vol, 0, ex, **kw)
    np.testing.assert_array_equal(t_state[1], state[1])
    want = _jax_call(state, zq, zb, inv_q, inv_b, vol, ph, ex, **kw)
    got = _torch_call(state, zq, zb, inv_q, inv_b, vol, ph, ex, **kw)
    np.testing.assert_array_equal(got[1], want[1])
    if data == "exact":
        np.testing.assert_array_equal(got[0], want[0])
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=0)
    assert ph + 5 not in got[1][0]  # excluded in the kernel
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32


def test_exact_ties_go_to_the_lower_position():
    zq, za, zb, inv_a, inv_b, inv_q, vol, ex = _call_inputs("exact", q=1)
    zb[:] = zb[3]  # every panel row ties
    init = tuple(t.numpy() for t in eq.topk_init(1, 6, largest=True, device="cpu"))
    v, i = _torch_call(init, zq, zb, inv_q, inv_b[:, :1].repeat(32, 1), vol, 100,
                       np.array([[-1]], np.int32), topk=6, largest=True)
    assert i[0].tolist() == list(range(100, 106)) and len(set(v[0].tolist())) == 1


def test_wrapper_rejects_bad_inputs():
    v, i = eq.topk_init(1, 4, largest=True, device="cpu")
    zq, zp = torch.zeros((1, 8)), torch.zeros((16, 8))
    idq, idp, ex = torch.zeros((1, 1)), torch.zeros((1, 16)), torch.full((1, 1), -1, dtype=torch.int32)
    ok = (v, i, zq, zp, idq, idp, 1.0, 0, ex)
    eq.panel_topk_update(*ok, topk=4)
    bad = [
        ((v, i, zq, torch.zeros((16, 7)), idq, idp, 1.0, 0, ex), ValueError),
        ((v[:, :3], i, zq, zp, idq, idp, 1.0, 0, ex), ValueError),
        ((v, i, zq, zp, idq, idp[:, :8], 1.0, 0, ex), ValueError),
        ((v, i, zq, zp, idq, idp, 1.0, 0, ex[:, :0]), ValueError),
        ((v, i, zq, zp.double(), idq, idp, 1.0, 0, ex), TypeError),
        ((v, i.long(), zq, zp, idq, idp, 1.0, 0, ex), TypeError),
        ((v, i, zq, zp, idq, idp, 1.0, 0, ex.float()), TypeError),
        ((v, i, zq, zp.to("meta"), idq, idp, 1.0, 0, ex), ValueError),
    ]
    for args, err in bad:
        with pytest.raises(err):
            eq.panel_topk_update(*args, topk=4)


# ---------------------------------------------------------------------------
# the reference's duplicate fill (topk > 2 x panel rows): port = brute force
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_artifact(tmp_path_factory):
    """n=64, k=8 in 16-row panels, written by the JAX package."""
    rng = np.random.default_rng(7)
    z = rng.normal(size=(64, 8)).astype(np.float32)
    deg = rng.uniform(0.5, 2.0, size=64).astype(np.float32)
    root = tmp_path_factory.mktemp("small")
    JEmbStore.create(root, n=64, k=8, panel_rows=16).put_embedding("t0000", z, 12.5, deg)
    return root


def _brute_top(handle, topk):
    z = handle.to_numpy().astype(np.float64)
    score = handle.vol * ((z - handle.zbar.astype(np.float64)) ** 2).sum(1)
    order = np.argsort(-score, kind="stable")[:topk]
    return order, score[order]


@pytest.mark.parametrize("topk", [16, 32, 33, 40, 64])
def test_topk_beyond_two_panels_matches_bruteforce(small_artifact, topk):
    p = query.top_anomalies_from_store(EmbeddingStore.open(small_artifact), topk, **CPU)
    j = jq.top_anomalies_from_store(JEmbStore.open(small_artifact), topk, interpret=True)
    order, vals = _brute_top(EmbeddingStore.open(small_artifact).latest(), topk)
    assert p.idx.tolist() == order.tolist()
    np.testing.assert_allclose(p.val, vals, rtol=1e-5)
    if topk <= 32:
        np.testing.assert_array_equal(p.idx, j.idx)
        np.testing.assert_allclose(p.val, j.val, rtol=1e-5)
    else:  # the reference repeats ids once its finite candidates run out
        assert len(set(j.idx.tolist())) == 32 < topk
        assert set(j.idx.tolist()) != set(order.tolist())


def test_topk_larger_than_n_is_clamped(small_artifact):
    res = query.top_anomalies_from_store(EmbeddingStore.open(small_artifact), 500, **CPU)
    assert len(res.idx) == 64 and sorted(res.idx.tolist()) == list(range(64))


def test_empty_slots_stay_minus_one():
    z = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    state = tuple(t.numpy() for t in eq.topk_init(1, 12, largest=False, device="cpu"))
    v, i = _torch_call(state, z[:1], z, np.zeros((1, 1), np.float32), np.zeros((1, 8), np.float32),
                       1.0, 0, np.array([[0]], np.int32), topk=12, largest=False)
    assert sorted(i[0, :7].tolist()) == list(range(1, 8))
    # the empty state slots tie with the excluded node at +inf and come first
    assert i[0, 7:].tolist() == [-1] * 5 and np.isinf(v[0, 7:]).all()


# ---------------------------------------------------------------------------
# whole queries on one artifact in both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A real n=128 embedding (k=64), published by the JAX store, raw and bf16."""
    a = gmm_snapshot_sequence(128, 2, seed=0, inject_p=0.02, **CPU)
    emb = commute_time_embedding(next(a.snapshots()), CommuteConfig(d=8, q=12, k_override=64),
                                 **CPU)
    roots = {}
    for codec in ("raw", "bf16"):
        roots[codec] = tmp_path_factory.mktemp(codec)
        JEmbStore.create(roots[codec], n=128, k=64, codec=codec, panel_rows=32).put_embedding(
            "t0000", emb.z.numpy(), float(emb.vol), emb.op.deg.numpy())
    return roots


@pytest.mark.parametrize("codec", ["raw", "bf16"])
@pytest.mark.parametrize("corrected", [False, True], ids=["raw", "corrected"])
def test_top_anomalies_match_jax(artifact, codec, corrected):
    p = query.top_anomalies_from_store(EmbeddingStore.open(artifact[codec]), 12,
                                       corrected=corrected, **CPU)
    j = jq.top_anomalies_from_store(JEmbStore.open(artifact[codec]), 12, corrected=corrected,
                                    interpret=True)
    np.testing.assert_array_equal(p.idx, j.idx)
    np.testing.assert_allclose(p.val, j.val, rtol=1e-4, atol=1e-4)
    assert (p.panels, p.bytes_read, p.emb_id) == (j.panels, j.bytes_read, j.emb_id) == \
        (4, p.bytes_read, "t0000")


@pytest.mark.parametrize("codec", ["raw", "bf16"])
@pytest.mark.parametrize("corrected", [False, True], ids=["raw", "corrected"])
def test_nearest_neighbors_match_jax(artifact, codec, corrected):
    p = query.nearest_neighbors(EmbeddingStore.open(artifact[codec]), 41, 8, corrected=corrected,
                                **CPU)
    j = jq.nearest_neighbors(JEmbStore.open(artifact[codec]), 41, 8, corrected=corrected,
                             interpret=True)
    np.testing.assert_array_equal(p.idx, j.idx)
    np.testing.assert_allclose(p.val, j.val, rtol=1e-4, atol=1e-3)
    assert 41 not in p.idx


def _merge_inputs(artifact, codec, largest):
    """The artifact's panels in stored form, and a top-anomaly (largest) or a
    nearest-neighbor query (smallest, node 41 excluded)."""
    h = EmbeddingStore.open(artifact[codec]).latest()
    z = h.to_numpy()
    n, pr = z.shape[0], h.panel_rows
    panels = [(r0, _f32_to_bf16_u16(z[r0:r0 + pr]) if codec == "bf16" else z[r0:r0 + pr])
              for r0 in range(0, n, pr)]
    inv = h.inv_deg().astype(np.float32).reshape(1, n)
    if largest:
        zq, inv_q, ex = h.zbar[None].astype(np.float32), inv.mean(keepdims=True), -1
    else:
        zq, inv_q, ex = z[41:42].copy(), inv[:, 41:42].copy(), 41
    return h, panels, zq, inv_q.astype(np.float32), inv, np.array([[ex]], np.int32)


@pytest.mark.parametrize("codec", ["raw", "bf16"])
@pytest.mark.parametrize("corrected", [False, True], ids=["raw", "corrected"])
@pytest.mark.parametrize("topk,largest", [(1, True), (20, True), (64, True), (20, False)])
def test_panel_merger_matches_per_panel_calls_and_jax(artifact, codec, corrected, topk, largest):
    """A query through one PanelTopk equals bitwise a chain of one-panel
    panel_topk_update calls, and the JAX kernel's ids (topk <= 2 x 32 panel
    rows, clear of its duplicate fill)."""
    h, panels, zq, inv_q, inv, ex = _merge_inputs(artifact, codec, largest)
    kw = dict(topk=topk, corrected=corrected, largest=largest)
    t = {name: torch.from_numpy(x) for name, x in (("zq", zq), ("inv_q", inv_q), ("inv", inv),
                                                    ("ex", ex))}
    merger = eq.PanelTopk(t["zq"], t["inv_q"], t["inv"], t["ex"], h.vol,
                          panel_rows=h.panel_rows, **kw)
    state = eq.topk_init(1, topk, largest=largest, device="cpu")
    j_state = tuple(np.asarray(x) for x in j_init(1, topk, largest=largest))
    for r0, p in panels:
        zp = torch.from_numpy(p.view(np.int16) if p.dtype == np.uint16 else p)
        merger.update(zp, r0)
        inv_p = t["inv"][:, r0 : r0 + zp.shape[0]]
        state = eq.panel_topk_update(*state, t["zq"], zp, t["inv_q"], inv_p, h.vol, r0, t["ex"],
                                     **kw)
        j_state = _jax_call(j_state, zq, p, inv_q, inv_p.numpy(), h.vol, r0, ex, **kw)
    got = merger.result()
    assert torch.equal(got[0], state[0]) and torch.equal(got[1], state[1])
    np.testing.assert_array_equal(got[1].numpy(), j_state[1])
    np.testing.assert_allclose(got[0].numpy(), j_state[0], rtol=1e-5,
                               atol=1e-5 * float(np.abs(j_state[0]).max()))
    assert 41 not in got[1].tolist()[0] or largest


def test_panel_merger_checks_its_arguments_once():
    zq, idq, inv = torch.zeros((1, 8)), torch.zeros((1, 1)), torch.zeros((1, 64))
    ex = torch.full((1, 1), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="inv_deg"):
        eq.PanelTopk(zq, idq, inv[0], ex, 1.0, topk=4, panel_rows=16)
    merger = eq.PanelTopk(zq, idq, inv, ex, 1.0, topk=4, panel_rows=16)
    for panel, row0 in ((torch.zeros((17, 8)), 0), (torch.zeros((16, 7)), 0),
                        (torch.zeros((16, 8)), 56), (torch.zeros((16, 8)), -1)):
        with pytest.raises(ValueError, match="does not fit"):
            merger.update(panel, row0)
    with pytest.raises(TypeError):
        merger.update(torch.zeros((16, 8), dtype=torch.float64), 0)
    merger.update(torch.zeros((16, 8)), 48)
    assert merger.result()[1].tolist() == [[48, 49, 50, 51]]


@pytest.mark.parametrize("corrected", [False, True], ids=["raw", "corrected"])
def test_commute_block_matches_jax(artifact, corrected):
    rows, cols = np.arange(0, 128, 7), np.arange(3, 128, 11)
    p = query.commute_block(EmbeddingStore.open(artifact["raw"]), rows, cols, corrected=corrected)
    j = jq.commute_block(JEmbStore.open(artifact["raw"]), rows, cols, corrected=corrected)
    np.testing.assert_allclose(p, j, rtol=1e-4, atol=1e-3)
    assert p.dtype == np.float32 and p.shape == (rows.size, cols.size)


def test_rank_auc_matches_jax():
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 2, size=200)
    scores = np.round(rng.normal(size=200), 1)  # many ties
    assert query.rank_auc(labels, scores) == jq.rank_auc(labels, scores)
    assert query.rank_auc([0, 0, 1], [0.1, 0.2, 0.9]) == 1.0
    assert query.rank_auc([0, 1, 1], np.ones(3)) == 0.5
    with pytest.raises(ValueError):
        query.rank_auc(np.zeros(4), np.arange(4))


def test_queries_reject_bad_indices(artifact):
    store = EmbeddingStore.open(artifact["raw"])
    with pytest.raises(IndexError, match=r"node index 128 .*n=128"):
        query.nearest_neighbors(store, 128, **CPU)
    with pytest.raises(IndexError, match=r"rows index 999 .*n=128"):
        query.commute_block(store, [999], [0])
    with pytest.raises(IndexError, match=r"cols index -129 .*n=128"):
        query.commute_block(store, [0], [-129])


def test_query_counters_span_and_residency(artifact):
    store = EmbeddingStore.open(artifact["bf16"])
    reset_stream_stats()
    m0 = REGISTRY.snapshot()
    res = query.top_anomalies_from_store(store, 5, **CPU)
    d = REGISTRY.delta(m0)
    assert d["query.calls"] == 1 and d["query.panels"] == 4 == res.panels
    assert d["query.bytes_read"] == res.bytes_read > 0 and d["query.latency_ms"] > 0
    assert d["phase.query.calls"] == 1
    st = stream_stats()
    assert st.bytes_h2d == 128 * 64 * 2 and st.bytes_h2d_saved == 128 * 64 * 2  # bf16 bits
    assert st.peak_live_bytes <= 2 * 32 * 64 * 2  # two staged panels


# ---------------------------------------------------------------------------
# the labeled fixture and the ROC-AUC bar
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("anomaly_nodes", [5, np.array([1, 7, 30])], ids=["count", "ids"])
def test_labeled_gmm_sequence_matches_jax(ctx1, anomaly_nodes):
    from repro.graphs import gmm_snapshot_sequence as j_gmm

    kw = dict(seed=0, anomaly_nodes=anomaly_nodes, dim_nodes=6)
    p = gmm_snapshot_sequence(64, 2, **kw, **CPU)
    j = j_gmm(ctx1, 64, 2, **kw)
    np.testing.assert_array_equal(p.labels, j.labels)
    np.testing.assert_array_equal(p.components, j.components)
    for ap, aj in zip(p.snapshots(), j.snapshots()):
        np.testing.assert_allclose(ap.numpy(), np.asarray(aj), rtol=1e-5, atol=1e-6)
    assert gmm_snapshot_sequence(64, 2, seed=0, **CPU).labels is None


def test_sketch_scorers_within_002_auc_of_exact_oracle():
    """benchmarks/bench_query.py's AUC bar on the port: n=256, 8 planted, 24 dimmed."""
    n = 256
    cfg = CommuteConfig(k_override=64, d=8, q=12, seed=0)
    seq = gmm_snapshot_sequence(n, 2, seed=0, anomaly_nodes=8, dim_nodes=24, inject_steps=set(),
                                **CPU)
    store = EmbeddingStore.create(None, n=n, k=64, seed=0)
    snaps = list(seq.snapshots())
    SequenceDetector(cfg, emb_store=store, **CPU).run(snaps)
    a0 = snaps[0].numpy().astype(np.float64)
    c = exact_commute_distances(a0)
    deg = a0.sum(1)
    exact = {False: c.mean(1),
             True: (c / deg.sum() - (1 / deg)[:, None] - (1 / deg)[None, :]).mean(1)}
    auc = {}
    for corrected in (False, True):
        res = query.top_anomalies_from_store(store.embedding("t0000"), n, corrected=corrected,
                                             **CPU)
        assert sorted(res.idx.tolist()) == list(range(n))
        s = np.empty(n)
        s[res.idx] = res.val
        auc[corrected] = query.rank_auc(seq.labels, s)
        assert abs(auc[corrected] - query.rank_auc(seq.labels, exact[corrected])) <= 0.02
    assert auc[True] >= auc[False]


# ---------------------------------------------------------------------------
# publishing from the sequence engine, and the CLI
# ---------------------------------------------------------------------------


def _publish_run(root, oocore):
    cfg = CommuteConfig(eps_rp=1e-2, d=3, q=3, k_override=6, oocore=oocore)
    store = EmbeddingStore.create(root, n=64, k=6, seed=cfg.seed)
    m0 = REGISTRY.snapshot()
    SequenceDetector(cfg, emb_store=store, **CPU).run(
        gmm_snapshot_sequence(64, 3, seed=0, inject_p=0.02, **CPU).snapshots())
    assert REGISTRY.delta(m0)["phase.publish.calls"] == 3
    return store


def test_detector_publishes_resident_and_out_of_core(tmp_path):
    stores = {oo: _publish_run(tmp_path / str(oo), oo) for oo in (False, True)}
    for oo, store in stores.items():
        assert store.embedding_ids == ["t0000", "t0001", "t0002"]
        assert JEmbStore.open(tmp_path / str(oo)).embedding_ids == store.embedding_ids
    for eid in ("t0000", "t0002"):
        res = {oo: query.top_anomalies_from_store(s, 5, emb_id=eid, **CPU)
               for oo, s in stores.items()}
        np.testing.assert_array_equal(res[True].idx, res[False].idx)
        np.testing.assert_allclose(res[True].val, res[False].val, rtol=1e-3)
        j = jq.top_anomalies_from_store(JEmbStore.open(tmp_path / "True"), 5, emb_id=eid,
                                        interpret=True)
        np.testing.assert_array_equal(j.idx, res[True].idx)
    h = stores[False].latest()
    np.testing.assert_allclose(h.zbar, h.to_numpy().mean(0), rtol=1e-5, atol=1e-6)


def _printed_ids(text: str) -> list[int]:
    return [int(line.split()[2]) for line in text.splitlines() if line.strip().startswith("#")]


def test_query_cli_prints_the_jax_clis_ids(tmp_path, monkeypatch, capsys):
    from repro.launch import caddelag_run as j_run

    root = str(tmp_path / "emb")
    monkeypatch.setattr(sys, "argv", ["caddelag-run", "--n", "64", "--t-steps", "2",
                                      "--schedule", "xla", "--d", "3", "--q", "4",
                                      "--emb-store", root, "--emb-codec", "bf16"])
    j_run.main()
    assert "serve reads with: caddelag-query" in capsys.readouterr().out
    for extra in ([], ["--corrected"], ["--neighbors", "3"]):
        args = ["--store", root, "--top-k", "8", *extra]
        assert jq.main(args) == 0
        want = _printed_ids(capsys.readouterr().out)
        assert query.main([*args, "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert _printed_ids(out) == want and len(want) == 8
        assert "device=cpu" in out and "panels=1" in out


def test_run_cli_publishes_for_the_query_cli(tmp_path, capsys):
    from repro_torch.launch import caddelag_run

    root = str(tmp_path / "emb")
    caddelag_run.main(["--device", "cpu", "--n", "64", "--t-steps", "2", "--d", "3", "--q", "3",
                       "--emb-store", root])
    assert "serve reads with: caddelag-query-torch" in capsys.readouterr().out
    assert EmbeddingStore.open(root).embedding_ids == ["t0000", "t0001"]
    assert query.main(["--store", root, "--top-k", "4", "--device", "cpu"]) == 0
    assert len(_printed_ids(capsys.readouterr().out)) == 4


def test_plain_version_is_a_stable_sort_of_state_then_panel():
    rng = np.random.default_rng(11)
    vals = rng.integers(0, 5, size=(1, 6)).astype(np.float32)
    ids = np.arange(6, dtype=np.int32)[None] + 1000
    z = np.zeros((9, 2), np.float32)
    v, i = ref.panel_topk_update(torch.from_numpy(vals), torch.from_numpy(ids), torch.zeros((1, 2)),
                                 torch.from_numpy(z), torch.zeros((1, 1)), torch.zeros((1, 9)),
                                 2.0, 50, torch.full((1, 1), -1, dtype=torch.int32), topk=15)
    cand = np.concatenate([vals[0], np.zeros(9, np.float32)])
    order = np.argsort(-cand, kind="stable")
    np.testing.assert_array_equal(v[0].numpy(), cand[order])
    np.testing.assert_array_equal(i[0].numpy(), np.concatenate([ids[0], 50 + np.arange(9)])[order])
