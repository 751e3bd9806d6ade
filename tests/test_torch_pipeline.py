"""The port's pipeline end to end against the JAX package (CPU, plain kernels).

The snapshots are built once (by the JAX package's generators) and the same
numpy arrays go to both packages.  Tolerances: scores rtol 1e-4 with an
absolute floor of 1e-4 x the largest score (small scores are sums of
cancelling terms); top-k ids identical, per transition and sequence-wide.
"""

import numpy as np
import pytest
import torch

from repro.core import CommuteConfig as JConfig
from repro.core import SequenceDetector as JDetector
from repro.core import commute_time_embedding as j_embedding
from repro.core import detect_anomalies as j_detect
from repro.graphs import climate_snapshot_sequence as j_climate
from repro.graphs import gmm_graph_sequence
from repro.graphs import gmm_snapshot_sequence as j_gmm
from repro_torch.core import (
    CommuteConfig,
    SequenceDetector,
    commute_distance_block,
    commute_time_embedding,
    detect_anomalies,
    exact_commute_distances,
    node_anomaly_scores,
    validate_node_indices,
)
from repro_torch.graphs import climate_snapshot_sequence, gmm_snapshot_sequence
from repro_torch.interop import embedding_from_numpy
from repro_torch.launch import caddelag_run


def _scores_close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def gmm4(ctx1):
    seq = j_gmm(ctx1, 64, 4, seed=1, inject_p=0.02)
    return [np.array(a) for a in seq.snapshots()]


def test_detect_anomalies_matches_jax(ctx1, gmm4):
    a1, a2 = gmm4[0], gmm4[1]
    jres = j_detect(ctx1, ctx1.put_matrix(a1), ctx1.put_matrix(a2),
                    JConfig(d=6, q=10, schedule="xla"), top_k=10)
    res = detect_anomalies(_t(a1), _t(a2), CommuteConfig(d=6, q=10), top_k=10, device="cpu")
    _scores_close(res.scores.numpy(), jres.scores)
    assert res.top_idx.tolist() == np.asarray(jres.top_idx).tolist()
    assert [r.iterations for r in res.solve_reports] == [r.iterations for r in jres.solve_reports]


@pytest.mark.parametrize("solver,tol,warm", [("richardson", None, False), ("cg", 1e-5, True)])
def test_sequence_detector_matches_jax(ctx1, gmm4, solver, tol, warm):
    jcfg = JConfig(d=6, q=10, schedule="xla", solver=solver, solver_tol=tol, warm_start=warm)
    cfg = CommuteConfig(d=6, q=10, solver=solver, solver_tol=tol, warm_start=warm)
    jres = JDetector(ctx1, jcfg, top_k=8).run(ctx1.put_matrix(a) for a in gmm4)
    res = SequenceDetector(cfg, top_k=8, device="cpu").run(_t(a) for a in gmm4)
    assert res.n_snapshots == 4 and res.chain_builds == 4 and len(res.transitions) == 3
    for tr, jtr in zip(res.transitions, jres.transitions):
        _scores_close(tr.scores.numpy(), jtr.scores)
        assert tr.top_idx.tolist() == np.asarray(jtr.top_idx).tolist()
        for rep, jrep in zip(tr.solve_reports, jtr.solve_reports):
            assert abs(rep.iterations - jrep.iterations) <= 1
            assert rep.warm_start == jrep.warm_start
    assert res.global_top_idx.tolist() == np.asarray(jres.global_top_idx).tolist()
    assert res.global_top_step.tolist() == np.asarray(jres.global_top_step).tolist()
    np.testing.assert_allclose(res.global_top_val, np.asarray(jres.global_top_val), rtol=1e-4)


def test_scorer_on_jax_embeddings(ctx1, gmm4):
    """Two JAX-built embeddings through interop into the port's scorer."""
    cfg = JConfig(d=5, q=8, schedule="xla")
    a1, a2 = gmm4[1], gmm4[2]
    e1 = j_embedding(ctx1, ctx1.put_matrix(a1), cfg)
    e2 = j_embedding(ctx1, ctx1.put_matrix(a2), cfg)
    from repro.core import node_anomaly_scores as j_scores

    want = j_scores(ctx1, ctx1.put_matrix(a1), ctx1.put_matrix(a2), e1, e2)
    t1 = embedding_from_numpy(np.asarray(e1.z), float(e1.vol), device="cpu")
    t2 = embedding_from_numpy(np.asarray(e2.z), float(e2.vol), device="cpu")
    _scores_close(node_anomaly_scores(_t(a1), _t(a2), t1, t2).numpy(), want)


def test_donate_frees_outgoing_snapshots(gmm4):
    cfg = CommuteConfig(d=3, q=4)
    snaps = [torch.tensor(a) for a in gmm4[:3]]  # memory torch owns, so it can be freed
    keep = SequenceDetector(cfg, top_k=5, device="cpu").run(_t(a) for a in gmm4[:3])
    det = SequenceDetector(cfg, top_k=5, donate=True, device="cpu")
    res = det.run(snaps)
    assert snaps[0].untyped_storage().nbytes() == 0  # left the two-snapshot window
    assert snaps[2].untyped_storage().nbytes() > 0  # still live
    for a, b in zip(res.transitions, keep.transitions):
        np.testing.assert_array_equal(a.scores.numpy(), b.scores.numpy())


def test_finalize_edge_cases():
    det = SequenceDetector(CommuteConfig(d=2, q=2), device="cpu")
    with pytest.raises(ValueError, match="0 snapshots"):
        det.finalize()
    a = torch.rand((16, 16))
    det.push((a + a.T) / 2)
    res = det.finalize()
    assert res.transitions == [] and res.global_top_idx.size == 0 and res.n_snapshots == 1


def test_generators_allclose_to_jax(ctx1):
    """Same numpy draws; torch's exp/sqrt may differ from XLA's in the last ulp."""
    for mine, theirs in (
        (gmm_snapshot_sequence(48, 3, seed=2, device="cpu"), j_gmm(ctx1, 48, 3, seed=2)),
        (gmm_snapshot_sequence(48, 3, seed=2, drift_nodes=4, inject_steps=set(), device="cpu"),
         j_gmm(ctx1, 48, 3, seed=2, drift_nodes=4, inject_steps=set())),
        (climate_snapshot_sequence(6, 8, 3, device="cpu"), j_climate(ctx1, 6, 8, 3)),
    ):
        for a, b in zip(mine.snapshots(), theirs.snapshots()):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
        for t_mine, t_theirs in zip(mine.truth, theirs.truth):
            np.testing.assert_array_equal(t_mine, t_theirs)


def test_embedding_approximates_exact(ctx1):
    """Counterpart of test_core_math.py::test_embedding_approximates_exact."""
    a = np.array(gmm_graph_sequence(ctx1, n=128, seed=0).a1)
    cfg = CommuteConfig(eps_rp=1e-3, d=8, q=12, k_override=64)
    emb = commute_time_embedding(_t(a), cfg, device="cpu")
    exact = exact_commute_distances(a)
    idx = torch.arange(128)
    approx = commute_distance_block(emb, idx, idx).numpy()
    mask = ~np.eye(128, dtype=bool)
    rel = np.abs(approx - exact)[mask] / np.maximum(exact[mask], 1e-9)
    assert np.median(rel) < 0.25, f"median rel err {np.median(rel)}"


def test_cad_recovers_injected_anomalies(ctx1):
    """Counterpart of test_core_math.py::test_cad_recovers_injected_anomalies."""
    seq = gmm_graph_sequence(ctx1, n=128, seed=0, inject_p=0.02)
    cfg = CommuteConfig(eps_rp=1e-3, d=8, q=12)
    res = detect_anomalies(_t(seq.a1), _t(seq.a2), cfg, top_k=20, device="cpu")
    truth = set(seq.anomalous_nodes.tolist())
    precision = len(truth & set(res.top_idx.tolist())) / 20
    assert precision >= 0.5, f"precision@20 = {precision}"


def test_top_k_ties_go_to_the_lower_id():
    from repro_torch.core import top_anomalies

    idx, vals = top_anomalies(torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0]), 3)
    assert idx.tolist() == [1, 2, 4] and vals.tolist() == [3.0, 3.0, 3.0]


def test_validate_node_indices():
    validate_node_indices("rows", [0, 5], 6)
    with pytest.raises(IndexError, match="index 6"):
        validate_node_indices("rows", torch.tensor([1, 6]), 6)


def test_cli_smoke(capsys):
    caddelag_run.main(["--device", "cpu", "--n", "64", "--t-steps", "3", "--d", "3", "--q", "4"])
    out = capsys.readouterr().out
    assert "3 chain builds for 2 transitions" in out
    assert out.count("transition ") == 2 and "sequence-wide top-20" in out
    assert "NOT-CONVERGED" not in out


def test_phases_feed_registry_and_tracer():
    """Each pipeline phase adds its seconds to the registry and, with tracing on, a span."""
    from repro_torch.obs import REGISTRY, disable_tracing, enable_tracing, tracer

    a = torch.rand((24, 24))
    a = (a + a.T) / 2
    a.fill_diagonal_(0.0)
    before = REGISTRY.snapshot()
    n_events = len(tracer().events())
    enable_tracing(fence=True)
    try:
        commute_time_embedding(a, CommuteConfig(d=2, q=3), device="cpu")
    finally:
        disable_tracing()
    delta = REGISTRY.delta(before)
    for name in ("chain", "ingest", "solve"):
        assert delta[f"phase.{name}.calls"] == 1.0 and delta[f"phase.{name}.seconds"] > 0
    names = [e["name"] for e in tracer().events()[n_events:]]
    assert {"phase.chain", "phase.ingest", "phase.solve", "solve"} <= set(names)
    assert delta["chain.builds"] == 1.0 and delta["solver.iterations"] == 2.0
