"""A cell added only as files runs on the CPU; the generator is deterministic under a seed."""

import json
import time

import pytest
import torch

from caddelag_bench import generate, harness
from caddelag_bench.tests.cases import REPO, TINY, tiny_root  # noqa: F401 -- a fixture

SEED = 2**31 + 12345  # larger than 32 signed bits hold


def test_added_cell_is_found_and_runs(tiny_root):  # noqa: F811
    cell = harness.find_cell(TINY, tiny_root)
    assert cell.config["n_nodes"] == 96 and cell.traffic["event_every"] == 12
    out = harness.run_cell(cell, tiny_root, seed=SEED, seconds=0.3, trace=False, device="cpu")
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(out)[-1] == "checks"
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], name
    # the repository's own files are untouched: the tiny cell lives in the copy only
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    assert TINY not in {w["name"] for w in spec["workloads"]}


def test_traced_run_reads_the_fenced_phases(tiny_root):  # noqa: F811
    cell = harness.find_cell(TINY, tiny_root)
    out = harness.run_cell(cell, tiny_root, seed=SEED, seconds=0.4, trace=True, device="cpu")
    assert out["correct"] is True
    got = set(out["metrics"])
    assert {"chain_ms", "ingest_ms", "solve_ms", "score_ms", "sequence_self_ms"} <= got
    # device readings are never made off the card: left out, not written as 0
    assert not got & {"chain_roofline_share", "score_roofline_share", "device_idle_share"}
    assert "busy_s" not in out["device"]


def test_push_wall_leaves_the_snapshot_build_out(tiny_root, monkeypatch):  # noqa: F811
    """``sequence_self_ms`` reads ``push`` alone: a slow snapshot build does not reach it."""
    cell = harness.find_cell(TINY, tiny_root)
    real = generate.SnapshotStream.next

    def slow(self):
        time.sleep(0.05)
        return real(self)

    monkeypatch.setattr(generate.SnapshotStream, "next", slow)
    out = harness.run_cell(cell, tiny_root, seed=SEED, seconds=0.4, trace=True, device="cpu")
    assert out["correct"] is True
    assert 0 <= out["metrics"]["sequence_self_ms"]["value"] < 25


def test_unknown_cell_is_refused(tiny_root):  # noqa: F811
    with pytest.raises(KeyError):
        harness.find_cell("no-such.cell", tiny_root)


def _stream(cell, seed):
    return generate.SnapshotStream(cell.config, cell.traffic, seed, "cpu")


@pytest.mark.parametrize("name", ["climate-2.5deg.monthly", "gmm-32k.scaling"])
def test_generator_is_deterministic_under_a_seed(name):
    cell = harness.find_cell(name, REPO)
    small = dict(cell.config, n_nodes=96)
    if small["graph"]["kind"] == "grid_field":
        small["graph"] = dict(small["graph"], n_lat=8, n_lon=12)
    cell.config = small
    first, second, other = _stream(cell, SEED), _stream(cell, SEED), _stream(cell, SEED + 1)
    for _ in range(14):  # past the first event month of the climate traffic
        a1, f1 = first.next()
        a2, f2 = second.next()
        a3, _ = other.next()
        assert torch.equal(a1, a2) and int(f1) == int(f2)
        assert not torch.equal(a1, a3)
        assert torch.all(a1.diagonal() == 0) and bool(torch.isfinite(a1).all())
        assert torch.equal(a1, a1.T)


def test_event_and_injections_change_the_snapshot():
    cell = harness.find_cell("climate-2.5deg.monthly", REPO)
    conf = dict(cell.config, n_nodes=96, graph=dict(cell.config["graph"], n_lat=8, n_lon=12))
    s = generate.SnapshotStream(conf, cell.traffic, SEED, "cpu")
    feats = [s.next_features()[0].clone() for _ in range(13)]
    jump = [float((feats[t] - feats[t - 1]).abs().max()) for t in range(1, 13)]
    assert jump[11] > 5 * max(jump[:10])  # month 12 carries the event
    gmm = harness.find_cell("gmm-32k.scaling", REPO)
    conf = dict(gmm.config, n_nodes=200)
    s = generate.SnapshotStream(conf, gmm.traffic, SEED, "cpu")
    feats0, inj0 = s.next_features()
    assert inj0 is None
    feats1, inj1 = s.next_features()
    ij, w = inj1
    assert 0 < len(w) <= 150 and torch.all(ij[:, 0] < ij[:, 1])
    a = s.build(feats1, inj1)
    plain = generate.adjacency(feats1, conf["graph"])
    assert torch.allclose(a[ij[:, 0], ij[:, 1]] - plain[ij[:, 0], ij[:, 1]], w)
    assert torch.equal(a, a.T)
