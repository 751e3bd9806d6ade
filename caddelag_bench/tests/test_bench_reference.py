"""The plain reference agrees with the port at a tiny n on the CPU, and stands apart from it."""

import ast
import math

import pytest
import torch

from caddelag_bench import generate, harness, reference
from caddelag_bench.tests.cases import REPO

BENCH = REPO / "caddelag_bench"


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_torch_only():
    assert _imports(BENCH / "reference.py") <= {"math", "torch", "__future__"}


def test_yardstick_generator_and_readers_import_nothing_of_the_program():
    files = [BENCH / "generate.py", BENCH / "yardstick.py", BENCH / "devtrace.py",
             *sorted((BENCH / "metrics").glob("*.py"))]
    for f in files:
        assert not _imports(f) & {"repro", "repro_torch", "jax", "jaxlib", "flax"}, f


def test_nothing_reads_the_jax_benchmarks_folder():
    for f in BENCH.rglob("*.py"):
        assert "benchmarks" not in _imports(f), f


@pytest.mark.parametrize("rows,cols", [((0, 7), (0, 7)), ((3, 9), (1, 12))])
def test_frozen_hash_is_the_programs_field(rows, cols):
    from repro_torch.core import rng

    r = torch.arange(*rows)
    c = torch.arange(*cols)
    seed = 2**31 + 5
    k = 5
    mine = reference.rademacher_signs(seed, r, c, k).to(torch.float32)
    theirs = rng.edge_rademacher(seed, r[:, None, None], c[None, :, None],
                                 torch.arange(k)[None, None, :])
    assert torch.equal(mine, theirs)


def _snapshots(cell, n_lat=8, n_lon=12, seed=3):
    """The cell's first three snapshots at n = 96 (an 8 x 12 grid for a grid field)."""
    conf = dict(cell.config, n_nodes=n_lat * n_lon)
    if conf["graph"]["kind"] == "grid_field":
        conf["graph"] = dict(conf["graph"], n_lat=n_lat, n_lon=n_lon)
    s = generate.SnapshotStream(conf, cell.traffic, seed, "cpu")
    return conf, [s.next()[0] for _ in range(3)]


def test_reference_agrees_with_the_port_on_the_cpu():
    from repro_torch.core.cad import node_anomaly_scores
    from repro_torch.core.embedding import commute_time_embedding

    cell = harness.find_cell("climate-2.5deg.monthly", REPO)
    conf, (_, a1, a2) = _snapshots(cell)
    cfg = harness.commute_config(conf["commute"])
    e1 = commute_time_embedding(a1, cfg, device="cpu")
    e2 = commute_time_embedding(a2, cfg, device="cpu")
    port = node_anomaly_scores(a1, a2, e1, e2)
    z1, vol1 = reference.embedding(a1, conf["commute"])
    assert z1.shape == e1.z.shape == (96, reference.k_rp(96, 1e-3))
    assert math.isclose(float(vol1), float(e1.vol), rel_tol=1e-6)
    ref = reference.transition_scores(a1, a2, conf["commute"])
    top = torch.sort(port, descending=True, stable=True).indices[:20]
    got = harness.compare(port, top, ref, 20)
    assert got["score_gap"] < 1e-4 and got["score_rms"] < 1e-4 and got["top_gap"] == 0.0


def test_reference_edge_projection_is_the_programs_plain_one():
    from repro_torch.kernels import ref as plain

    a = torch.rand(40, 40, dtype=torch.float32)
    a = (a + a.T) / 2
    a.fill_diagonal_(0)
    y64 = reference.edge_projection(a, seed=7, k=6, dtype=torch.float64)
    y32 = plain.edge_projection(a, seed=7, k=6)
    assert torch.allclose(y64, y32.double(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,precision", [("climate-2.5deg.monthly", "tf32"),
                                            ("gmm-32k.scaling", "tf32"),
                                            ("gmm-32k.scaling", "tf32_chain")])
def test_control_is_not_correct_under_the_cell_limits(name, precision):
    """A cell's control fails one of its limits: every product in TF32 in both cells, and the
    chain's products alone in TF32 where a number that this control moves is held (gmm's Z)."""
    cell = harness.find_cell(name, REPO)
    limits = cell.check["limits"]
    conf, (_, a1, a2) = _snapshots(cell)
    z1, vol1 = reference.embedding(a1, conf["commute"], "float64")
    z2, vol2 = reference.embedding(a2, conf["commute"], "float64")
    ref = reference.cad_scores(a1, a2, z1, vol1, z2, vol2)
    c1, cvol1 = reference.embedding(a1, conf["commute"], precision)
    c2, cvol2 = reference.embedding(a2, conf["commute"], precision)
    ctl = reference.cad_scores(a1, a2, c1, cvol1, c2, cvol2, precision)
    top = torch.sort(ctl, descending=True, stable=True).indices[:20]
    got = harness.compare(ctl, top, ref, 20) | harness.compare_embedding(c2, z2)
    assert any(got[k] > limits[k] for k in limits), got


def test_transition_scores_is_both_embeddings_then_the_scores():
    cell = harness.find_cell("climate-2.5deg.monthly", REPO)
    conf, (_, a1, a2) = _snapshots(cell)
    z1, vol1 = reference.embedding(a1, conf["commute"])
    z2, vol2 = reference.embedding(a2, conf["commute"])
    assert torch.equal(reference.transition_scores(a1, a2, conf["commute"]),
                       reference.cad_scores(a1, a2, z1, vol1, z2, vol2))


def test_compare_embedding_reads_gaps_and_refuses_bad_output():
    z = torch.tensor([[-3.0, 1.0], [-1.0, -2.0], [1.0, 4.0], [3.0, -3.0]], dtype=torch.float64)
    assert harness.compare_embedding(z.float(), z) == {"z_gap": 0.0, "z_rms": 0.0}
    shifted = z + torch.tensor([0.5, -2.0], dtype=torch.float64)  # each column moved whole
    assert harness.compare_embedding(shifted, z) == {"z_gap": 0.0, "z_rms": 0.0}
    scaled = z * 1.01
    got = harness.compare_embedding(scaled, z)
    assert got["z_gap"] == pytest.approx(0.01) and got["z_rms"] == pytest.approx(0.01)
    bad = z.clone()
    bad[0, 0] = float("nan")
    for wrong in (bad, z[:3], z.T):
        assert harness.compare_embedding(wrong, z) == {"z_gap": harness.UNUSABLE,
                                                       "z_rms": harness.UNUSABLE}
