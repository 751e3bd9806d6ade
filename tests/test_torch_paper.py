"""The paper's workloads in the port against the JAX package (CPU).

Generators: ``gmm_graph_sequence`` (injection mask, ``anomalous_nodes`` and
``components`` bitwise; A1, A2 within rtol 1e-6, atol 1e-6),
``climate_like_sequence`` (``event_nodes`` bitwise; adjacencies within rtol
1e-5, atol 1e-6) and ``gmm_store_sequence`` (both pure numpy: tiles
bitwise).  The solver API: ``estimate_solution`` on a JAX-built operator
within 1e-4 x max|y| (``tests/test_torch_chain_solver.py``'s fixed-q bar),
``solver_batch`` 1 and 4 bitwise out of core, ``residual_norm`` against
the float64 residual within fp32's forward error bound (both packages), and
streamed against resident within rel 1e-5.  ``GraphJob`` sizes equal.  Each ``examples/torch_*.py`` ``main`` at a
small size against the JAX example's calls at the same arguments: top-k
ids equal except for ties within 1e-3 of the largest score.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.configs.caddelag as j_jobs
import repro.core as j_core
import repro.graphs as j_graphs
import repro.obs as j_obs
from repro.core import CommuteConfig as JConfig
from repro.core import SequenceDetector as JDetector
from repro.core import chain_product as j_chain_product
from repro.core import detect_anomalies as j_detect
from repro.core import estimate_solution as j_estimate_solution
from repro.core import residual_norm as j_residual_norm
from repro.obs.report import validate_run_report as j_validate_run_report
from repro.store import TileStore as JStore
from repro_torch import core, graphs, obs
from repro_torch.configs import caddelag as jobs
from repro_torch.core import (
    chain_build_count,
    chain_product,
    edge_projection,
    estimate_solution,
    laplacian,
    reset_chain_build_count,
    reset_stream_stats,
    residual_norm,
    stream_stats,
)
from repro_torch.core.solvers import deflate_constant
from repro_torch.graphs import (
    climate_like_sequence,
    gmm_graph_sequence,
    gmm_points,
    gmm_store_sequence,
    similarity_graph,
)
from repro_torch.interop import chain_operator_from_numpy
from repro_torch.store import TileStore

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "climate_anomaly", "election_anomaly", "training_telemetry_anomaly")


def _load(path: Path):
    """Import an example file as a module (its ``main`` stays uncalled)."""
    spec = importlib.util.spec_from_file_location(f"_example_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rhs(n: int, k: int = 4, seed: int = 0) -> np.ndarray:
    b = np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)
    return b - b.mean(0, keepdims=True)


# ---------------------------------------------------------------------------
# exported names, and no JAX in the port's programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("port,ref", [(graphs, j_graphs), (core, j_core), (obs, j_obs)],
                         ids=["graphs", "core", "obs"])
def test_port_exports_the_reference_names(port, ref):
    missing = set(ref.__all__) - set(port.__all__)
    assert missing == set(), sorted(missing)
    assert all(hasattr(port, name) for name in port.__all__)


def _imported_modules(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return mods


def test_examples_and_smoke_import_no_jax():
    files = [ROOT / "chip_smoke.py", *(ROOT / "examples" / f"torch_{e}.py" for e in EXAMPLES),
             *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]
    for f in files:
        bad = {m for m in _imported_modules(f)
               if m.split(".")[0] == "jax" or m == "repro" or m.startswith("repro.")}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
    code = (
        "import sys, importlib.util\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "for p in sys.argv[1:]:\n"
        "    spec = importlib.util.spec_from_file_location('m', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code, *map(str, files[:len(EXAMPLES) + 1])],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------


def _injected(a2_inj, a2_clean) -> np.ndarray:
    """The injection mask, from one package's A2 with and without injections."""
    return np.asarray(a2_inj) != np.asarray(a2_clean)


@pytest.mark.parametrize("n,seed,inject_p", [(64, 0, 0.05), (96, 3, 0.02)])
def test_gmm_graph_sequence_matches_jax(ctx1, n, seed, inject_p):
    j = j_graphs.gmm_graph_sequence(ctx1, n, seed=seed, inject_p=inject_p)
    t = gmm_graph_sequence(n, seed=seed, inject_p=inject_p, device="cpu")
    np.testing.assert_array_equal(t.anomalous_nodes, j.anomalous_nodes)
    np.testing.assert_array_equal(t.components, j.components)
    assert t.anomalous_nodes.size > 0
    # inject_p=0 makes the same draws with no injection: A2 = Q
    j0 = j_graphs.gmm_graph_sequence(ctx1, n, seed=seed, inject_p=0.0)
    t0 = gmm_graph_sequence(n, seed=seed, inject_p=0.0, device="cpu")
    mask = _injected(t.a2, t0.a2)
    np.testing.assert_array_equal(mask, _injected(j.a2, j0.a2))
    assert mask.any() and np.array_equal(mask, mask.T)
    for got, want in ((t.a1, j.a1), (t.a2, j.a2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_climate_like_sequence_matches_jax(ctx1):
    j1, j2, jev = j_graphs.climate_like_sequence(ctx1, 8, 12, seed=2, event_frac=0.05)
    t1, t2, tev = climate_like_sequence(8, 12, seed=2, event_frac=0.05, device="cpu")
    np.testing.assert_array_equal(tev, jev)
    assert tev.size == max(1, int(0.05 * 96))
    for got, want in ((t1, j1), (t2, j2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("codec", ["raw", "bf16"])
def test_gmm_store_sequence_tiles_match_jax(codec):
    n, grid, t_steps = 64, 4, 2
    tstore = TileStore.create(None, n=n, grid=grid, codec=codec)
    jstore = JStore.create(None, n=n, grid=grid, codec=codec)
    ids = gmm_store_sequence(tstore, t_steps, seed=5)
    assert ids == j_graphs.gmm_store_sequence(jstore, t_steps, seed=5)
    for sid in ids:
        for r in range(grid):
            for c in range(grid):
                np.testing.assert_array_equal(tstore.read_tile(sid, r, c),
                                              jstore.read_tile(sid, r, c))
    assert gmm_store_sequence(tstore, t_steps, seed=5) == ids  # committed: skipped


def test_gmm_store_tiles_match_the_resident_graph():
    """The JAX test's bar (``tests/test_store.py``): within rtol 1e-6, atol 1e-6."""
    n = 32
    store = TileStore.create(None, n=n, grid=4)
    (sid,) = gmm_store_sequence(store, 1, seed=7)
    pts, _ = gmm_points(n, 7)
    resident = similarity_graph(pts, device="cpu").numpy()
    np.testing.assert_allclose(store.snapshot(sid).to_numpy(), resident, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the solver API
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gmm64(ctx1):
    a = np.array(j_graphs.gmm_graph_sequence(ctx1, 64, seed=0).a1)
    jop = j_chain_product(ctx1, ctx1.put_matrix(a), 6, schedule="xla")
    op = chain_operator_from_numpy(np.asarray(jop.p1), np.asarray(jop.p2), np.asarray(jop.deg),
                                   np.asarray(jop.vol), jop.rho, device="cpu")
    return a, jop, op, _rhs(64)


def test_estimate_solution_q1_is_chi(gmm64):
    _, _, op, b = gmm64
    y = estimate_solution(op, torch.from_numpy(b), 1)
    chi = deflate_constant(op.p1 @ torch.from_numpy(b))
    torch.testing.assert_close(y, chi, rtol=0, atol=0)


@pytest.mark.parametrize("kw", [{"q_iters": 0}, {"q_iters": 3, "solver_batch": 0}])
def test_estimate_solution_rejects_bad_counts(gmm64, kw):
    _, _, op, b = gmm64
    with pytest.raises(ValueError):
        estimate_solution(op, torch.from_numpy(b), **kw)


def test_estimate_solution_matches_jax(ctx1, gmm64):
    _, jop, op, b = gmm64
    want = np.asarray(j_estimate_solution(ctx1, jop, ctx1.put_rowblock(b), 12), np.float64)
    got = estimate_solution(op, torch.from_numpy(b), 12).numpy().astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("kernel", [False, True])
def test_estimate_solution_batched_out_of_core_is_bitwise(kernel):
    """The phase-10b path at n=64: a store from ``gmm_store_sequence``, an
    out-of-core chain, and ``solver_batch`` 4 against 1."""
    store = TileStore.create(None, n=64, grid=4)
    (sid,) = gmm_store_sequence(store, 1, seed=2)
    h = store.snapshot(sid)
    op = chain_product(h, 3, oocore=True, use_gemm_kernel=kernel, device="cpu")
    y = edge_projection(h, 0, 4, device=torch.device("cpu"))
    sols, reads = {}, {}
    for batch in (1, 4):
        reset_stream_stats()
        sols[batch] = estimate_solution(op, y, 9, solver_batch=batch)
        reads[batch] = stream_stats().bytes_read
    op.release_scratch()
    assert torch.equal(sols[1], sols[4])
    assert reads[1] >= 2 * reads[4] > 0


def test_residual_norm_matches_jax_and_streams(ctx1, gmm64):
    a, jop, op, b = gmm64
    deg = laplacian.degrees(torch.from_numpy(a))
    l_mat = laplacian.laplacian(torch.from_numpy(a), deg)
    x = np.array(j_estimate_solution(ctx1, jop, ctx1.put_rowblock(b), 8))
    want = float(j_residual_norm(ctx1, ctx1.put_matrix(l_mat.numpy()), ctx1.put_rowblock(x),
                                 ctx1.put_rowblock(b)))
    r_res = float(residual_norm(l_mat, torch.from_numpy(x), torch.from_numpy(b)))
    # Both against the float64 residual, within fp32's forward error bound
    # for L x - b: eps32 x || |L| |x| || / ||L x - b||.
    l64, x64 = l_mat.numpy().astype(np.float64), x.astype(np.float64)
    r64 = l64 @ x64 - b
    tol = np.finfo(np.float32).eps * np.linalg.norm(np.abs(l64) @ np.abs(x64)) / np.linalg.norm(r64)
    ref = np.linalg.norm(r64) / np.linalg.norm(b)
    assert r_res == pytest.approx(ref, rel=tol) and want == pytest.approx(ref, rel=tol)
    assert r_res < 0.5  # the solve reduced the residual: the metric means something

    store = TileStore.create(None, n=64, grid=8)
    handle = store.put_snapshot("L", l_mat.numpy())
    x_t = estimate_solution(op, torch.from_numpy(b), 8)
    r_str = float(residual_norm(handle, x_t, torch.from_numpy(b), prefetch_depth=2))
    assert r_str == pytest.approx(float(residual_norm(l_mat, x_t, torch.from_numpy(b))), rel=1e-5)


# ---------------------------------------------------------------------------
# configs and the chain build counter
# ---------------------------------------------------------------------------


def test_graph_jobs_match_jax():
    names = ("CLIMATE", "ELECTION", "SYNTH_100K", "SYNTH_200K", "SYNTH_500K")
    for name in names:
        t, j = getattr(jobs, name), getattr(j_jobs, name)
        assert (t.name, t.n_nodes, t.top_k) == (j.name, j.n_nodes, j.top_k)
        for f in ("eps_rp", "d", "q", "seed", "schedule", "deflate", "fuse_l"):
            assert getattr(t.commute, f) == getattr(j.commute, f), (name, f)
        assert t.commute.k_rp(t.n_nodes) == j.commute.k_rp(j.n_nodes)
    assert [f for f in jobs.GraphJob.__dataclass_fields__] == list(
        j_jobs.GraphJob.__dataclass_fields__)


def test_reset_chain_build_count(ctx1):
    a = torch.from_numpy(np.array(j_graphs.gmm_graph_sequence(ctx1, 32, seed=1).a1))
    counts = []
    for reset in (j_core.reset_chain_build_count, reset_chain_build_count):
        reset()
        counts.append(chain_build_count() if reset is reset_chain_build_count
                      else j_core.chain_build_count())
    chain_product(a, 2)
    chain_product(a, 2)
    assert counts == [0, 0] and chain_build_count() == 2
    before = obs.REGISTRY.value("chain.builds")
    reset_chain_build_count()
    assert chain_build_count() == 0
    assert obs.REGISTRY.value("chain.builds") == before  # the registry counter keeps going


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------


def _assert_topk_equal_but_ties(got: list, want: list, want_scores, tol: float):
    """``got`` equals ``want`` or differs only between entries whose reference
    scores lie within ``tol`` of each other (or of the k-th score)."""
    if got == want:
        return
    s = np.asarray(want_scores, np.float64)
    edge = s[want[-1]]
    for i in set(got) ^ set(want):
        assert abs(s[i] - edge) <= tol, (got, want)
    both = [i for i in got if i in want]
    pos = {i: want.index(i) for i in both}
    for x, i in enumerate(both):
        for k in both[x + 1:]:
            if pos[i] > pos[k]:
                assert abs(s[i] - s[k]) <= tol, (got, want)


def _compare(port_results, jax_results):
    assert len(port_results) == len(jax_results) > 0
    for r, j in zip(port_results, jax_results):
        js = np.asarray(j.scores, np.float64)
        tol = 1e-3 * np.abs(js).max()
        np.testing.assert_allclose(r.scores.numpy(), js, rtol=0, atol=tol)
        _assert_topk_equal_but_ties(r.top_idx.tolist(), np.asarray(j.top_idx).tolist(), js, tol)


def _example(name: str):
    return _load(ROOT / "examples" / f"torch_{name}.py")


def test_quickstart_matches_jax(ctx1, capsys):
    got = _example("quickstart").main(["--device", "cpu"])
    seq = j_graphs.gmm_graph_sequence(ctx1, n=256, seed=0, inject_p=0.02)
    want = j_detect(ctx1, seq.a1, seq.a2, JConfig(eps_rp=1e-3, d=8, q=10, schedule="xla"),
                    top_k=15)
    _compare(got, [want])
    assert "precision@15 vs injected ground truth" in capsys.readouterr().out


def _climate(ctx1, lat, lon, t_steps):
    got = _example("climate_anomaly").main(
        ["--lat", str(lat), "--lon", str(lon), "--t-steps", str(t_steps), "--device", "cpu"])
    seq = j_graphs.climate_snapshot_sequence(ctx1, lat, lon, t_steps, seed=3, sigma=1.0,
                                             event_frac=0.04, event_strength=8.0)
    det = JDetector(ctx1, JConfig(eps_rp=1e-3, d=8, q=10, schedule="xla"), top_k=12)
    _compare(got, det.run(seq.snapshots()).transitions)


@pytest.mark.parametrize("lat,lon,t_steps", [(8, 8, 3), (16, 16, 4)])
def test_climate_example_matches_jax(ctx1, capsys, lat, lon, t_steps):
    _climate(ctx1, lat, lon, t_steps)
    assert "strongest anomaly across the sequence" in capsys.readouterr().out


@pytest.mark.slow
def test_climate_example_matches_jax_at_n1536(ctx1):
    """32 x 48 (n=1536), the size of chip_smoke's card-against-CPU runs: the
    d=8 chain costs about 1e11 flops on the CPU in each package."""
    _climate(ctx1, 32, 48, 3)


def test_election_example_matches_jax(ctx1, capsys):
    j_ex = _load(ROOT / "examples" / "election_anomaly.py")
    port = _example("election_anomaly")
    n, t_steps = 96, 3
    got = port.main(["--n", str(n), "--t-steps", str(t_steps), "--device", "cpu"])
    phases, shifters, n_shift = j_ex.donation_phases(n, t_steps, 0.08)
    t_phases, t_shifters, _ = port.donation_phases(n, t_steps, 0.08)
    assert t_shifters == shifters
    for (p, a), (tp, ta) in zip(phases, t_phases):
        np.testing.assert_array_equal(tp, p)
        np.testing.assert_array_equal(ta, a)
    np.testing.assert_allclose(port.donation_graph(*phases[1], device="cpu").numpy(),
                               np.asarray(j_ex.donation_graph(ctx1, *phases[1])),
                               rtol=1e-6, atol=1e-6)
    det = JDetector(ctx1, JConfig(eps_rp=1e-3, d=8, q=10, schedule="xla"), top_k=n_shift)
    _compare(got, det.run(j_ex.donation_graph(ctx1, p, a) for p, a in phases).transitions)
    assert "amount-only baseline recovers" in capsys.readouterr().out


def test_telemetry_example_matches_jax(ctx1, tmp_path, capsys, monkeypatch):
    """One run report (the port's, from its out-of-core run) scored by both
    packages: the timing channels differ from run to run, the report does not."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    port = _example("training_telemetry_anomaly")
    port.main(["--device", "cpu"])
    (path,) = tmp_path.glob("caddelag_obs_*/report.json")
    doc = json.loads(path.read_text())
    j_ex = _load(ROOT / "examples" / "training_telemetry_anomaly.py")
    j_validate_run_report(doc)  # the JAX validator accepts the port's schema-2 report
    assert doc["schema"] == 2 and len(doc["transitions"]) == 9
    assert sum(t["bytes"]["bytes_read"] for t in doc["transitions"]) > 0  # it ran out of core

    got = port.main(["--device", "cpu", "--report", str(path)])
    out = capsys.readouterr().out
    assert "flagged window" in out

    j_doc = j_ex.inject_fault(json.loads(path.read_text()), 6)
    names, values = j_ex.telemetry_channels(j_doc)
    assert names == port.telemetry_channels(port.inject_fault(json.loads(path.read_text()), 6))[0]
    z = j_ex.normalize_channels(values[:, 2:])
    ccfg = JConfig(eps_rp=1e-2, d=4, q=6, schedule="xla", k_override=6)
    graphs_ = [j_ex.window_graph(ctx1, z, lo, lo + 3) for lo in range(z.shape[1] - 2)]
    want = [j_detect(ctx1, g0, g1, ccfg, top_k=3) for g0, g1 in zip(graphs_, graphs_[1:])]
    _compare(got, want)
