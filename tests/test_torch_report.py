"""The port's run report, Chrome trace and roofline against the JAX package (CPU).

``caddelag-run-torch --device cpu --incremental-chain --run-report --trace``
at n=64 writes documents that the reference's validators
(``repro.obs.report``) accept as well as the port's copies; the report's
``chain`` section counts exactly what the JAX CLI's does on the same
arguments (the counts and logical sizes are integers: equal, no tolerance);
``--strict-convergence`` exits with code 2 on a capped solve.  Roofline
formulas are compared exactly (rel 1e-12) at the same peak figures.
"""

import json
import sys
import threading

import pytest

from repro.launch import caddelag_run as j_cli
from repro.obs import report as j_report
from repro.obs import roofline as j_roofline
from repro.obs.metrics import REGISTRY as J_REGISTRY
from repro_torch.launch import caddelag_run
from repro_torch.obs import REGISTRY, disable_tracing, report, roofline, tracer
from repro_torch.obs.trace import Tracer

ARGS = ["--n", "64", "--t-steps", "3", "--d", "3", "--q", "4", "--drift-nodes", "3",
        "--incremental-chain"]
_CHAIN = report.CHAIN_FIELDS


@pytest.fixture
def clean_tracer():
    """The CLI's --trace turns the process tracer on; leave it off and empty."""
    yield
    disable_tracing()
    tracer().clear()


def _run_port(tmp_path, *extra) -> tuple[dict, dict]:
    before = REGISTRY.snapshot()
    caddelag_run.main(["--device", "cpu", *ARGS, "--run-report", str(tmp_path / "r.json"),
                       *extra])
    return json.loads((tmp_path / "r.json").read_text()), dict(before.counters)


def test_report_and_trace_pass_both_validators(tmp_path, clean_tracer, capsys):
    doc, _ = _run_port(tmp_path, "--trace", str(tmp_path / "t.json"))
    trace = json.loads((tmp_path / "t.json").read_text())
    for validate in (j_report.validate_run_report, report.validate_run_report):
        validate(doc)
    for validate in (j_report.validate_chrome_trace, report.validate_chrome_trace):
        validate(trace)
    for main in (j_report.main, report.main):
        assert main([str(tmp_path / "r.json"), str(tmp_path / "t.json")]) == 0
    assert doc["kind"] == "caddelag_run_report" and doc["schema"] == 2
    assert doc["config"]["incremental_chain"] and doc["config"]["device"] == "cpu"
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"phase.chain", "phase.solve", "sequence.push"} <= names
    out = capsys.readouterr().out
    assert "1 full rebuilds, 2 incremental updates, 0 drift fallbacks" in out


def test_chain_totals_equal_jax_cli(tmp_path, monkeypatch):
    """Same arguments through both CLIs: the report's chain totals (less what
    each registry held before the run) and every transition's chain deltas
    are equal."""
    doc, before = _run_port(tmp_path)
    j_before = J_REGISTRY.snapshot().counters
    monkeypatch.setattr(sys, "argv", ["caddelag-run", *ARGS, "--schedule", "xla",
                                      "--run-report", str(tmp_path / "j.json")])
    j_cli.main()
    jdoc = json.loads((tmp_path / "j.json").read_text())

    def run_totals(d, pre):
        return {f: d["chain"][f] - pre.get(f"chain.{f}", 0.0) for f in _CHAIN}

    totals = run_totals(doc, before)
    assert totals == run_totals(jdoc, j_before)
    assert (totals["full_rebuilds"], totals["incremental_updates"]) == (1, 2)
    assert [t["chain"] for t in doc["transitions"]] == [t["chain"] for t in jdoc["transitions"]]
    assert len(doc["chain"]["drift_series"]) >= 2
    assert doc["chain"]["drift_last"] == pytest.approx(jdoc["chain"]["drift_last"], abs=1e-6)


def test_strict_convergence_exits_nonzero_on_capped_solve(tmp_path, capsys):
    capped = ["--solver-tol", "1e-12", "--solver-max-iters", "1"]
    doc, _ = _run_port(tmp_path, *capped)  # not strict: reports and returns
    assert doc["warnings"] and doc["warnings"][0]["event"] == "solver_not_converged"
    assert "NOT-CONVERGED" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        _run_port(tmp_path, *capped, "--strict-convergence")
    assert exc.value.code == 2


def test_report_of_oocore_run_has_the_reference_roofline_keys(tmp_path):
    caddelag_run.main(["--device", "cpu", *ARGS, "--store", str(tmp_path / "st"),
                       "--oocore-chain", "--use-gemm-kernel",
                       "--run-report", str(tmp_path / "r.json")])
    doc = json.loads((tmp_path / "r.json").read_text())
    report.validate_run_report(doc)
    j_report.validate_run_report(doc)
    want = j_roofline.streamed_solve_roofline(bytes_read=1.0, bytes_h2d=1.0, flops=1.0,
                                              seconds=1.0)
    assert set(doc["roofline"]) == set(want)
    assert doc["totals"]["bytes"]["bytes_read"] > 0


@pytest.mark.parametrize("traffic", [(1e9, 0.0, 0.0), (0.0, 1e10, 0.0), (0.0, 0.0, 1e13),
                                     (3e9, 2e10, 5e12)])
def test_roofline_formulas_match_reference(traffic):
    """Same formulas as the reference at the same peaks; the port's defaults
    are the H100 SXM's fp32 rate and its PCIe Gen5 x16 host link."""
    read, h2d, flops = traffic
    peaks = dict(disk_bw=roofline.DISK_BW, h2d_bw=roofline.H2D_BW,
                 peak_flops=roofline.PEAK_FLOPS)
    got = roofline.streamed_solve_roofline(bytes_read=read, bytes_h2d=h2d, flops=flops,
                                           seconds=2.0)
    want = j_roofline.streamed_solve_roofline(bytes_read=read, bytes_h2d=h2d, flops=flops,
                                              seconds=2.0, **peaks)
    assert got.keys() == want.keys() and got["bound"] == want["bound"]
    for k in got:
        if k != "bound":
            assert got[k] == pytest.approx(want[k], rel=1e-12)
    assert roofline.streamed_solve_flops(96, 7, 5) == j_roofline.streamed_solve_flops(96, 7, 5)
    assert (roofline.PEAK_FLOPS, roofline.H2D_BW) == (67e12, 64e9)


def test_tracer_export_names_threads_and_clears(tmp_path):
    tr = Tracer().enable()
    with tr.span("outer", k=1):
        h = tr.begin("prefetch.panel")
        worker = threading.Thread(target=tr.end, args=(h,), name="closer")
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
    tr.save(str(tmp_path / "t.json"))
    doc = json.loads((tmp_path / "t.json").read_text())
    report.validate_chrome_trace(doc)
    j_report.validate_chrome_trace(doc)
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    # the cross-thread span lands on its owner's track, named after the owner
    assert [m["args"]["name"] for m in meta] == [threading.current_thread().name]
    panel = next(e for e in doc["traceEvents"] if e["name"] == "prefetch.panel")
    assert panel["tid"] == threading.get_ident() and "end_tid" in panel["args"]
    tr.clear()
    assert tr.events() == [] and tr.to_chrome_trace()["traceEvents"] == []
