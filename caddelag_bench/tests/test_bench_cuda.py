"""The benchmark's command on the card: a short run of each cell, correct, with its numbers.

Needs a CUDA card (marker ``cuda``); it skips without one.  On the card:
``python3 -m pytest -q --noconftest -m cuda caddelag_bench/tests/test_bench_cuda.py``.
"""

import json
import subprocess
import sys

import pytest
import torch

from caddelag_bench.tests.cases import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "caddelag_bench/run.py", "--workload", cell, "--seed", "4242",
         "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, cwd=REPO, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert list(out)[-1] == "checks"
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert out["metrics"]["chain_roofline_share"]["value"] <= 100
