"""A run loads no module of JAX or of the JAX package; the command refuses without a card or port."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from caddelag_bench import harness
from caddelag_bench.tests.cases import REPO, TINY, tiny_root  # noqa: F401 -- a fixture

RUN = """
import json, sys
sys.path[:0] = [{src!r}, {repo!r}]
from pathlib import Path
from caddelag_bench import harness
cell = harness.find_cell({cell!r}, Path({root!r}))
out = harness.run_cell(cell, Path({root!r}), seed=7, seconds=0.2, trace={trace}, device="cpu")
print(json.dumps({{"correct": out["correct"], "forbidden": harness.forbidden_loaded(),
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_loads_no_jax_and_no_jax_package(tiny_root, trace):  # noqa: F811
    code = RUN.format(src=str(REPO / "src"), repo=str(REPO), cell=TINY, root=str(tiny_root),
                      trace=trace)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert got["forbidden"] == []
    assert "repro_torch" in got["top"]
    assert not {"jax", "jaxlib", "flax", "repro", "benchmarks"} & set(got["top"])


def test_forbidden_names_are_compared_whole(monkeypatch):
    fake = {"repro_torch.core": 1, "jaxtyping": 1, "reproducible": 1, "flaxen.x": 1}
    monkeypatch.setattr(harness, "sys", SimpleNamespace(modules=fake))
    assert harness.forbidden_loaded() == []
    fake.update({"repro.core.chain": 1, "jaxlib": 1})
    assert harness.forbidden_loaded() == ["jaxlib", "repro"]


def _command(root, *args):
    return subprocess.run(
        [sys.executable, str(root / "caddelag_bench" / "run.py"), *args],
        capture_output=True, text=True, env=_env(), timeout=300, cwd=root)


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    proc = _command(REPO, "--workload", "climate-2.5deg.monthly", "--seed", "3",
                    "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_command_refuses_in_a_checkout_without_the_port(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "caddelag_bench", tmp_path / "caddelag_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _command(tmp_path, "--workload", "climate-2.5deg.monthly", "--seed", "3",
                    "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_command_refuses_an_unknown_cell():
    proc = _command(REPO, "--workload", "no-such.cell", "--seed", "3", "--seconds", "1",
                    "--trace", "0")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
