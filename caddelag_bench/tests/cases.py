"""Shared by the benchmark's CPU tests: a copy of the benchmark with one tiny cell added as files.

The tiny cell is the climate configuration on an 8 x 12 grid under the
monthly traffic, with the gmm cell's check limits (the cell that holds
every kind of number: scores, top-k and the embedding): new files and new
entries of ``BENCHMARK.json`` only, as a later change would add a cell.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = "tiny-climate.monthly"
TINY_CONFIG = "tiny-climate"


def add_tiny_cell(root: Path) -> None:
    """Copy the benchmark under ``root`` and add the tiny cell as new files and entries."""
    shutil.copytree(REPO / "caddelag_bench", root / "caddelag_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = root / "caddelag_bench"
    conf = json.loads((bench / "configs" / "climate-ncep-2.5deg.json").read_text())
    conf.update(name=TINY_CONFIG, n_nodes=96)
    conf["graph"].update(n_lat=8, n_lon=12)
    (bench / "configs" / f"{TINY_CONFIG}.json").write_text(json.dumps(conf))
    limits = json.loads((bench / "cells" / "gmm-32k.scaling.json").read_text())
    (bench / "cells" / f"{TINY}.json").write_text(json.dumps(limits))
    spec["configs"].append({"name": TINY_CONFIG, "source": "a test's configuration",
                            "file": f"caddelag_bench/configs/{TINY_CONFIG}.json",
                            "reduced": ["n_nodes"], "why": "a test's cell"})
    spec["workloads"].append({"name": TINY, "config": TINY_CONFIG, "traffic": "monthly",
                              "chips": 1, "why": "a test's cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(TINY)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("bench")
    add_tiny_cell(root)
    return root
