"""Run one cell of the port's benchmark once and print its result as the last line.

    python3 caddelag_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the port (``src/repro_torch``).  The port's kernels are built into
``build/repro_torch_kernels/`` there on the first run and loaded from it
after.  It needs as many CUDA cards as the cell asks for, and exits with a
non-zero code and no result without them, without the port, or when a
module of JAX or of the JAX package (``repro``) has been loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _fail(msg: str, code: int = 2) -> None:
    print(f"caddelag_bench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch_kernels")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from caddelag_bench import harness

    try:
        cell = harness.find_cell(args.workload, ROOT)
    except (KeyError, OSError, ValueError) as e:
        _fail(f"cannot read cell {args.workload!r}: {e}")
    try:
        import repro_torch
    except ImportError as e:
        _fail(f"the port is not in this checkout ({e})")
    if ROOT / "src" not in Path(repro_torch.__file__).resolve().parents:
        _fail(f"repro_torch was loaded from {repro_torch.__file__}, not from this checkout")
    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < cell.chips:
        _fail(f"the cell needs {cell.chips} cards, torch sees {torch.cuda.device_count()}")
    torch.set_num_threads(1)

    out = harness.run_cell(cell, ROOT, seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace), device="cuda:0", t_start=T_START)
    bad = harness.forbidden_loaded()
    if bad:
        _fail(f"modules of {bad} were loaded during the run", code=3)
    for note in out.get("notes", []):
        print(f"check note: {note}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
