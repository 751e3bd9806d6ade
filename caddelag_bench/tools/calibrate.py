"""Readings that the check's limits are set from, on the card, in one process.

    python3 caddelag_bench/tools/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--controls tf32_chain,tf32] [--seconds 2] \
        [--out readings.jsonl]

For each ``--seeds`` seed, one run of the cell through the harness with a
short window (the lower reading: the program's numbers against the
reference).  For each ``--control-seeds`` seed and each of ``--controls``
(``reference.py``'s control precisions: ``tf32_chain``, the chain's
products as one TF32 product each and the rest in fp32; ``tf32``, every
product in TF32), the control in the program's place on the cell's first
``check_transitions`` window transitions: its scores and top-k of each, and
its embedding of each transition's newer snapshot, read against the
float64 reference by the same numbers as a run (the upper reading).
Every reading is a JSON line on stdout and in ``--out``.  Not run by the
benchmark.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default="tf32_chain,tf32")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch_kernels")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from caddelag_bench import generate, harness, reference

    cell = harness.find_cell(args.workload, ROOT)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for s in [int(x) for x in args.seeds.split(",") if x]:
        t0 = time.perf_counter()
        res = harness.run_cell(cell, ROOT, seed=s, seconds=args.seconds, trace=False,
                               device=args.device)
        emit({"kind": "program", "cell": cell.name, "seed": s, "correct": res["correct"],
              "readings": res["readings"], "checks": res["checks"], "metrics": res["metrics"],
              "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()

    top_k = int(cell.config["detector"]["top_k"])
    controls = [c for c in args.controls.split(",") if c]
    commute = cell.config["commute"]
    torch.backends.cuda.matmul.allow_tf32 = False
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        t0 = time.perf_counter()
        stream = generate.SnapshotStream(cell.config, cell.traffic, s, args.device)
        stream.next()  # snapshot 0: the set-up's first build
        snaps = [stream.next()[0]]  # snapshot 1: the set-up's scored transition's end
        readings = {c: [] for c in controls}
        with torch.no_grad():
            ref_prev = reference.embedding(snaps[-1], commute, "float64")
            ctl_prev = {c: reference.embedding(snaps[-1], commute, c) for c in controls}
            for _ in range(int(cell.check["check_transitions"])):
                snaps = snaps[-1:] + [stream.next()[0]]
                ref_new = reference.embedding(snaps[1], commute, "float64")
                ref = reference.cad_scores(*snaps, *ref_prev, *ref_new).cpu()
                for c in controls:
                    ctl_new = reference.embedding(snaps[1], commute, c)
                    ctl = reference.cad_scores(*snaps, *ctl_prev[c], *ctl_new, precision=c)
                    ctl_top = torch.sort(ctl, descending=True, stable=True).indices[:top_k]
                    got = harness.compare(ctl.cpu(), ctl_top.cpu(), ref, top_k)
                    got.update(harness.compare_embedding(ctl_new[0].cpu(), ref_new[0].cpu()))
                    readings[c].append(got)
                    ctl_prev[c] = ctl_new
                    del ctl
                ref_prev = ref_new
                torch.cuda.empty_cache()
        for c in controls:
            emit({"kind": "control", "control": c, "cell": cell.name, "seed": s,
                  "readings": readings[c], "seconds": time.perf_counter() - t0})
        del stream, snaps, ref_prev, ctl_prev
        torch.cuda.empty_cache()
    if out:
        out.close()


if __name__ == "__main__":
    main()
