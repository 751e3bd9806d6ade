"""CADDeLaG watching its own run, on the PyTorch/CUDA port: run-report
telemetry as the anomaly input.

The paper's technique is graph analytics over relationships.  Here it looks
at the richest relational stream the framework owns: its own run report.  A
short sequence run produces a schema-2 run report
(``repro_torch.obs.report``) whose per-transition channels (phase seconds,
bytes moved, panels staged, solver iterations and residuals) move together
in a healthy run.  A performance fault breaks those pairwise relationships
even when every channel stays in range.

1. Run a short GMM snapshot sequence out of core (the ``stream_gemm`` and
   ``fused_panel_matvec`` kernels on the card) and write its run report.
2. Load the report back and inject a deterministic fault into one
   transition: a scratch-read stall (bytes read and solve seconds inflate,
   the rest stays put).
3. For each sliding window of transitions, build a fully connected graph
   over the channels (a similarity kernel over the window's normalized
   values) and score consecutive windows with CADDeLaG, flagging the window
   where the fault enters and the channel that moved.

    PYTHONPATH=src python examples/torch_training_telemetry_anomaly.py [--device cpu]
"""

import argparse
import json
import os
import tempfile

import numpy as np

from repro_torch.core import CommuteConfig, SequenceDetector, detect_anomalies
from repro_torch.graphs import gmm_snapshot_sequence, similarity_graph
from repro_torch.obs.report import build_run_report, save_run_report, validate_run_report


def make_run_report(*, n: int, t_steps: int, path: str, device="cuda") -> dict:
    """Run a short out-of-core sequence and round-trip its run report JSON."""
    cfg = CommuteConfig(eps_rp=1e-2, d=3, q=4, k_override=6, oocore=True, use_gemm_kernel=True)
    det = SequenceDetector(cfg, top_k=5, device=device)
    seq = gmm_snapshot_sequence(n, t_steps, seed=0, inject_p=0.01, device=device)
    res = det.run(seq.snapshots())
    doc = build_run_report(
        config={"example": "training_telemetry_anomaly", "n": n, "t_steps": t_steps},
        result=res, n=n, k_rp=cfg.k_rp(n),
    )
    save_run_report(doc, path)
    with open(path) as f:
        doc = json.load(f)
    validate_run_report(doc)
    return doc


def telemetry_channels(doc: dict) -> tuple[list[str], np.ndarray]:
    """(channel names, (channels, transitions) value matrix) from a report."""
    names, rows = [], []

    def channel(name, values):
        names.append(name)
        rows.append(np.asarray(values, np.float64))

    trs = doc["transitions"]
    for ph in ("ingest", "chain", "solve", "score"):
        channel(f"phase.{ph}.seconds", [t["phases"][ph] for t in trs])
    for b in ("bytes_read", "bytes_decoded", "bytes_h2d"):
        channel(f"stream.{b}", [t["bytes"][b] for t in trs])
    channel("stream.panels", [t["panels"] for t in trs])
    channel("solver.iterations", [sum(s["iterations"] for s in t["solves"]) for t in trs])
    channel("solver.residual", [max((s["residual"] for s in t["solves"]), default=0.0)
                                for t in trs])
    channel("seconds", [t["seconds"] or 0.0 for t in trs])
    return names, np.stack(rows)


def inject_fault(doc: dict, at: int, factor: float = 25.0) -> dict:
    """Scratch-read stall at transition ``at``: reads and solve wall inflate,
    the correlated channels (panels, H2D, iterations) do not follow."""
    tr = doc["transitions"][at]
    tr["bytes"]["bytes_read"] = int(tr["bytes"]["bytes_read"] * factor)
    tr["phases"]["solve"] *= factor
    tr["seconds"] = (tr["seconds"] or 0.0) + tr["phases"]["solve"]
    return doc


def normalize_channels(values: np.ndarray) -> np.ndarray:
    """Per-channel robust scaling across all transitions: log1p, then
    (v - median) / MAD, clipped to +-8.

    Median and MAD so that a fault does not set its own channel's scale:
    deterministic channels (bytes, panels, iterations) have a near-zero
    healthy MAD, so a faulted value lands tens of MADs out, while timing
    jitter stays at a few.  Global, not per window, so a faulted window keeps
    its magnitude."""
    v = np.log1p(np.maximum(values, 0.0))
    med = np.median(v, axis=1, keepdims=True)
    mad = np.median(np.abs(v - med), axis=1, keepdims=True)
    floor = np.maximum(1e-3 * np.maximum(np.abs(med), 1.0), 1e-9)
    return np.clip((v - med) / np.maximum(mad, floor), -8.0, 8.0)


def window_graph(z: np.ndarray, lo: int, hi: int, device="cuda"):
    """Similarity graph over channels from their normalized window values."""
    return similarity_graph(np.asarray(z[:, lo:hi], np.float32), bandwidth=1.0, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=48, help="graph nodes in the source run")
    ap.add_argument("--t-steps", type=int, default=10, help="snapshots in the source run")
    ap.add_argument("--fault-at", type=int, default=6,
                    help="transition index that gets the injected stall")
    ap.add_argument("--window", type=int, default=3, help="transitions per telemetry window")
    ap.add_argument("--report", default=None,
                    help="reuse an existing run report JSON instead of running")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)

    if args.report is not None:
        with open(args.report) as f:
            doc = json.load(f)
        validate_run_report(doc)
    else:
        path = os.path.join(tempfile.mkdtemp(prefix="caddelag_obs_"), "report.json")
        print(f"[telemetry] generating a run report from a {args.t_steps}-snapshot run...")
        doc = make_run_report(n=args.n, t_steps=args.t_steps, path=path, device=args.device)
        print(f"[telemetry] report -> {path}")

    n_tr = len(doc["transitions"])
    fault_at = min(args.fault_at, n_tr - 1)
    doc = inject_fault(doc, fault_at)
    names, values = telemetry_channels(doc)
    # The first transitions' timings include one-off start-up work (kernel
    # loading, allocator growth): a known structural break.  Drop them so the
    # detector sees only steady-state telemetry.
    skip = 2 if n_tr > args.window + 2 else 0
    values = values[:, skip:]
    n_tr -= skip
    fault_at -= skip
    print(f"[telemetry] {len(names)} channels x {n_tr} steady-state "
          f"transitions (warm-up dropped); stall injected at transition "
          f"{fault_at + skip}")

    w = min(args.window, n_tr)
    z = normalize_channels(values)
    ccfg = CommuteConfig(eps_rp=1e-2, d=4, q=6, schedule="xla", k_override=min(6, len(names)))
    prev, scored, results = None, [], []
    for lo in range(0, n_tr - w + 1):
        graph = window_graph(z, lo, lo + w, device=args.device)
        if prev is not None:
            res = detect_anomalies(prev, graph, ccfg, top_k=3, device=args.device)
            scores = res.scores.cpu().numpy()
            scored.append((lo, float(scores.max()), int(scores.argmax())))
            results.append(res)
        prev = graph

    flagged_lo, _, flagged_ch = max(scored, key=lambda t: t[1])
    for lo, v, ch in scored:
        entered = lo + w - 1  # the transition this window newly covers
        mark = "  <-- fault enters window" if entered == fault_at else ""
        print(f"window [{lo},{lo + w}): max score {v:10.4f} (channel {names[ch]}){mark}")
    hit = flagged_lo + w - 1 == fault_at
    print(f"\nflagged window [{flagged_lo},{flagged_lo + w}), "
          f"top channel {names[flagged_ch]} "
          f"({'CORRECT' if hit else 'expected window ending at ' + str(fault_at)})")
    return results


if __name__ == "__main__":
    main()
