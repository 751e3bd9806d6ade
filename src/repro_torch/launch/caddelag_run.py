"""CADDeLaG driver on one device: the sequence engine end to end.

Port of :mod:`repro.launch.caddelag_run` (resident flags).  Runs a synthetic
GMM or climate-like snapshot sequence through :class:`SequenceDetector` and
prints the same ``[caddelag]`` per-transition lines.

  caddelag-run-torch --n 10512 --t-steps 3 --dataset climate        # on the card
  caddelag-run-torch --device cpu --n 64 --t-steps 3 --d 3 --q 4    # plain PyTorch
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import CommuteConfig, SequenceDetector
from repro_torch.graphs import climate_snapshot_sequence, gmm_snapshot_sequence


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256, help="graph nodes")
    ap.add_argument("--t-steps", type=int, default=2, help="snapshots in the sequence")
    ap.add_argument("--dataset", default="gmm", choices=["gmm", "climate"])
    ap.add_argument("--drift-nodes", type=int, default=None,
                    help="gmm dataset only: only this many nodes move per step and "
                         "no edges are injected")
    ap.add_argument("--schedule", default="cannon", choices=["xla", "summa", "cannon"],
                    help="accepted for symmetry with caddelag-run; one device has no schedule")
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--d", type=int, default=6)
    ap.add_argument("--q", type=int, default=10)
    ap.add_argument("--top-k", type=int, default=20)
    ap.add_argument("--solver", default="richardson", choices=["richardson", "chebyshev", "cg"])
    ap.add_argument("--solver-tol", type=float, default=None,
                    help="stop when the relative preconditioned residual drops below this")
    ap.add_argument("--solver-max-iters", type=int, default=None,
                    help="hard cap on solver refinement steps")
    ap.add_argument("--delta", type=float, default=None,
                    help="paper accuracy parameter: q = ceil(log 1/delta)")
    ap.add_argument("--warm-start", action="store_true",
                    help="seed each solve with the previous snapshot's solution")
    ap.add_argument("--donate", action="store_true", help="free outgoing snapshots eagerly")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the hand-written kernels; cpu their plain versions")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = CommuteConfig(
        eps_rp=args.eps, d=args.d, q=args.q, schedule=args.schedule,
        solver=args.solver, solver_tol=args.solver_tol,
        solver_max_iters=args.solver_max_iters, delta=args.delta,
        warm_start=args.warm_start,
    )
    if args.dataset == "gmm":
        n_nodes = args.n
        if args.drift_nodes is not None:
            seq = gmm_snapshot_sequence(
                n_nodes, args.t_steps, seed=0, noise=0.02, inject_steps=set(),
                drift_nodes=args.drift_nodes, device=args.device,
            )
        else:
            seq = gmm_snapshot_sequence(
                n_nodes, args.t_steps, seed=0, inject_p=0.01, device=args.device
            )
    else:
        side = int(np.sqrt(args.n))
        n_nodes = side * (args.n // side)  # climate grid may round n down
        if n_nodes != args.n:
            print(f"[caddelag] climate grid {side}x{args.n // side}: using n={n_nodes}")
        seq = climate_snapshot_sequence(
            side, args.n // side, args.t_steps, sigma=1.0, device=args.device
        )

    det = SequenceDetector(cfg, top_k=args.top_k, donate=args.donate, device=args.device)
    res = det.run(seq.snapshots())

    print(
        f"[caddelag] n={n_nodes} T={args.t_steps} device={args.device} "
        f"d={args.d} q={args.q} eps={args.eps}: "
        f"{res.chain_builds} chain builds for {len(res.transitions)} transitions"
    )
    for t, (r, dt) in enumerate(zip(res.transitions, res.transition_seconds)):
        found = r.top_idx.cpu().numpy().tolist()
        truth = set(np.asarray(seq.truth[t])[: args.top_k].tolist())
        hits = len(truth & set(found)) if truth else "-"
        print(
            f"[caddelag]   transition {t}->{t + 1}: {dt:6.2f}s  "
            f"top-{args.top_k} truth overlap: {hits}/{len(truth) if truth else 0}"
        )
        reps = [rep for rep in r.solve_reports if rep is not None]
        if reps:
            its = "+".join(str(rep.iterations) for rep in reps)
            worst = max(reps, key=lambda rep: rep.residual)
            conv = "" if all(rep.converged for rep in reps) else "  NOT-CONVERGED"
            warm = " warm" if any(rep.warm_start for rep in reps) else ""
            print(
                f"[caddelag]     solver[{worst.method}{warm}]: {its} its "
                f"(cap {worst.max_iters}), res {worst.residual:.1e}{conv}"
            )
    total = sum(res.transition_seconds)
    print(f"[caddelag] total {total:.2f}s "
          f"({total / max(len(res.transitions), 1):.2f}s per transition, amortized)")
    g_idx = res.global_top_idx.tolist()
    g_step = res.global_top_step.tolist()
    print(f"[caddelag] sequence-wide top-{args.top_k}: "
          f"{[f'{i}@t{s}' for i, s in zip(g_idx, g_step)]}")
    bad = sum(
        1 for r in res.transitions
        if any(rep is not None and not rep.converged for rep in r.solve_reports)
    )
    if bad:
        print(f"[caddelag] WARNING: {bad}/{len(res.transitions)} transitions "
              f"had a NOT-CONVERGED solve")


if __name__ == "__main__":
    main()
