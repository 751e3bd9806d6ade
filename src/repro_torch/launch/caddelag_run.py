"""CADDeLaG driver: the sequence engine end to end, on one device or a device grid.

Port of :mod:`repro.launch.caddelag_run`.  Runs a synthetic GMM or
climate-like snapshot sequence through :class:`SequenceDetector` and prints
the same ``[caddelag]`` per-transition lines.  ``--store DIR`` writes the
sequence into a tiled on-disk snapshot store and scores it from there, one
row panel at a time; ``--oocore-chain`` also spills the chain's working
matrices to a scratch store.  ``--emb-store DIR`` publishes each snapshot's
embedding to an embedding store that ``caddelag-query-torch`` serves reads from.
``--incremental-chain`` serves slowly drifting snapshots by low-rank delta
updates against a retained base chain instead of full rebuilds;
``--run-report`` and ``--trace`` write the run report (schema 2) and a
Chrome trace, both checked by ``python -m repro_torch.obs.report FILE...``.
``--data R --model C`` runs the resident path on an R x C device grid (one
card per tile on ``cuda``, every tile on the CPU with ``--device cpu``) with
the chain GEMMs on ``--schedule``; the store, out-of-core, incremental and
embedding-store paths stay on one device (ROADMAP item 9b).

  caddelag-run-torch --n 10512 --t-steps 3 --dataset climate        # on the card
  caddelag-run-torch --device cpu --n 64 --t-steps 3 --d 3 --q 4    # plain PyTorch
  caddelag-run-torch --n 10512 --t-steps 3 --dataset climate --store DIR \
      --oocore-chain --use-gemm-kernel                               # out-of-core
  caddelag-run-torch --n 10512 --t-steps 3 --dataset climate --emb-store DIR
  caddelag-query-torch --store DIR --top-k 20                        # then query it
  caddelag-run-torch --n 10512 --t-steps 4 --drift-nodes 3 --incremental-chain \
      --run-report report.json --trace trace.json                    # delta chain
  caddelag-run-torch --device cpu --n 64 --t-steps 3 --data 2 --model 2 \
      --schedule summa --d 3 --q 4                                   # a 2x2 grid
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import CommuteConfig, SequenceDetector, reset_stream_stats, stream_stats
from repro_torch.core.distmatrix import ITEM_9B
from repro_torch.graphs import (
    climate_snapshot_sequence,
    gmm_snapshot_sequence,
    store_snapshot_sequence,
)


def _default_grid(n: int, n_row_shards: int = 1) -> int:
    """Finest store grid with panels of >= 32 rows that divide the row shards."""
    for g in (16, 8, 4, 2):
        if n % g == 0 and (n // g) % n_row_shards == 0 and n // g >= 32:
            return g
    return 1


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256, help="graph nodes")
    ap.add_argument("--t-steps", type=int, default=2, help="snapshots in the sequence")
    ap.add_argument("--dataset", default="gmm", choices=["gmm", "climate"])
    ap.add_argument("--drift-nodes", type=int, default=None,
                    help="gmm dataset only: only this many nodes move per step and "
                         "no edges are injected")
    ap.add_argument("--schedule", default="cannon", choices=["xla", "summa", "cannon"],
                    help="tile program of the chain GEMMs on a --data x --model grid (cannon "
                         "needs a square grid; xla runs summa's; 1x1: one kernel call)")
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--d", type=int, default=6)
    ap.add_argument("--q", type=int, default=10)
    ap.add_argument("--top-k", type=int, default=20)
    ap.add_argument("--data", type=int, default=1, help="device-grid rows")
    ap.add_argument("--model", type=int, default=1, help="device-grid columns")
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
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="score out-of-core from a tiled snapshot store at DIR")
    ap.add_argument("--store-grid", type=int, default=None,
                    help="tiles per side when creating the store (default: auto)")
    ap.add_argument("--emb-store", default=None, metavar="DIR",
                    help="publish each snapshot's committed (Z, vol, deg) embedding into an "
                         "EmbeddingStore at DIR -- the artifact caddelag-query-torch serves "
                         "top-k / neighbor reads from without re-running the pipeline")
    ap.add_argument("--emb-codec", default="raw", choices=["raw", "bf16"],
                    help="embedding artifact codec (bf16 halves bytes; the query kernel "
                         "decodes it on the card)")
    ap.add_argument("--oocore-chain", action="store_true",
                    help="run the squaring chain out-of-core: S/T/P spill through a "
                         "TileStore scratch, device residency is panels, not n^2")
    ap.add_argument("--oocore-dir", default=None, metavar="DIR",
                    help="scratch dir for --oocore-chain working matrices "
                         "(default: host-RAM scratch)")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="row panels the prefetch thread keeps decoded ahead of compute")
    ap.add_argument("--tile-codec", default="raw", choices=["raw", "bf16", "zstd"],
                    help="tile codec of --store and the --oocore-chain scratch (bf16 halves "
                         "bytes; zstd falls back to raw without the 'zstandard' package)")
    ap.add_argument("--use-gemm-kernel", action="store_true",
                    help="stream_gemm / fused_panel_matvec kernels for the out-of-core chain "
                         "and solve: panels ship in stored form (bf16 bits decode on the "
                         "card); no effect without --oocore-chain")
    ap.add_argument("--solver-batch", type=int, default=1,
                    help="solver iterations per store read of P2 (the rest replay panels "
                         "from host RAM; identical scores)")
    ap.add_argument("--incremental-chain", action="store_true",
                    help="incremental delta-chain updates: on slowly drifting transitions "
                         "the O(n^3) chain rebuild is replaced by a rank-r correction "
                         "propagated with skinny O(n^2 r) passes against the retained base "
                         "chain; a sketched drift monitor falls back to a full rebuild when "
                         "||dS||/||S|| exceeds --delta-budget")
    ap.add_argument("--delta-rank", type=int, default=4,
                    help="rank of the incremental chain correction")
    ap.add_argument("--delta-budget", type=float, default=0.1,
                    help="drift gate for --incremental-chain: sketched ||dS||_F / ||S||_F "
                         "(against the last full rebuild) above which a transition rebuilds")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record a Chrome trace-event JSON of the run (Perfetto / "
                         "chrome://tracing); fences the phase spans, so they measure device "
                         "walls at the cost of extra synchronisation")
    ap.add_argument("--run-report", default=None, metavar="OUT.json",
                    help="write a structured run report (schema 2, see repro_torch.obs.report): "
                         "per-transition phase, bytes, chain and solver telemetry")
    ap.add_argument("--strict-convergence", action="store_true",
                    help="exit with code 2 if any transition's solve finished NOT-CONVERGED")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the hand-written kernels; cpu their plain versions")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from repro_torch.launch.mesh import make_device_grid
    from repro_torch.obs import REGISTRY, enable_tracing, tracer
    from repro_torch.obs.report import build_run_report, save_run_report
    from repro_torch.store import TileStore, resolve_codec

    ctx = make_device_grid(args.data, args.model, args.device)
    grid = None if ctx.is_trivial else ctx
    if grid is not None:
        for flag, on in (("--store", args.store), ("--oocore-chain", args.oocore_chain),
                         ("--incremental-chain", args.incremental_chain),
                         ("--emb-store", args.emb_store)):
            if on:
                raise SystemExit(f"caddelag-run-torch: {flag} with --data {args.data} --model "
                                 f"{args.model}: {ITEM_9B}")
    if args.trace is not None:
        enable_tracing(fence=True)

    # A backend-less zstd request degrades to raw (with a warning) here, once,
    # so the stores and the summary lines report what the tiles really are.
    effective_codec = resolve_codec(args.tile_codec).name
    cfg = CommuteConfig(
        eps_rp=args.eps, d=args.d, q=args.q, schedule=args.schedule,
        solver=args.solver, solver_tol=args.solver_tol,
        solver_max_iters=args.solver_max_iters, delta=args.delta,
        warm_start=args.warm_start, oocore=args.oocore_chain, oocore_dir=args.oocore_dir,
        prefetch_depth=args.prefetch_depth, tile_codec=effective_codec,
        solver_batch=args.solver_batch, use_gemm_kernel=args.use_gemm_kernel,
        incremental_chain=args.incremental_chain, delta_rank=args.delta_rank,
        delta_budget=args.delta_budget,
    )
    if args.dataset == "gmm":
        n_nodes = args.n
        if args.drift_nodes is not None:
            seq = gmm_snapshot_sequence(
                n_nodes, args.t_steps, seed=0, noise=0.02, inject_steps=set(),
                drift_nodes=args.drift_nodes, device=args.device, ctx=grid,
            )
        else:
            seq = gmm_snapshot_sequence(
                n_nodes, args.t_steps, seed=0, inject_p=0.01, device=args.device, ctx=grid
            )
    else:
        side = int(np.sqrt(args.n))
        n_nodes = side * (args.n // side)  # climate grid may round n down
        if n_nodes != args.n:
            print(f"[caddelag] climate grid {side}x{args.n // side}: using n={n_nodes}")
        seq = climate_snapshot_sequence(
            side, args.n // side, args.t_steps, sigma=1.0, device=args.device, ctx=grid
        )

    emb_store = None
    if args.emb_store is not None:
        from repro_torch.store import EmbeddingStore

        emb_store = EmbeddingStore.create(
            args.emb_store, n=n_nodes, k=cfg.k_rp(n_nodes), codec=args.emb_codec,
            seed=cfg.seed, meta={"dataset": args.dataset, "n": n_nodes, "seed": 0},
        )
    det = SequenceDetector(cfg, top_k=args.top_k, donate=args.donate, device=args.device,
                           emb_store=emb_store, ctx=grid)
    if args.store is not None:
        grid = args.store_grid or _default_grid(n_nodes)
        # meta fingerprints the generator: a reused directory with other
        # content is rejected, not silently scored.
        meta = {"dataset": args.dataset, "n": n_nodes, "seed": 0}
        store = TileStore.create(args.store, n=n_nodes, grid=grid, codec=effective_codec,
                                 meta=meta)
        ids = store_snapshot_sequence(store, seq)
        reset_stream_stats()
        m0 = REGISTRY.snapshot()
        res = det.run(store.snapshot(sid) for sid in ids)
        st = stream_stats()
        what = "adjacency + chain scratch" if args.oocore_chain else "adjacency"
        print(
            f"[caddelag] store={args.store} grid={grid}x{grid} "
            f"codec={store.manifest.codec} prefetch={args.prefetch_depth}: "
            f"{args.t_steps} snapshots, {args.t_steps * store.snapshot_nbytes / 1e6:.1f} MB "
            f"logical; read {st.bytes_read / 1e6:.1f} MB from store, decoded "
            f"{st.bytes_decoded / 1e6:.1f} MB, streamed {st.bytes_h2d / 1e6:.1f} MB "
            f"H2D ({what}) in {st.panels} panels, peak device panel residency "
            f"{st.peak_live_bytes / 1e6:.2f} MB"
        )
    else:
        reset_stream_stats()
        m0 = REGISTRY.snapshot()
        res = det.run(seq.snapshots())
    if args.oocore_chain:
        st = stream_stats()
        extra = " (incl. adjacency streaming)" if args.store is not None else ""
        saved = (f" ({st.bytes_h2d_saved / 1e6:.1f} MB saved by on-device decode)"
                 if st.bytes_h2d_saved else "")
        print(
            f"[caddelag] oocore chain: working matrices spilled to "
            f"{args.oocore_dir or 'host RAM'} (codec={effective_codec}, "
            f"solver_batch={args.solver_batch}); {st.panels} panels{extra}, "
            f"{st.bytes_read / 1e6:.1f} MB scratch reads, {st.bytes_h2d / 1e6:.1f} MB "
            f"H2D{saved}, peak device panel residency "
            f"{st.peak_live_bytes / 1e6:.2f} MB (vs ~{5 * n_nodes * n_nodes * 4 / 1e6:.2f} MB "
            f"resident chain working set)"
        )

    if emb_store is not None:
        print(
            f"[caddelag] embedding artifacts -> {args.emb_store}: "
            f"{len(emb_store.embedding_ids)} committed (codec={emb_store.manifest.codec}, "
            f"panel_rows={emb_store.panel_rows}); serve reads with: caddelag-query-torch "
            f"--store {args.emb_store} --top-k {args.top_k} --device {args.device}"
        )

    print(
        f"[caddelag] n={n_nodes} T={args.t_steps} device={args.device} "
        f"grid={args.data}x{args.model} schedule={args.schedule} "
        f"d={args.d} q={args.q} eps={args.eps}: "
        f"{res.chain_builds} chain builds for {len(res.transitions)} transitions"
    )
    if args.incremental_chain:
        run = REGISTRY.delta(m0)  # this run's counts, whatever the process did before
        print(
            f"[caddelag] incremental chain: "
            f"{int(run.get('chain.full_rebuilds', 0))} full rebuilds, "
            f"{int(run.get('chain.incremental_updates', 0))} incremental "
            f"updates, {int(run.get('chain.drift_fallbacks', 0))} drift "
            f"fallbacks (rank={args.delta_rank}, budget={args.delta_budget}, "
            f"last drift={REGISTRY.gauge('chain.drift_last'):.2e}); "
            f"delta GEMM {run.get('chain.delta_gemm_flops', 0) / 1e9:.3f} "
            f"GFLOP, {run.get('chain.delta_gemm_bytes', 0) / 1e6:.1f} MB "
            f"operand traffic"
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
            scratch = sum(rep.bytes_read for rep in reps)
            io = f", {scratch / 1e6:.1f} MB scratch" if any(rep.streamed for rep in reps) else ""
            print(
                f"[caddelag]     solver[{worst.method}{warm}]: {its} its "
                f"(cap {worst.max_iters}), res {worst.residual:.1e}{io}{conv}"
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

    if args.run_report is not None:
        doc = build_run_report(
            config={k.replace("-", "_"): v for k, v in vars(args).items()},
            result=res, n=n_nodes, k_rp=cfg.k_rp(n_nodes),
        )
        save_run_report(doc, args.run_report)
        print(f"[caddelag] run report -> {args.run_report}")
    if args.trace is not None:
        tracer().save(args.trace)
        print(f"[caddelag] trace -> {args.trace} "
              f"({len(tracer().events())} events; open in Perfetto)")

    if bad and args.strict_convergence:
        raise SystemExit(2)


if __name__ == "__main__":
    main()
