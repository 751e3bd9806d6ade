#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port of CADDeLaG (one NVIDIA H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi), and the build of the three
   CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a;
2. each kernel held against its plain PyTorch version on the card at the
   main path's shapes, twice for bitwise repeatability, and timed beside the
   plain version, the one-call PyTorch yardstick where there is one, and the
   card's bound for the same work;
3. the main path: ``SequenceDetector`` over the n=10512 climate sequence
   (the 2.5-degree NCEP/NCAR Reanalysis 1 grid, 73 x 144), with the kernel
   launch counts of that run alone;
4. the same pipeline end to end at n=1536 on the card and on the CPU (plain
   versions): equal top-20 ids and allclose scores.

The line before the last is the JSON ``kernels`` table; the last line is
``{"ok": true, "device": {...}}``.  It imports neither JAX nor the JAX
package.  Long logs go to ``chiprun_out/``.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# The card's published peaks (H100 SXM data sheet; at the full 700 W limit).
PEAK_FP32_OPS = 67e12  # fp32 / 32-bit CUDA-core operations per second
PEAK_BYTES = 3.35e12  # HBM3 bytes per second

N_MAIN = 10512  # 73 x 144
K_MAIN = 17  # ceil(ln(10512 / 1e-3))
TOP_K = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops = ops / PEAK_FP32_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_close(name: str, got, want, rtol_scale: float) -> tuple[float, float]:
    """(max |got - want|, max |want|); the first must be <= rtol_scale x the second."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not math.isfinite(err) or err > rtol_scale * scale:
        fail(f"{name}: max_abs_err {err:.3e} > {rtol_scale:g} x max|plain| {scale:.3e}")
    return err, scale


def check_bitwise(torch, name: str, fn) -> None:
    a, b = fn(), fn()
    if not torch.equal(a, b):
        fail(f"{name}: two runs on the same input differ")


def kernel_row(name: str, source: str, replaces: str, shape: str, check: tuple, tol: float,
               ms: float, plain_ms: float, ops: float, nbytes: float, library_ms, **extra) -> dict:
    """One entry of the ``kernels`` table; logs its line.  ``check`` is check_close's pair."""
    err, scale = check
    bms, by = bound_ms(ops, nbytes)
    lib = "" if library_ms is None else f", library {library_ms:.3f} ms"
    log(f"[kernels] {name} {shape}: max_abs_err {err:.3e} (tol {tol:g} x max|plain| "
        f"{scale:.3e}), bitwise repeatable; {ms:.3f} ms, plain {plain_ms:.3f} ms{lib}, "
        f"bound {bms:.3f} ms ({by})")
    return dict(name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{source}",
                replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms, tolerance=f"{tol:g} x max|plain|",
                max_abs_plain=scale, shape=shape, **extra)


def phase_kernels(torch, rows: list) -> None:
    from repro_torch.core import rng
    from repro_torch.kernels import block_matmul as bm
    from repro_torch.kernels import cad_score as cad
    from repro_torch.kernels import edge_projection as ep
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def uniform(*shape, lo=0.0):
        return torch.rand(shape, generator=g, device=dev) * (1.0 - lo) + lo

    # -- block_matmul: a ragged shape in fp32 and bf16, then the chain's 10512^3
    tol = 2e-5
    m, k, n = 1000, 777, 1030
    for dt in (torch.float32, torch.bfloat16):
        a, b = uniform(m, k, lo=-1.0).to(dt), uniform(k, n, lo=-1.0).to(dt)
        err, _ = check_close(f"block_matmul {m}x{k}x{n} {dt}",
                             bm.block_matmul(a, b, out_dtype=torch.float32),
                             ref.block_matmul(a, b, out_dtype=torch.float32), tol)
        check_bitwise(torch, "block_matmul ragged", lambda: bm.block_matmul(a, b))
        log(f"[kernels] block_matmul {m}x{k}x{n} {dt}: max_abs_err {err:.3e} "
            f"(tol {tol:g} x max|plain|), bitwise repeatable")
    n = N_MAIN
    a, b = uniform(n, n, lo=-1.0), uniform(n, n, lo=-1.0)
    got, want = bm.block_matmul(a, b), ref.block_matmul(a, b)
    check = check_close("block_matmul 10512^3", got, want, tol)
    exact = torch.matmul(a.double(), b.double())
    err64_k = float((got.double() - exact).abs().max())
    err64_p = float((want.double() - exact).abs().max())
    del exact, want, got
    check_bitwise(torch, "block_matmul 10512^3", lambda: bm.block_matmul(a, b))
    ms = time_ms(torch, lambda: bm.block_matmul(a, b), reps=5)
    log(f"[kernels] block_matmul {n}^3: {2 * n**3 / ms / 1e9:.1f} TFLOP/s; max |C - float64 "
        f"product| kernel {err64_k:.3e}, torch.matmul {err64_p:.3e}")
    rows.append(kernel_row(
        "block_matmul", "block_matmul.cu", "src/repro/kernels/block_matmul.py:45",
        f"{n}x{n}x{n} fp32", check, tol, ms,
        time_ms(torch, lambda: ref.block_matmul(a, b), reps=5), 2.0 * n**3, 3.0 * n * n * 4,
        time_ms(torch, lambda: torch.matmul(a, b), reps=5),
        err_vs_fp64=err64_k, plain_err_vs_fp64=err64_p))
    del a, b

    # -- edge_projection: the in-kernel Q field bitwise, then Y at n=10512, k=17
    seed, k = 0, K_MAIN
    for r0, c0 in ((0, 0), (n - 256, n - 256), (0, n - 256)):
        q_kernel = ep.rademacher_field(seed, range(r0, r0 + 256), range(c0, c0 + 256), k)
        q_plain = rng.edge_rademacher(
            seed, torch.arange(r0, r0 + 256, device=dev)[:, None, None],
            torch.arange(c0, c0 + 256, device=dev)[None, :, None],
            torch.arange(k, device=dev)[None, None, :])
        if not torch.equal(q_kernel, q_plain):
            fail(f"edge_projection: in-kernel Q field differs from rng.edge_rademacher "
                 f"at block ({r0}, {c0})")
    log("[kernels] edge_projection: in-kernel Q field bitwise equal to rng.edge_rademacher")
    a = uniform(n, n)
    a.diagonal().zero_()
    tol = 2e-5
    check = check_close("edge_projection", ep.edge_projection(a, seed=seed, k=k),
                        ref.edge_projection(a, seed=seed, k=k), tol)
    check_bitwise(torch, "edge_projection", lambda: ep.edge_projection(a, seed=seed, k=k))
    # per pair: k + 2 hash folds of ~10 integer ops, a sign and an add per column, sqrt/max
    ops = float(n) * n * (10 * (k + 2) + 2 * k + 2)
    rows.append(kernel_row(
        "edge_projection", "edge_projection.cu", "src/repro/kernels/edge_projection.py:50",
        f"A {n}x{n} fp32, k={k}", check, tol,
        time_ms(torch, lambda: ep.edge_projection(a, seed=seed, k=k), reps=5),
        time_ms(torch, lambda: ref.edge_projection(a, seed=seed, k=k), reps=1),
        ops, n * n * 4.0 + n * k * 4.0, None, q_field_bitwise=True))

    # -- cad_scores at n=10512, k=17
    a2 = uniform(n, n)
    z1 = torch.randn((n, k), generator=g, device=dev)
    z2 = torch.randn((n, k), generator=g, device=dev)
    v1, v2 = torch.tensor(10.0, device=dev), torch.tensor(12.5, device=dev)
    tol = 1e-4
    check = check_close("cad_scores", cad.cad_scores(a, a2, z1, z2, v1, v2),
                        ref.cad_scores(a, a2, z1, z2, v1, v2), tol)
    check_bitwise(torch, "cad_scores", lambda: cad.cad_scores(a, a2, z1, z2, v1, v2))
    rows.append(kernel_row(
        "cad_scores", "cad_score.cu", "src/repro/kernels/cad_score.py:49",
        f"A1,A2 {n}x{n}, Z {n}x{k} fp32", check, tol,
        time_ms(torch, lambda: cad.cad_scores(a, a2, z1, z2, v1, v2), reps=10),
        time_ms(torch, lambda: ref.cad_scores(a, a2, z1, z2, v1, v2), reps=3),
        float(n) * n * (4 * k + 12), 2.0 * n * n * 4 + 2 * n * k * 4 + n * 4, None))


def phase_main_path(torch, rows: list) -> None:
    from repro_torch import kernels
    from repro_torch.core import CommuteConfig, SequenceDetector
    from repro_torch.graphs import climate_snapshot_sequence
    from repro_torch.obs import enable_tracing, disable_tracing

    cfg = CommuteConfig(eps_rp=1e-3, d=6, q=10)
    if cfg.k_rp(N_MAIN) != K_MAIN:
        fail(f"k_RP at n={N_MAIN} is {cfg.k_rp(N_MAIN)}, expected {K_MAIN}")
    seq = climate_snapshot_sequence(73, 144, t_steps=3, device="cuda")
    det = SequenceDetector(cfg, top_k=TOP_K, device="cuda")
    enable_tracing(fence=True)  # phase seconds are device walls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = det.run(seq.snapshots())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    disable_tracing()
    peak = torch.cuda.max_memory_allocated() / 1e9

    want = {"block_matmul": 3 * (2 * (cfg.d - 1) + 1), "edge_projection": 3, "cad_scores": 2}
    if counts != want:
        fail(f"main-path launch counts {counts} != {want}")
    for row in rows:
        row["launches"] = counts[row["name"]]
    event = set(seq.event_nodes.tolist())

    def phases(met: dict) -> str:
        return ", ".join(f"{p} {met.get(f'phase.{p}.seconds', 0.0):.3f} s"
                         for p in ("chain", "ingest", "solve", "score"))

    log(f"[main] first push (no transition yet): {phases(res.warmup_metrics or {})}")
    steps = zip(res.transitions, res.transition_seconds, res.transition_metrics)
    for t, (r, dt, met) in enumerate(steps):
        if r.scores.shape != (N_MAIN,) or not bool(torch.isfinite(r.scores).all()):
            fail(f"transition {t}: scores not finite of shape ({N_MAIN},)")
        hits = len(set(r.top_idx.tolist()) & event)
        its = "+".join(str(rep.iterations) for rep in r.solve_reports)
        log(f"[main] transition {t}->{t + 1}: {dt:.3f} s ({phases(met)}); solver its {its}; "
            f"top-{TOP_K} in event region: {hits}/{TOP_K}")
    g_hits = len(set(res.global_top_idx.tolist()) & event)
    log(f"[main] n={N_MAIN} T=3 d={cfg.d} q={cfg.q} k={K_MAIN}: run wall {wall:.3f} s; "
        f"chain builds {res.chain_builds}; launches {counts}; peak device memory {peak:.2f} GB; "
        f"sequence top-{TOP_K} in event region {g_hits}/{TOP_K}")


def phase_end_to_end(torch) -> None:
    import numpy as np

    from repro_torch.core import CommuteConfig, SequenceDetector
    from repro_torch.graphs import climate_snapshot_sequence

    cfg = CommuteConfig(eps_rp=1e-3, d=6, q=10)
    out = {}
    for dev in ("cuda", "cpu"):
        seq = climate_snapshot_sequence(32, 48, t_steps=3, device=dev)
        out[dev] = SequenceDetector(cfg, top_k=TOP_K, device=dev).run(seq.snapshots())
    gpu, cpu = out["cuda"], out["cpu"]
    rtol = 1e-3
    for t, (rg, rc) in enumerate(zip(gpu.transitions, cpu.transitions)):
        sg, sc = rg.scores.cpu().numpy(), rc.scores.cpu().numpy()
        err = float(np.abs(sg - sc).max())
        scale = float(np.abs(sc).max())
        if not np.isfinite(sg).all() or err > rtol * scale:
            fail(f"n=1536 transition {t}: card vs CPU max |diff| {err:.3e} > {rtol:g} x "
                 f"max score {scale:.3e}")
        if rg.top_idx.tolist() != rc.top_idx.tolist():
            fail(f"n=1536 transition {t}: top-{TOP_K} ids differ: {rg.top_idx.tolist()} "
                 f"vs {rc.top_idx.tolist()}")
        srt = np.sort(sc)[::-1]
        log(f"[e2e] n=1536 transition {t}: card vs CPU max |diff| {err:.3e} (tol {rtol:g} x "
            f"max score {scale:.3e}); top-{TOP_K} ids equal; score gap at rank {TOP_K} "
            f"{srt[TOP_K - 1] - srt[TOP_K]:.3e}")
    if gpu.global_top_idx.tolist() != cpu.global_top_idx.tolist():
        fail("n=1536: sequence-wide top-20 ids differ between card and CPU")
    log(f"[e2e] n=1536 sequence-wide top-{TOP_K} ids equal on card and CPU")


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.modules["jax"] = None  # the port must not reach for JAX or the JAX package
    sys.modules["repro"] = None
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no card to run on",
              file=sys.stderr)
        return 1
    from repro_torch import resolve_device
    from repro_torch.kernels import _build

    resolve_device("cuda")  # TF32 off for every fp32 product below
    OUT.mkdir(exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.library()
    info = _build.BUILD_INFO
    (OUT / "kernel_build.log").write_text(info.get("log", ""))
    regs = re.findall(r"Used (\d+) registers", info.get("log", ""))
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", info.get("log", "")))
    log(f"[build] {len(_build.SOURCES)} sources built with nvcc for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s (cached: {info.get('cached')}); ptxas: registers per "
        f"kernel {regs}, {spills} bytes of spill stores in all")

    rows: list = []
    phase_kernels(torch, rows)
    phase_main_path(torch, rows)
    phase_end_to_end(torch)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    table = {"kernels": [{**{k: r[k] for k in keys},
                          **{k: v for k, v in r.items() if k not in keys}} for r in rows]}
    (OUT / "chip_smoke_kernels.json").write_text(json.dumps(table, indent=1))
    log(json.dumps(table))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
