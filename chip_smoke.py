#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port of CADDeLaG (one NVIDIA H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi), and the build of the CUDA
   kernels from ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a;
2. each kernel held against its plain PyTorch version on the card at the
   main paths' shapes (``wkv`` and ``flash_attention`` at phase 8's prefill
   shapes, with a ragged prompt and an fp32 form, and ``wkv`` against the
   per-step recurrence at strong decay), twice for bitwise repeatability (bf16-bit operands
   also against the same kernel on host-decoded fp32; the row-panel forms
   of ``edge_projection`` and ``cad_scores`` also against the same rows of
   the whole-matrix call, and those two timed on the panel too, with their
   ``torch.profiler`` device times), and timed beside the
   plain version, the one-call PyTorch yardstick where there is one, and the
   card's bound for the same work; ``block_matmul``'s split pass bitwise
   against ``ref.split_tf32`` and its product against a float64 one (and
   ``stream_gemm``'s tensor-core route bitwise equal to it), ``stream_gemm``'s
   route per form and its K step against a float64 product beside
   ``torch.addmm``'s, ``fused_panel_matvec``'s gy bitwise against
   ``stream_gemm(P, y, chi + y_panel, sign=-1)`` (the skinny route it runs
   on) and its device time beside ``torch.addmm``'s for the same gy,
   ``panel_topk_update``'s device time per launch (from a
   ``torch.profiler`` trace) apart from the host's cost of a call and of a
   query's merger step, ``wkv``'s device time over its three launches and
   a bound that counts its exponentials, ``flash_attention``'s route per form and
   its earlier (SIMT) design timed on the same inputs; then the pinned
   host-to-device rate of one out-of-core panel (the ``[h2d]`` line);
3. the resident main path: ``SequenceDetector`` over the n=10512 climate
   sequence (the 2.5-degree NCEP/NCAR Reanalysis 1 grid, 73 x 144), with
   the kernel launch counts of that run alone; then a float64 yardstick
   for the chain at transition 0 (``[chain64]``: P1 and the scores of a
   float64 chain, of the port's ``block_matmul`` chain and of an fp32
   ``torch.matmul`` chain from the same S, and, after phase 5, of the
   out-of-core ``stream_gemm`` chain: max relative errors, top-20 ids and
   the rank-20/21 margin);
4. the same pipeline end to end at n=1536 on the card and on the CPU (plain
   versions): equal top-20 ids and allclose scores;
5. the out-of-core main path: the same n=10512 sequence written to a tiled
   on-disk store, scored from it with the chain's working matrices in a
   host-RAM scratch store and the ``stream_gemm`` / ``fused_panel_matvec``
   kernels; exact launch counts of that run alone (every K step on
   ``stream_gemm``'s tensor-core route, every chi build on its skinny one),
   top-20 ids equal to phase 3's, and the device residency bounds;
6. the out-of-core pipeline at n=1536 with the bf16 tile codec, on the card
   and on the CPU: equal top-20 ids and allclose scores;
7. the query read path: phase 3's sequence again, publishing every
   embedding to an on-disk raw ``EmbeddingStore`` (plus a bf16 copy of the
   last artifact), then top-anomaly queries (raw and corrected, k=20 and
   k=300) and a nearest-neighbor query through ``caddelag-query-torch``'s
   functions on both artifacts: exact ``panel_topk_update`` launch counts,
   ids and values against a float64 brute force over the stored Z and
   against the same queries on the CPU, panel-bounded device residency, and
   a raw k=20 query (the median of five) at least 10x faster than a resident
   transition; then the
   same queries on a synthetic n=259,200 artifact (a 0.5-degree global grid,
   360 x 720, k=20, Z from numpy seed 0) with no write path;
8. the serve path of the LM substrate: rwkv6-3b and qwen2-1.5b at full
   width and depth (random weights from seed 0, fp32 parameters, bf16
   compute) through ``ServeEngine.generate``, a batch of 4 prompts of 1024
   tokens and 32 greedy new tokens each: time to first token, decode time
   per step, peak device memory, exact launch counts (``wkv`` once per rwkv
   layer and ``flash_attention`` once per attention layer in prefill, all
   on its tensor-core route, no launch in decode), and one prefill and one
   decode step under
   ``torch.profiler`` (device time by kernel family, the card's idle share);
   then each model at depth 2 in fp32 on the card and on the CPU: equal
   greedy tokens and prefill logits within 1e-3 of the largest.

A copy of the script beside another tree's ``src/`` (a parent commit's
``git archive``) runs the same phases on that tree's package, so both trees
are measured by the same code in one call.

The line before the last is the JSON ``kernels`` table (``launches`` sums
the main paths of phases 3, 5, 7 and 8; ``launches_by_path`` splits them); the
last line is ``{"ok": true, "device": {...}}``.  It imports neither JAX nor
the JAX package.  Long logs go to ``OUT``, a gitignored directory beside
the script; the on-disk stores of phases 5 and 7 live under ``build/`` and
are removed at the end of their phase.
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
PEAK_BF16_OPS = 989e12  # bf16 operands on the tensor cores (dense)
PEAK_TF32_OPS = 495e12  # TF32 operands on the tensor cores (dense)
PEAK_BYTES = 3.35e12  # HBM3 bytes per second
# exponentials (ex2) per second on the SFUs: 16 a clock per SM (CUDA C
# programming guide, arithmetic instruction throughput, compute capability
# 9.0) x 132 SMs x the H100 SXM's 1,980 MHz maximum SM clock
PEAK_SFU_OPS = 16 * 132 * 1.98e9
# 32-bit integer add, shift and logic operations per second: 64 a clock per
# SM (the same table, compute capability 9.0) x 132 SMs x 1,980 MHz.  Integer
# multiplies may also issue on the FMA pipe beside it, so integer work is read
# at this rate and at twice it; a bound takes the second, the lower time.
PEAK_INT32_OPS = 64 * 132 * 1.98e9

N_MAIN = 10512  # 73 x 144
K_MAIN = 17  # ceil(ln(10512 / 1e-3))
TOP_K = 20
BM_ERR64_BAR = 1.04e-3  # max |C - float64| at 10512^3 of the SIMT tile loop this design replaced
STORE_GRID = 16  # input store of the out-of-core path: 657-row panels
PH_OOC = 1314  # its scratch panels (scratch grid 8)
T_OOC = 3  # snapshots of the out-of-core main path
CHAIN_GEMMS = 2 * (6 - 1) + 1  # d = 6: T and P per level, then P2
REFINE_STEPS = 10 - 1  # q = 10
PH_QUERY = 144  # the embedding store's default panel at n=10512: 73 panels
N_LARGE, K_LARGE, PH_LARGE = 360 * 720, 20, 128  # the synthetic artifact: 2025 panels
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 1024, 32  # the serve path's requests
SERVE_MODELS = (("rwkv6-3b", "wkv"), ("qwen2-1.5b", "flash_attention"))  # (arch, its kernel)
QUERIES = (  # (label, k, corrected, nearest-neighbor node or None)
    ("top raw k=20", 20, False, None),
    ("top raw k=300", 300, False, None),
    ("top corrected k=20", 20, True, None),
    ("top corrected k=300", 300, True, None),
    ("neighbors of node 0 k=20", 20, False, 0),
)


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


def kernel_device_ms(torch, fn, reps: int, names: tuple) -> float | None:
    """Device time per call of ``fn``: the durations of the kernels whose names
    contain one of ``names`` in a ``torch.profiler`` trace of ``reps`` calls,
    summed and divided by ``reps``.  None when the trace holds no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA and any(n in e.name for n in names)]
    return sum(us) / reps / 1e3 if us else None


def host_ms(torch, fn, reps: int, warmup: int = 5) -> float:
    """Host wall per call of ``fn`` over ``reps`` back-to-back calls, ending in a
    device sync: the host's cost of a call wherever it exceeds the device's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound_ms(ops: float, nbytes: float, peak_ops: float = PEAK_FP32_OPS,
             sfu_ops: float = 0.0) -> tuple[float, str]:
    """The larger of operations over their peak (``ops`` at ``peak_ops``, and
    ``sfu_ops`` exponentials at the SFUs' rate, whichever takes longer) and
    bytes over the HBM rate."""
    t_ops = max(ops / peak_ops, sfu_ops / PEAK_SFU_OPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_close(name: str, got, want, rtol_scale: float) -> tuple[float, float]:
    """(max |got - want|, max |want|) in fp32; the first must be <= rtol_scale x the second."""
    got, want = got.float(), want.float()
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
               ms: float, plain_ms: float, ops: float, nbytes: float, library_ms,
               peak_ops: float = PEAK_FP32_OPS, sfu_ops: float = 0.0, **extra) -> dict:
    """One entry of the ``kernels`` table; logs its line.  ``check`` is check_close's pair."""
    err, scale = check
    bms, by = bound_ms(ops, nbytes, peak_ops, sfu_ops)
    lib = "" if library_ms is None else f", library {library_ms:.3f} ms"
    log(f"[kernels] {name} {shape}: max_abs_err {err:.3e} (tol {tol:g} x max|plain| "
        f"{scale:.3e}), bitwise repeatable; {ms:.3f} ms, plain {plain_ms:.3f} ms{lib}, "
        f"bound {bms:.3f} ms ({by}; operations at {peak_ops / 1e12:g} T/s)")
    return dict(name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{source}",
                replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms, tolerance=f"{tol:g} x max|plain|",
                max_abs_plain=scale, shape=shape, **extra)


def tf32_edge_cases(torch, dev):
    """fp32 values at TF32's edges, numpy seed 0: subnormals, +-0, every power
    of two, rounding ties (bit 12 set, nothing below) and their neighbours."""
    import numpy as np

    rng = np.random.default_rng(0)
    sub = rng.integers(1, 1 << 23, size=4096).astype(np.uint32)
    pw = np.exp2(np.arange(-149, 128, dtype=np.float64)).astype(np.float32).view(np.uint32)
    tie = ((rng.integers(1, 254, size=4096).astype(np.uint32) << 23)
           | (rng.integers(0, 1 << 10, size=4096).astype(np.uint32) << 13) | 0x1000)
    bits = np.concatenate([sub, pw, [0], tie, tie - 1, tie + 1]).astype(np.uint32)
    bits = np.concatenate([bits, bits | 0x80000000])
    bits = np.resize(bits, (bits.size // 128 + 1) * 128).reshape(-1, 128)
    return torch.from_numpy(bits.view(np.float32)).to(dev)


def phase_kernels(torch, rows: list) -> None:
    """block_matmul, edge_projection and cad_scores, drawing their data in that
    order from one generator."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def uniform(*shape, lo=0.0):
        return torch.rand(shape, generator=g, device=dev) * (1.0 - lo) + lo

    phase_block_matmul(torch, rows, uniform)
    a = phase_edge_projection(torch, rows, uniform)
    phase_cad_scores(torch, rows, g, uniform, a)


def phase_block_matmul(torch, rows: list, uniform) -> None:
    from repro_torch.kernels import block_matmul as bm
    from repro_torch.kernels import ref
    from repro_torch.kernels import stream_gemm as sg

    dev = torch.device("cuda")
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
    # the split pass bitwise against ref.split_tf32: at the main path's
    # operand, and on TF32's edge cases (subnormals, +-0, powers of two, ties)
    edge = tf32_edge_cases(torch, dev)
    for label, x in (("10512x10512 uniform [-1, 1)", a), ("edge cases", edge)):
        got_s, want_s = bm.split_tf32(x), ref.split_tf32(x)
        if not all(torch.equal(u.view(torch.int32), w.view(torch.int32))
                   for u, w in zip(got_s, want_s)):
            fail(f"block_matmul split pass on {label}: differs from ref.split_tf32")
        log(f"[kernels] block_matmul split pass on {label} ({tuple(x.shape)}): hi and lo bitwise "
            f"equal to ref.split_tf32")
        del got_s, want_s
    got, want = bm.block_matmul(a, b), ref.block_matmul(a, b)
    check = check_close("block_matmul 10512^3", got, want, tol)
    exact = torch.matmul(a.double(), b.double())
    err64_k = float((got.double() - exact).abs().max())
    err64_p = float((want.double() - exact).abs().max())
    del want, exact
    if not torch.equal(sg.stream_gemm(a, b), got):  # n > 32: the tensor-core route
        fail("stream_gemm's tensor-core route at 10512^3 differs from block_matmul's product")
    del got
    if err64_k > BM_ERR64_BAR:
        fail(f"block_matmul 10512^3: max |C - float64 product| {err64_k:.3e} > {BM_ERR64_BAR:g}")
    check_bitwise(torch, "block_matmul 10512^3", lambda: bm.block_matmul(a, b))
    if not torch.equal(bm.block_matmul(a, a), bm.block_matmul(a, a.clone())):
        fail("block_matmul 10512^3: b is a (one split pass) differs from two passes")
    ms = time_ms(torch, lambda: bm.block_matmul(a, b), reps=5)
    ms_sq = time_ms(torch, lambda: bm.block_matmul(a, a), reps=5)
    lib = time_ms(torch, lambda: torch.matmul(a, b), reps=5)
    fp32_bound, _ = bound_ms(2.0 * n**3, 3.0 * n * n * 4)
    log(f"[kernels] block_matmul {n}^3 (3xTF32): {2 * n**3 / ms / 1e9:.1f} TFLOP/s; b is a "
        f"(one split pass) {ms_sq:.3f} ms; max |C - float64 product| kernel {err64_k:.3e} (bar "
        f"{BM_ERR64_BAR:g}), torch.matmul {err64_p:.3e}; stream_gemm's tensor-core route on "
        f"the same operands bitwise equal; fp32 CUDA-core bound {fp32_bound:.2f} ms")
    rows.append(kernel_row(
        "block_matmul", "block_matmul.cu", "src/repro/kernels/block_matmul.py:45",
        f"{n}x{n}x{n} fp32 (3xTF32)", check, tol, ms,
        time_ms(torch, lambda: ref.block_matmul(a, b), reps=5), 3 * 2.0 * n**3, 3.0 * n * n * 4,
        lib, peak_ops=PEAK_TF32_OPS, err_vs_fp64=err64_k, plain_err_vs_fp64=err64_p,
        ms_b_is_a=ms_sq, kernel_route="3xTF32 wgmma"))
    del a, b


def phase_edge_projection(torch, rows: list, uniform):
    """edge_projection at n=10512, k=17, resident and on a 657-row panel;
    returns its A (non-symmetric: uniform with a zero diagonal)."""
    from repro_torch.core import rng
    from repro_torch.kernels import edge_projection as ep
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    n = N_MAIN
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
    # a streamed panel of the input store hashes its global rows (row0 != 0)
    r0, h = 5 * (n // STORE_GRID), n // STORE_GRID
    panel = a[r0 : r0 + h].contiguous()
    got = ep.edge_projection(panel, seed=seed, k=k, row0=r0)
    err0, _ = check_close(f"edge_projection row0={r0}", got,
                          ref.edge_projection(panel, seed=seed, k=k, row0=r0), tol)
    if not torch.equal(got, ep.edge_projection(a, seed=seed, k=k)[r0 : r0 + h]):
        fail(f"edge_projection: the panel at row0={r0} differs from the same rows of the "
             f"resident call")
    log(f"[kernels] edge_projection panel {h}x{n} at row0={r0}: max_abs_err {err0:.3e} "
        f"(tol {tol:g} x max|plain|), bitwise equal to those rows of the resident call")

    def call():
        return ep.edge_projection(a, seed=seed, k=k)

    def call_panel():
        return ep.edge_projection(panel, seed=seed, k=k, row0=r0)

    ms, ms_panel = time_ms(torch, call, reps=5), time_ms(torch, call_panel, reps=20)
    dev_ms = kernel_device_ms(torch, call, 5, ("edge_projection",))
    dev_panel = kernel_device_ms(torch, call_panel, 20, ("edge_projection",))
    # The function's integer work, from core/rng.py's hash_u32(seed, lo, hi, c):
    # per unordered pair one fold of hi (hash(seed, lo) is per id) and k of
    # the columns; a fold is an xor with the part's key (a key is per id or
    # column), a multiply, a shift, an xor and a multiply -- splitmix32's
    # xor-shifts by 16 at its two ends cancel between consecutive folds
    # (xs16 is its own inverse), and the last leaves the top bit alone -- ;
    # then per ordered pair and column one operation applies the sign.  The
    # 2 P k fp32 adds are 0.03 ms at the fp32 rate and do not bind.
    pairs = n * (n - 1) / 2
    int_ops = pairs * (5.0 * (k + 1) + 2.0 * k)
    log(f"[kernels] edge_projection {n}x{n}, k={k}: {ms:.4f} ms (device {fmt_ms(dev_ms)}); "
        f"panel {h}x{n} at row0={r0} {ms_panel:.4f} ms (device {fmt_ms(dev_panel)}); the "
        f"function's integer work {int_ops / 1e9:.3f} G ops ({pairs / 1e6:.2f}M unordered "
        f"pairs x (5 (k + 1) + 2 k)): {int_ops / (2 * PEAK_INT32_OPS) * 1e3:.4f} ms at 128 a "
        f"clock per SM (ALU and multiply pipes), {int_ops / PEAK_INT32_OPS * 1e3:.4f} ms at 64 "
        f"(ALU alone); the bound takes the first")
    rows.append(kernel_row(
        "edge_projection", "edge_projection.cu", "src/repro/kernels/edge_projection.py:50",
        f"A {n}x{n} fp32, k={k}", check, tol, ms,
        time_ms(torch, lambda: ref.edge_projection(a, seed=seed, k=k), reps=1),
        int_ops, n * n * 4.0 + n * k * 4.0, None, peak_ops=2 * PEAK_INT32_OPS,
        q_field_bitwise=True, device_ms=dev_ms, panel_ms=ms_panel, panel_device_ms=dev_panel,
        row0_check={"row0": r0, "rows": h, "max_abs_err": err0}))
    del panel, got
    return a


def phase_cad_scores(torch, rows: list, g, uniform, a) -> None:
    """cad_scores at n=10512, k=17, square and on a 657-row panel; A1 is
    edge_projection's A."""
    from repro_torch.kernels import cad_score as cad
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    n, k = N_MAIN, K_MAIN

    # -- cad_scores at n=10512, k=17
    a2 = uniform(n, n)
    z1 = torch.randn((n, k), generator=g, device=dev)
    z2 = torch.randn((n, k), generator=g, device=dev)
    v1, v2 = torch.tensor(10.0, device=dev), torch.tensor(12.5, device=dev)
    tol = 1e-4
    check = check_close("cad_scores", cad.cad_scores(a, a2, z1, z2, v1, v2),
                        ref.cad_scores(a, a2, z1, z2, v1, v2), tol)
    check_bitwise(torch, "cad_scores", lambda: cad.cad_scores(a, a2, z1, z2, v1, v2))
    # a streamed panel scores its rows (z_i a row slice of Z) against the whole Z
    r0, h = 5 * (n // STORE_GRID), n // STORE_GRID
    rs = slice(r0, r0 + h)
    args = (a[rs], a2[rs], z1[rs], z1, z2[rs], z2, v1, v2)
    got = cad.cad_scores_tile(*args)
    err0, _ = check_close(f"cad_scores panel at row0={r0}", got, ref.cad_scores_tile(*args), tol)
    check_bitwise(torch, "cad_scores panel", lambda: cad.cad_scores_tile(*args))
    if not torch.equal(got, cad.cad_scores(a, a2, z1, z2, v1, v2)[rs]):
        fail(f"cad_scores: the panel at row0={r0} differs from the same rows of the square call")
    log(f"[kernels] cad_scores panel {h}x{n} at row0={r0}: max_abs_err {err0:.3e} "
        f"(tol {tol:g} x max|plain|), bitwise equal to those rows of the square call")

    def call():
        return cad.cad_scores(a, a2, z1, z2, v1, v2)

    def call_panel():
        return cad.cad_scores_tile(*args)

    ms, ms_panel = time_ms(torch, call, reps=10), time_ms(torch, call_panel, reps=20)
    dev_ms = kernel_device_ms(torch, call, 10, ("cad_scores",))
    dev_panel = kernel_device_ms(torch, call_panel, 20, ("cad_scores",))
    log(f"[kernels] cad_scores {n}x{n}, k={k}: {ms:.4f} ms (device {fmt_ms(dev_ms)}); panel "
        f"{h}x{n} at row0={r0} {ms_panel:.4f} ms (device {fmt_ms(dev_panel)})")
    rows.append(kernel_row(
        "cad_scores", "cad_score.cu", "src/repro/kernels/cad_score.py:49",
        f"A1,A2 {n}x{n}, Z {n}x{k} fp32", check, tol, ms,
        time_ms(torch, lambda: ref.cad_scores(a, a2, z1, z2, v1, v2), reps=3),
        float(n) * n * (4 * k + 12), 2.0 * n * n * 4 + 2 * n * k * 4 + n * 4, None,
        device_ms=dev_ms, panel_ms=ms_panel, panel_device_ms=dev_panel,
        panel_check={"row0": r0, "rows": h, "max_abs_err": err0}))


def host_bits(torch, x):
    """The store's bf16 codec on the host: x's bf16 bits, as int16, on x's device."""
    import numpy as np

    from repro_torch.store.tilestore import _f32_to_bf16_u16

    return torch.from_numpy(_f32_to_bf16_u16(x.cpu().numpy()).view(np.int16)).to(x.device)


def host_decoded(torch, bits):
    """bf16 bits decoded by the store's host codec, fp32 on the bits' device."""
    import numpy as np

    from repro_torch.store.tilestore import _bf16_u16_to_f32

    return torch.from_numpy(_bf16_u16_to_f32(bits.cpu().numpy().view(np.uint16))).to(bits.device)


def nbytes(*tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors if t is not None))


def phase_stream_kernels(torch, rows: list) -> dict:
    """stream_gemm and fused_panel_matvec at the out-of-core path's shapes,
    then the pinned H2D / D2H rates of one panel.  Returns per-launch times
    (ms) for the time split of phase 5."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import stream_gemm as sg

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    ph, n, k = PH_OOC, N_MAIN, K_MAIN

    def uniform(*shape):
        return torch.rand(shape, generator=g, device=dev) * 2.0 - 1.0

    blk, right, init, p1 = uniform(ph, ph), uniform(ph, n), uniform(ph, n), uniform(ph, n)
    y = torch.randn((n, k), generator=g, device=dev)
    blk_bits, right_bits, p1_bits = (host_bits(torch, t) for t in (blk, right, p1))
    # one scratch for every K step, as the out-of-core chain allocates it per GEMM
    scratch = torch.empty((sg.scratch_elems(ph, n, ph),), dtype=torch.float32, device=dev)

    # -- stream_gemm: the chain's K step (the accumulator as init) and the chi build
    tol = 2e-5
    variants = []
    cases = (  # (case, A, B, init, sign, the route it must take)
        ("K step fp32, init, sign +1", blk, right, init, 1.0, "tc"),
        ("K step A bits, init, sign +1", blk_bits, right, init, 1.0, "tc"),
        ("K step B bits, init, sign +1", blk, right_bits, init, 1.0, "tc"),
        ("K step fp32, init, sign -1", blk, right, init, -1.0, "tc"),
        ("chi build fp32, no init", p1, y, None, 1.0, "skinny"),
        ("chi build A bits, no init", p1_bits, y, None, 1.0, "skinny"),
    )
    for case, a, b, c0, sign, route in cases:
        m_, k_ = a.shape
        n_ = b.shape[1]
        name = f"stream_gemm {case} ({m_}x{k_})@({k_}x{n_})"
        sc = scratch if route == "tc" else None
        tc0 = sg.tc_launches
        got = sg.stream_gemm(a, b, c0, sign=sign, scratch=sc)
        took = "tc" if sg.tc_launches > tc0 else "skinny"
        if took != route:
            fail(f"{name}: took the {took} route, want {route}")
        err, scale = check_close(name, got, ref.stream_gemm(a, b, c0, sign=sign), tol)
        check_bitwise(torch, name, lambda: sg.stream_gemm(a, b, c0, sign=sign, scratch=sc))
        bits = a.dtype == torch.int16 or b.dtype == torch.int16
        if bits:
            da = host_decoded(torch, a) if a.dtype == torch.int16 else a
            db = host_decoded(torch, b) if b.dtype == torch.int16 else b
            if not torch.equal(got, sg.stream_gemm(da, db, c0, sign=sign)):
                fail(f"{name}: the in-kernel decode differs from the kernel on host-decoded fp32")
        reps = 20
        ms = time_ms(torch, lambda: sg.stream_gemm(a, b, c0, sign=sign, scratch=sc), reps=reps)
        dev_ms = kernel_device_ms(torch, lambda: sg.stream_gemm(a, b, c0, sign=sign, scratch=sc),
                                  reps, ("split_kernel", "gemm_tf32", "skinny"))
        plain = time_ms(torch, lambda: ref.stream_gemm(a, b, c0, sign=sign), reps=reps)
        lib = err64 = lib_err64 = None
        if not bits:  # one PyTorch call computes the same function (TF32 is off)
            if c0 is None:
                call = lambda: torch.mm(a, b)  # noqa: E731
            else:
                call = lambda: torch.addmm(c0, a, b, alpha=sign)  # noqa: E731
            lib = time_ms(torch, call, reps=reps)
            exact = a.double() @ b.double()
            exact = exact if c0 is None else c0.double() + sign * exact
            err64 = float((got.double() - exact).abs().max())
            lib_err64 = float((call().double() - exact).abs().max())
            del exact
        # the tensor-core route runs one TF32 product per pair of parts it
        # does not skip (a bits operand has no lo part): 3, 2, 2 or 1
        npa, npb = (1 if t.dtype == torch.int16 else 2 for t in (a, b))
        products = npa * npb - (npa - 1) * (npb - 1) if route == "tc" else 1
        bms, by = bound_ms(products * 2.0 * m_ * k_ * n_, nbytes(a, b, c0) + m_ * n_ * 4.0,
                           PEAK_TF32_OPS if route == "tc" else PEAK_FP32_OPS)
        variants.append(dict(case=case, shape=f"({m_}x{k_})@({k_}x{n_})", route=route,
                             max_abs_err=err, max_abs_plain=scale, ms=ms, device_ms=dev_ms,
                             plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                             err_vs_fp64=err64, library_err_vs_fp64=lib_err64,
                             decode_bitwise=bits or None))
        lib_s = "" if lib is None else (
            f", torch.{'mm' if c0 is None else 'addmm'} {lib:.3f} ms ({ms / lib:.2f}x); max |C - "
            f"float64| kernel {err64:.3e}, torch {lib_err64:.3e}")
        log(f"[kernels] {name}: {route} route; max_abs_err {err:.3e} (tol {tol:g} x max|plain| "
            f"{scale:.3e}), bitwise repeatable{', decode bitwise' if bits else ''}; {ms:.4f} ms "
            f"(device {fmt_ms(dev_ms)}), plain {plain:.3f} ms{lib_s}, bound {bms:.4f} ms ({by})")
    acc = init.clone()  # the chain accumulates in place: out aliases init
    sg.stream_gemm(blk, right, acc, out=acc, scratch=scratch)
    if not torch.equal(acc, sg.stream_gemm(blk, right, init)):
        fail("stream_gemm: the in-place K step (out=init) differs from the out-of-place one")
    log("[kernels] stream_gemm K step in place (out=init, as the chain runs it): bitwise equal "
        "to the out-of-place launch")
    del acc, scratch
    v0, v4 = variants[0], variants[4]
    if v0["err_vs_fp64"] > v0["library_err_vs_fp64"]:
        fail(f"stream_gemm K step: max |C - float64| {v0['err_vs_fp64']:.3e} > torch.addmm's "
             f"{v0['library_err_vs_fp64']:.3e}")
    rows.append(kernel_row(
        "stream_gemm", "stream_gemm.cu", "src/repro/kernels/stream_gemm.py:96",
        v0["shape"] + " fp32 + init", (v0["max_abs_err"], v0["max_abs_plain"]), tol,
        v0["ms"], v0["plain_ms"], 3 * 2.0 * ph * ph * n, nbytes(blk, right, init) + ph * n * 4.0,
        v0["library_ms"], peak_ops=PEAK_TF32_OPS, variants=variants,
        kernel_route="3xTF32 wgmma (n > 32); skinny fp32 FFMA (n <= 32)",
        err_vs_fp64=v0["err_vs_fp64"], library_err_vs_fp64=v0["library_err_vs_fp64"],
        chi_build_ms=v4["ms"], chi_build_library_ms=v4["library_ms"],
        chi_build_bound_ms=v4["bound_ms"]))
    del blk, right, init, blk_bits, right_bits

    # -- fused_panel_matvec: one richardson iteration over a P2 row panel, on
    # the skinny route with the fused finish: gy bitwise the skinny stream_gemm
    tol = 1e-4
    chi, yp = uniform(ph, k), uniform(ph, k)
    fvars = []
    for case, p in (("P fp32", p1), ("P bf16 bits", p1_bits)):
        name = f"fused_panel_matvec {case} {ph}x{n}, q={k}"
        got = sg.fused_panel_matvec(p, y, chi, yp)
        want = ref.fused_panel_matvec(p, y, chi, yp)
        errs = [check_close(f"{name} {part}", gt, wt, tol)
                for part, gt, wt in zip(("gy", "colsum", "sumsq"), got, want)]
        again = sg.fused_panel_matvec(p, y, chi, yp)
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            fail(f"{name}: two runs on the same input differ")
        if not torch.equal(got[0], sg.stream_gemm(p, y, chi + yp, sign=-1.0)):
            fail(f"{name}: gy differs from stream_gemm(P, y, chi + y_panel, sign=-1)")
        bits = p.dtype == torch.int16
        if bits:
            dec = sg.fused_panel_matvec(host_decoded(torch, p), y, chi, yp)
            if not all(torch.equal(u, v) for u, v in zip(got, dec)):
                fail(f"{name}: the in-kernel decode differs from the kernel on host-decoded fp32")

        def call():
            return sg.fused_panel_matvec(p, y, chi, yp)

        ms = time_ms(torch, call, reps=50)
        dev_ms = kernel_device_ms(torch, call, 50, ("skinny_kernel", "fused_matvec"))
        if dev_ms is None:
            fail(f"{name}: the profiler trace holds none of its kernels")
        # the host's cost of the wrapper's per-call scratch (caching allocator)
        elems = sg.matvec_scratch_elems(ph, n, k)
        alloc = host_ms(torch, lambda: torch.empty((elems,), dtype=torch.float32, device=dev),
                        reps=200)
        plain = time_ms(torch, lambda: ref.fused_panel_matvec(p, y, chi, yp), reps=20)
        lib = lib_dev = None
        if not bits:  # one PyTorch call computes the same gy (TF32 is off)
            init = chi + yp

            def lib_call():
                return torch.addmm(init, p, y, alpha=-1)

            lib = time_ms(torch, lib_call, reps=50)
            lib_dev = kernel_device_ms(torch, lib_call, 50, ("",))
        moved = nbytes(p, y, chi, yp) + ph * k * 4.0 + (k + 1) * 4.0
        bms, by = bound_ms(2.0 * ph * n * k + 5.0 * ph * k, moved)
        fvars.append(dict(case=case, max_abs_err=errs[0][0], max_abs_plain=errs[0][1],
                          colsum_err=errs[1][0], sumsq_err=errs[2][0], ms=ms, device_ms=dev_ms,
                          plain_ms=plain, library_ms=lib, library_device_ms=lib_dev,
                          scratch_alloc_host_ms=alloc,
                          bound_ms=bms, bound_by=by, gy_bitwise_stream_gemm=True,
                          decode_bitwise=bits or None))
        lib_s = "" if lib is None else (
            f", torch.addmm(chi + y_panel, P, y, alpha=-1) {lib:.4f} ms (device "
            f"{fmt_ms(lib_dev)})")
        log(f"[kernels] {name}: max_abs_err gy {errs[0][0]:.3e}, colsum {errs[1][0]:.3e}, "
            f"sumsq {errs[2][0]:.3e} (tol {tol:g} x max|plain| each), bitwise repeatable, gy "
            f"bitwise stream_gemm(P, y, chi + y_panel, sign=-1){', decode bitwise' if bits else ''}"
            f"; {ms:.4f} ms (device {fmt_ms(dev_ms)}), plain {plain:.3f} ms{lib_s}, bound "
            f"{bms:.4f} ms ({by}); its {elems * 4 / 1e6:.2f} MB scratch allocated in "
            f"{alloc:.4f} ms of host time")
    f0 = fvars[0]
    log(f"[kernels] fused_panel_matvec fp32 against torch.addmm for the same gy: device "
        f"{f0['device_ms']:.4f} against {f0['library_device_ms']:.4f} ms "
        f"({f0['device_ms'] / f0['library_device_ms']:.2f}x), events {f0['ms']:.4f} against "
        f"{f0['library_ms']:.4f} ms")
    rows.append(kernel_row(
        "fused_panel_matvec", "stream_gemm.cu", "src/repro/kernels/stream_gemm.py:189",
        f"P {ph}x{n} fp32, y {n}x{k}", (f0["max_abs_err"], f0["max_abs_plain"]), tol,
        f0["ms"], f0["plain_ms"], 2.0 * ph * n * k + 5.0 * ph * k,
        nbytes(p1, y, chi, yp) + ph * k * 4.0 + (k + 1) * 4.0, f0["library_ms"], variants=fvars,
        device_ms=f0["device_ms"], library_device_ms=f0["library_device_ms"],
        library_call="torch.addmm(chi + y_panel, P, y, alpha=-1), the sum made beforehand",
        kernel_route="skinny fp32 FFMA (stream_gemm's n <= 32 route) + fused finish"))

    # -- the panel's trip: pinned H2D (the pipeline's path), D2H of an output panel
    h2d = {}
    for label, dt in (("fp32", torch.float32), ("bf16 bits", torch.int16)):
        host = torch.zeros((ph, n), dtype=dt, pin_memory=True)
        dbuf = torch.empty((ph, n), dtype=dt, device=dev)
        ms = time_ms(torch, lambda: dbuf.copy_(host, non_blocking=True), reps=10)
        h2d[f"h2d_pinned_{label}"] = dict(mb=nbytes(host) / 1e6, ms=ms,
                                           gb_s=nbytes(host) / ms / 1e6)
    t0 = time.perf_counter()
    for _ in range(5):
        p1.cpu()  # pageable, as _write_panel brings each output panel back
    ms = (time.perf_counter() - t0) / 5 * 1e3
    h2d["d2h_pageable_fp32"] = dict(mb=nbytes(p1) / 1e6, ms=ms, gb_s=nbytes(p1) / ms / 1e6)
    f32, b16, d2h = h2d["h2d_pinned_fp32"], h2d["h2d_pinned_bf16 bits"], h2d["d2h_pageable_fp32"]
    log(f"[h2d] pinned host->device, one {ph}x{n} panel: fp32 {f32['mb']:.1f} MB in "
        f"{f32['ms']:.3f} ms ({f32['gb_s']:.1f} GB/s), bf16 bits {b16['mb']:.1f} MB in "
        f"{b16['ms']:.3f} ms ({b16['gb_s']:.1f} GB/s); device->pageable host (.cpu() of an "
        f"output panel) {d2h['ms']:.3f} ms ({d2h['gb_s']:.1f} GB/s)")
    return {"kstep_ms": v0["ms"], "chi_ms": variants[4]["ms"], "matvec_ms": f0["ms"], **h2d}


def phase_main_path(torch) -> dict:
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

    want = {name: 0 for name in counts} | {"block_matmul": 3 * CHAIN_GEMMS,
                                            "edge_projection": 3, "cad_scores": 2}
    if counts != want:
        fail(f"main-path launch counts {counts} != {want}")
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
    return {"counts": counts, "peak": peak, "wall": wall, "seconds": res.transition_seconds,
            "scores": [r.scores.cpu().numpy() for r in res.transitions],
            "top_idx": [r.top_idx.tolist() for r in res.transitions]}


def _transition0(torch, cfg, snaps: list, mm, dtype):
    """Transition 0 of ``snaps`` with the chain's GEMM replaced by ``mm`` (None:
    the port's own ``block_matmul``) and the chain built in ``dtype``; P1 and
    P2 are handed on in fp32, so the rest of the pipeline is the port's.
    Returns snapshot 0's P1 and the transition's scores, float64 on the host."""
    from repro_torch.core import SequenceDetector
    from repro_torch.core import chain as chain_mod
    from repro_torch.core import embedding as emb_mod

    orig_chain, orig_mm = emb_mod.chain_product, chain_mod.matmul
    p1s = []

    def chain_product(a, d_len, **kw):
        chain_mod.matmul = orig_mm if mm is None else mm
        try:
            op = orig_chain(a, d_len, **(kw | {"dtype": dtype}))
        finally:
            chain_mod.matmul = orig_mm
        if not p1s:
            p1s.append(op.p1.cpu().double())
        op.p1, op.p2 = op.p1.float(), op.p2.float()
        return op

    emb_mod.chain_product = chain_product
    try:
        res = SequenceDetector(cfg, top_k=TOP_K, device="cuda").run(snaps)
    finally:
        emb_mod.chain_product = orig_chain
    return p1s[0], res.transitions[0].scores.cpu().double()


def phase_chain_yardstick(torch, resident: dict) -> dict:
    """A float64 yardstick for the chain, n=10512, transition 0 (a measurement,
    not on the port's path): the same S through a chain of float64
    ``torch.matmul`` products, of the port's ``block_matmul``, and of fp32
    ``torch.matmul``; phase 5 adds the out-of-core (``stream_gemm``) run."""
    import itertools

    from repro_torch.core import CommuteConfig
    from repro_torch.graphs import climate_snapshot_sequence

    cfg = CommuteConfig(eps_rp=1e-3, d=6, q=10)
    seq = climate_snapshot_sequence(73, 144, t_steps=3, device="cuda")
    snaps = list(itertools.islice(seq.snapshots(), 2))
    t0 = time.perf_counter()
    mm = lambda x, y, **kw: torch.matmul(x, y)  # noqa: E731 -- float64 or fp32, TF32 off
    out = {"float64": _transition0(torch, cfg, snaps, mm, torch.float64),
           "block_matmul": _transition0(torch, cfg, snaps, None, torch.float32),
           "torch.matmul fp32": _transition0(torch, cfg, snaps, mm, torch.float32)}
    if not torch.equal(out["block_matmul"][1].float(), torch.from_numpy(resident["scores"][0])):
        fail("chain yardstick: the block_matmul chain's transition-0 scores differ from phase 3's")
    log(f"[chain64] n={N_MAIN} transition 0 with a float64, a block_matmul and an fp32 "
        f"torch.matmul chain in {time.perf_counter() - t0:.1f} s (block_matmul's scores bitwise "
        f"equal to phase 3's)")
    del seq, snaps
    torch.cuda.empty_cache()
    return out


def report_chain_yardstick(torch, ys: dict) -> dict:
    """Each chain's P1 and transition-0 scores against the float64 chain's:
    max and Frobenius-norm relative errors, the top-20 ids (as a set, and
    the first rank where the order differs), and the rank-20/21 margin."""
    p1_64, s64 = ys["float64"]
    top64 = torch.argsort(s64, descending=True)[:TOP_K].tolist()
    out = {}
    for name, (p1, sc) in ys.items():
        srt = torch.sort(sc, descending=True).values
        top = torch.argsort(sc, descending=True)[:TOP_K].tolist()
        row = {"margin_20_21": float(srt[TOP_K - 1] - srt[TOP_K]), "top20": top}
        if name != "float64":
            d = p1 - p1_64
            row.update(
                p1_max_rel_err=float(d.abs().max() / p1_64.abs().max()),
                p1_fro_rel_err=float(d.norm() / p1_64.norm()),
                scores_max_rel_err=float((sc - s64).abs().max() / s64.abs().max()),
                scores_max_abs_diff=float((sc - s64).abs().max()),
                top20_set_equal=set(top) == set(top64),
                first_rank_differing=next((r + 1 for r in range(TOP_K) if top[r] != top64[r]),
                                          None))
            log(f"[chain64] {name}: P1 max rel err {row['p1_max_rel_err']:.3e}, Frobenius rel "
                f"err {row['p1_fro_rel_err']:.3e}; scores max rel err "
                f"{row['scores_max_rel_err']:.3e} (max |diff| {row['scores_max_abs_diff']:.3e}); "
                f"top-{TOP_K} ids as a set {'equal to' if row['top20_set_equal'] else 'DIFFERENT from'}"
                f" the float64 chain's, order first differs at rank "
                f"{row['first_rank_differing']}; rank-{TOP_K}/{TOP_K + 1} margin "
                f"{row['margin_20_21']:.4e}")
        else:
            log(f"[chain64] float64 chain (the yardstick): rank-{TOP_K}/{TOP_K + 1} margin "
                f"{row['margin_20_21']:.4e}")
        out[name] = row
    return out


def check_card_vs_cpu(tag: str, gpu, cpu) -> None:
    """Equal top-20 ids (per transition and sequence-wide), scores within 1e-3."""
    import numpy as np

    rtol = 1e-3
    for t, (rg, rc) in enumerate(zip(gpu.transitions, cpu.transitions)):
        sg, sc = rg.scores.cpu().numpy(), rc.scores.cpu().numpy()
        err = float(np.abs(sg - sc).max())
        scale = float(np.abs(sc).max())
        if not np.isfinite(sg).all() or err > rtol * scale:
            fail(f"{tag} transition {t}: card vs CPU max |diff| {err:.3e} > {rtol:g} x "
                 f"max score {scale:.3e}")
        if rg.top_idx.tolist() != rc.top_idx.tolist():
            fail(f"{tag} transition {t}: top-{TOP_K} ids differ: {rg.top_idx.tolist()} "
                 f"vs {rc.top_idx.tolist()}")
        srt = np.sort(sc)[::-1]
        log(f"[e2e] {tag} transition {t}: card vs CPU max |diff| {err:.3e} (tol {rtol:g} x "
            f"max score {scale:.3e}); top-{TOP_K} ids equal; score gap at rank {TOP_K} "
            f"{srt[TOP_K - 1] - srt[TOP_K]:.3e}")
    if gpu.global_top_idx.tolist() != cpu.global_top_idx.tolist():
        fail(f"{tag}: sequence-wide top-{TOP_K} ids differ between card and CPU")
    log(f"[e2e] {tag} sequence-wide top-{TOP_K} ids equal on card and CPU")


def phase_end_to_end(torch) -> None:
    from repro_torch.core import CommuteConfig, SequenceDetector
    from repro_torch.graphs import climate_snapshot_sequence

    cfg = CommuteConfig(eps_rp=1e-3, d=6, q=10)
    out = {}
    for dev in ("cuda", "cpu"):
        seq = climate_snapshot_sequence(32, 48, t_steps=3, device=dev)
        out[dev] = SequenceDetector(cfg, top_k=TOP_K, device=dev).run(seq.snapshots())
    check_card_vs_cpu("n=1536", out["cuda"], out["cpu"])


def phase_oocore(torch, rows: list, resident: dict, per: dict) -> tuple:
    """The out-of-core main path at n=10512, raw codec, host-RAM scratch, kernels on.
    Returns its summary and, for the float64 yardstick, snapshot 0's P1 and the
    transition-0 scores."""
    import gc
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import CommuteConfig, SequenceDetector, reset_stream_stats, stream_stats
    from repro_torch.graphs import climate_snapshot_sequence, store_snapshot_sequence
    from repro_torch.obs import REGISTRY, disable_tracing, enable_tracing
    from repro_torch.store import TileStore

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="smoke_store_", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        seq = climate_snapshot_sequence(73, 144, t_steps=T_OOC, device="cuda")
        store = TileStore.create(tmp, n=N_MAIN, grid=STORE_GRID, codec="raw")
        ids = store_snapshot_sequence(store, seq)
        event = set(seq.event_nodes.tolist())
        del seq
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[oocore] wrote {T_OOC} snapshots of n={N_MAIN} into a raw {STORE_GRID}x{STORE_GRID} "
            f"tile store on disk ({T_OOC * store.snapshot_nbytes / 1e9:.2f} GB) in "
            f"{time.perf_counter() - t0:.1f} s")
        cfg = CommuteConfig(eps_rp=1e-3, d=6, q=10, oocore=True, use_gemm_kernel=True)
        det = SequenceDetector(cfg, top_k=TOP_K, device="cuda")
        handles = [store.snapshot(i) for i in ids]
        enable_tracing(fence=True)  # phase seconds are device walls
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_stream_stats()
        m0 = REGISTRY.snapshot()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = det.run(handles)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        disable_tracing()
        met = REGISTRY.delta(m0)
        st = stream_stats().snapshot()
        peak = torch.cuda.max_memory_allocated() / 1e9
        # for the float64 yardstick, after the measurements: snapshot 0's P1
        # from an out-of-core chain build with the run's settings and kernels
        from repro_torch.core.chain import _load, chain_product
        from repro_torch.core.tiles import tile_stream

        op = chain_product(handles[0], cfg.d, schedule=cfg.schedule, dtype=cfg.dtype,
                           deflate=cfg.deflate, fuse_l=cfg.fuse_l, oocore=True,
                           oocore_work=cfg.oocore_dir, oocore_panel_rows=cfg.oocore_panel_rows,
                           tile_codec=cfg.tile_codec, prefetch_depth=cfg.prefetch_depth,
                           use_gemm_kernel=True, device=torch.device("cuda"))
        p1_t0 = tile_stream(_load, op.p1, device=torch.device("cuda")).cpu().double()
        op.release_scratch()
        del op
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    g = N_MAIN // PH_OOC
    # every K step on stream_gemm's tensor-core route, every chi build (n = 17) on its skinny one
    want = {name: 0 for name in counts} | {
        "edge_projection": T_OOC * STORE_GRID, "cad_scores": (T_OOC - 1) * STORE_GRID,
        "stream_gemm": T_OOC * (CHAIN_GEMMS * g * g + g),
        "stream_gemm_tc": T_OOC * CHAIN_GEMMS * g * g,
        "fused_panel_matvec": T_OOC * REFINE_STEPS * g}
    if counts != want:
        fail(f"out-of-core launch counts {counts} != {want}")
    for t, r in enumerate(res.transitions):
        s = r.scores.cpu().numpy()
        s_res = resident["scores"][t]
        if s.shape != (N_MAIN,) or not np.isfinite(s).all():
            fail(f"out-of-core transition {t}: scores not finite of shape ({N_MAIN},)")
        err = float(np.abs(s - s_res).max())
        scale = float(np.abs(s_res).max())
        if err > 1e-3 * scale:
            fail(f"out-of-core transition {t}: max |diff| to the resident run {err:.3e} > "
                 f"1e-3 x max score {scale:.3e}")
        if r.top_idx.tolist() != resident["top_idx"][t]:
            fail(f"out-of-core transition {t}: top-{TOP_K} ids {r.top_idx.tolist()} != resident "
                 f"{resident['top_idx'][t]}")
        srt = np.sort(s_res)[::-1]
        its = "+".join(str(rep.iterations) for rep in r.solve_reports)
        hits = len(set(r.top_idx.tolist()) & event)
        log(f"[oocore] transition {t}->{t + 1}: {res.transition_seconds[t]:.3f} s; solver its "
            f"{its}; max |diff| to the resident run {err:.3e} (tol 1e-3 x max score "
            f"{scale:.3e}); top-{TOP_K} ids equal to the resident run's; score gap at rank "
            f"{TOP_K} {srt[TOP_K - 1] - srt[TOP_K]:.3e}; top-{TOP_K} in event region "
            f"{hits}/{TOP_K}")
    live_cap = 4 * PH_OOC * N_MAIN * 4
    if st["peak_live_bytes"] > live_cap:
        fail(f"stream.peak_live_bytes {st['peak_live_bytes']} > 4 panels ({live_cap})")
    if peak > 0.25 * resident["peak"]:
        fail(f"out-of-core peak device memory {peak:.3f} GB > 25% of the resident run's "
             f"{resident['peak']:.3f} GB")

    # Where the time goes.  Host-clock counters of the run, and two estimates
    # from phase 2: kernel time = launches x per-launch time (the input
    # store's panel launches at their own measured time), H2D time =
    # bytes_h2d / the pinned rate of one panel.
    ms_panel = {r["name"]: r.get("panel_ms") for r in rows}
    kern_s = ((counts["stream_gemm"] - T_OOC * g) * per["kstep_ms"] + T_OOC * g * per["chi_ms"]
              + counts["fused_panel_matvec"] * per["matvec_ms"]
              + counts["edge_projection"] * ms_panel["edge_projection"]
              + counts["cad_scores"] * ms_panel["cad_scores"]) / 1e3
    h2d_s = st["bytes_h2d"] / (per["h2d_pinned_fp32"]["gb_s"] * 1e9)
    split = {
        "run_wall_s": wall,
        **{f"phase_{p}_s": met.get(f"phase.{p}.seconds", 0.0)
           for p in ("chain", "ingest", "solve", "score")},
        "d2h_and_sync_wait_s": met.get("oochain.d2h_seconds", 0.0),
        "store_write_s": met.get("oochain.store_write_seconds", 0.0),
        "pinned_staging_copy_s": met.get("pipeline.pin_copy_seconds", 0.0),
        "producer_fetch_s": met.get("pipeline.producer_fetch_seconds", 0.0),
        "consumer_wait_s": met.get("pipeline.consumer_wait_seconds", 0.0),
        "kernels_est_s": kern_s,
        "h2d_est_s": h2d_s,
    }
    from repro_torch.kernels import stream_gemm as sg

    gemm_scratch = sg.scratch_elems(PH_OOC, N_MAIN, PH_OOC) * 4.0
    log(f"[oocore] n={N_MAIN} T={T_OOC} d={cfg.d} q={cfg.q} k={K_MAIN}, store grid "
        f"{STORE_GRID}, scratch panels {PH_OOC} rows (host RAM, raw): run wall {wall:.3f} s; "
        f"launches {counts} (stream_gemm: {counts['stream_gemm_tc']} K steps on the tensor-core "
        f"route, {counts['stream_gemm'] - counts['stream_gemm_tc']} chi builds on the skinny "
        f"one); peak device memory {peak:.3f} GB ({peak / resident['peak']:.1%} of the resident "
        f"run's {resident['peak']:.2f} GB; it holds stream_gemm's per-GEMM scratch of "
        f"{gemm_scratch / 1e6:.1f} MB); stream.peak_live_bytes "
        f"{st['peak_live_bytes'] / 1e6:.1f} MB (cap {live_cap / 1e6:.1f} MB; panels only)")
    log(f"[oocore] stream bytes: read {st['bytes_read'] / 1e9:.2f} GB from the stores, decoded "
        f"{st['bytes_decoded'] / 1e9:.2f} GB, H2D {st['bytes_h2d'] / 1e9:.2f} GB in "
        f"{st['panels']} panels ({st['bytes_h2d_saved'] / 1e9:.2f} GB saved by stored-form "
        f"shipping)")
    log("[oocore] time split (s, host clock unless marked): " + ", ".join(
        f"{k[:-2]} {v:.3f}" for k, v in split.items())
        + " (kernels_est and h2d_est are estimates from phase 2's per-launch times and pinned "
          "rate; d2h_and_sync_wait includes the wait for the kernels and copies queued before "
          "each .cpu(); producer_fetch runs on the prefetch thread, overlapped)")
    yard = (p1_t0, res.transitions[0].scores.cpu().double())
    return {"counts": counts, "wall": wall, "peak_gb": peak, "gemm_scratch_bytes": gemm_scratch,
            "stream": st, "split": split}, yard


def phase_oocore_end_to_end(torch) -> None:
    """The out-of-core pipeline at n=1536 with the bf16 codec: card against CPU."""
    from repro_torch.core import CommuteConfig, SequenceDetector
    from repro_torch.graphs import climate_snapshot_sequence, store_snapshot_sequence
    from repro_torch.store import TileStore

    cfg = CommuteConfig(eps_rp=1e-3, d=6, q=10, oocore=True, tile_codec="bf16",
                        use_gemm_kernel=True)
    store = TileStore.create(None, n=1536, grid=STORE_GRID, codec="bf16")
    ids = store_snapshot_sequence(store, climate_snapshot_sequence(32, 48, t_steps=3,
                                                                   device="cpu"))
    out = {dev: SequenceDetector(cfg, top_k=TOP_K, device=dev).run(store.snapshot(i) for i in ids)
           for dev in ("cuda", "cpu")}
    check_card_vs_cpu("out-of-core bf16 n=1536", out["cuda"], out["cpu"])


def phase_query_kernel(torch, rows: list) -> dict:
    """panel_topk_update at the query path's shapes: q=1, one 144 x 17 panel,
    topk 20 and 300 (> 2 x 144), raw and corrected, largest and smallest
    with an excluded id, fp32 and bf16 bits, from a running state of an
    earlier panel.  Each form's device time per launch
    comes from a torch.profiler trace; the host's cost of a call is timed
    apart, for the one-panel wrapper and for a query's merger step.  Returns
    the device times per launch by (topk, corrected, largest, bits)."""
    from repro_torch.kernels import emb_query as eq
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    ph, k, row0 = PH_QUERY, K_MAIN, 5 * PH_QUERY
    zq = torch.randn((1, k), generator=g, device=dev)
    zp, zp_prev = (torch.randn((ph, k), generator=g, device=dev) for _ in range(2))
    zp[77] = zp[12]  # an exact tie inside the panel
    idq = torch.rand((1, 1), generator=g, device=dev) + 0.1
    idp = torch.rand((1, ph), generator=g, device=dev) + 0.1
    ex = torch.tensor([[row0 + 40]], dtype=torch.int32, device=dev)
    vol, tol = 5.5e4, 1e-5
    variants, per = [], {}
    for topk in (20, 300):
        for largest in (True, False):
            for corrected in (False, True):
                for bits in (False, True):
                    panel = host_bits(torch, zp) if bits else zp
                    kw = dict(topk=topk, corrected=corrected, largest=largest)
                    v0, i0 = eq.topk_init(1, topk, largest=largest, device=dev)
                    v0, i0 = ref.panel_topk_update(v0, i0, zq, zp_prev, idq, idp, vol, 0, ex, **kw)
                    args = (v0.contiguous(), i0.contiguous(), zq, panel, idq, idp, vol, row0, ex)
                    case = (f"topk={topk} {'largest' if largest else 'smallest'} "
                            f"{'corrected' if corrected else 'raw'} {'bf16 bits' if bits else 'fp32'}")
                    name = f"panel_topk_update q=1, Z {ph}x{k}, {case}"
                    gv, gi = eq.panel_topk_update(*args, **kw)
                    pv, pi = ref.panel_topk_update(*args, **kw)
                    if not torch.equal(gi, pi):
                        fail(f"{name}: ids differ from the plain version")
                    fin = torch.isfinite(pv)
                    if not torch.equal(torch.isfinite(gv), fin):
                        fail(f"{name}: empty slots differ from the plain version")
                    err, scale = check_close(name, gv[fin], pv[fin], tol)
                    again = eq.panel_topk_update(*args, **kw)
                    if not (torch.equal(again[0], gv) and torch.equal(again[1], gi)):
                        fail(f"{name}: two runs on the same input differ")
                    real = [i for i in gi[0].tolist() if i >= 0]
                    if len(real) != len(set(real)) or row0 + 40 in gi[fin].tolist():
                        fail(f"{name}: an id repeats or the excluded id has a finite score")
                    if bits:
                        dec = eq.panel_topk_update(*args[:3], host_decoded(torch, panel), *args[4:],
                                                   **kw)
                        if not (torch.equal(dec[0], gv) and torch.equal(dec[1], gi)):
                            fail(f"{name}: the in-kernel decode differs from host-decoded fp32")
                    call = lambda: eq.panel_topk_update(*args, **kw)  # noqa: E731
                    wrapper_ms = host_ms(torch, call, reps=200)
                    events_ms = time_ms(torch, call, reps=200, warmup=5)
                    dev_ms = kernel_device_ms(torch, call, 50, ("panel_topk",))
                    if dev_ms is None:
                        fail(f"{name}: the profiler trace holds no panel_topk kernel")
                    # a query's step: the merger (checked once) takes one more panel
                    merger = eq.PanelTopk(zq, idq, idp, ex, vol,
                                          panel_rows=ph, inv_deg_row0=row0, **kw)
                    step_ms = host_ms(torch, lambda: merger.update(panel, row0), reps=200)
                    plain = time_ms(torch, lambda: ref.panel_topk_update(*args, **kw), reps=50)
                    moved = nbytes(*args[:6], ex) + nbytes(v0, i0)  # inputs, then the state out
                    bms, by = bound_ms(4.0 * ph * k + 6.0 * ph, moved)
                    per[(topk, corrected, largest, bits)] = dev_ms
                    variants.append(dict(case=case, max_abs_err=err,
                                         max_abs_plain=scale, ms=dev_ms, device_ms=dev_ms,
                                         host_ms_per_call=wrapper_ms,
                                         merger_host_ms_per_panel=step_ms,
                                         events_ms_back_to_back=events_ms, plain_ms=plain,
                                         bound_ms=bms, bound_by=by, decode_bitwise=bits or None))
                    log(f"[kernels] {name}: ids equal, max_abs_err {err:.3e} "
                        f"(tol {tol:g} x max|plain| {scale:.3e}), bitwise repeatable{', decode bitwise' if bits else ''}; device "
                        f"{fmt_ms(dev_ms)} a launch; host {wrapper_ms:.4f} ms a wrapper call, "
                        f"{step_ms:.4f} ms a merger step (back to back by events {events_ms:.4f} "
                        f"ms); plain {plain:.4f} ms, bound {bms:.2e} ms ({by})")
    v0 = variants[0]
    rows.append(dict(
        name="panel_topk_update", route="cuda", source="src/repro_torch/kernels/csrc/emb_query.cu",
        replaces="src/repro/kernels/emb_query.py:131", max_abs_err=v0["max_abs_err"], ms=v0["ms"],
        plain_ms=v0["plain_ms"], bound_ms=v0["bound_ms"], bound_by=v0["bound_by"], library_ms=None,
        tolerance=f"{tol:g} x max|plain|, ids equal", max_abs_plain=v0["max_abs_plain"],
        shape=f"q=1, Z {ph}x{k} fp32, {v0['case']}", device_ms=v0["device_ms"],
        ms_is="device time (torch.profiler)",
        host_ms_per_call=v0["host_ms_per_call"],
        merger_host_ms_per_panel=v0["merger_host_ms_per_panel"],
        variants=variants))
    return per


def _brute_force(z64: "np.ndarray", h, node, k: int, corrected: bool):
    """float64 scores over the stored Z, the query's own order, and the
    magnitude of the terms the kernel's fp32 three-term form cancels."""
    import numpy as np

    inv = h.inv_deg().astype(np.float64)
    if node is None:
        zq = h.zbar.astype(np.float64)
        inv_q = float(np.asarray([h.inv_deg().mean()], np.float32)[0])
    else:
        zq, inv_q = z64[node], inv[node]
    d2 = ((z64 - zq) ** 2).sum(1)
    s = d2 - inv_q - inv if corrected else h.vol * d2
    if node is not None:
        s[node] = np.inf
    order = np.argsort(s if node is not None else -s, kind="stable")[:k]
    terms = (zq @ zq + (z64[order] ** 2).sum(1).max()) * (1.0 if corrected else h.vol)
    return s, order, terms


def _run_queries(torch, tag: str, handles: dict, per: dict, device: str) -> list:
    from repro_torch.core import nearest_neighbors, top_anomalies_from_store

    out = []
    for codec, h in handles.items():
        for label, k, corrected, node in QUERIES:
            if node is None:
                res = top_anomalies_from_store(h, k, corrected=corrected, device=device)
            else:
                res = nearest_neighbors(h, node, k, corrected=corrected, device=device)
            est = res.panels * per[(k, corrected, node is None, codec == "bf16")] / 1e3
            out.append(dict(tag=tag, codec=codec, query=label, k=k, corrected=corrected, node=node,
                            res=res, kernel_est_s=est))
    return out


def _check_queries(tag: str, card: list, cpu: list, z64: dict, handles: dict) -> None:
    """Card ids and values against the float64 brute force and the CPU run:
    ids equal except where the brute-force scores tie within the tolerance;
    values within 1e-4 of the larger of the largest value and the cancelled terms."""
    import numpy as np

    for c, p in zip(card, cpu):
        h, res = handles[c["codec"]], c["res"]
        s, order, terms = _brute_force(z64[c["codec"]], h, c["node"], c["k"], c["corrected"])
        name = f"[query] {tag} {c['codec']} {c['query']}"
        got = res.idx.astype(np.int64)
        if got.min() < 0 or len(set(got.tolist())) != got.size or got.size != c["k"]:
            fail(f"{name}: ids missing or repeated")
        want = s[order]
        scale = max(float(np.abs(want).max()), float(terms))
        tol = 1e-4 * scale
        err = float(np.abs(res.val - want).max())
        rel = err / float(np.abs(want).max())
        if err > tol:
            fail(f"{name}: max |value - float64 brute force| {err:.3e} > 1e-4 x {scale:.3e}")
        swaps = [r for r in range(got.size) if got[r] != order[r]]
        if any(abs(s[got[r]] - s[order[r]]) > tol for r in swaps):
            fail(f"{name}: ids differ from the brute force beyond a tie: ranks {swaps[:5]}")
        cpu_ids = p["res"].idx.astype(np.int64)
        cpu_swaps = [r for r in range(got.size) if got[r] != cpu_ids[r]]
        cpu_err = float(np.abs(res.val - p["res"].val).max())
        if cpu_err > tol or any(abs(s[got[r]] - s[cpu_ids[r]]) > tol for r in cpu_swaps):
            fail(f"{name}: card and CPU differ (max |diff| {cpu_err:.3e}, ranks {cpu_swaps[:5]})")
        c.update(max_abs_err=err, rel_err=rel, tol=tol, brute_swaps=len(swaps),
                 cpu_swaps=len(cpu_swaps), cpu_max_abs_diff=cpu_err)


def phase_query(torch, resident: dict, per: dict) -> dict:
    """The query read path: publish from the resident write path, then query."""
    import gc
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import (
        CommuteConfig,
        SequenceDetector,
        reset_stream_stats,
        stream_stats,
        top_anomalies_from_store,
    )
    from repro_torch.graphs import climate_snapshot_sequence
    from repro_torch.obs import REGISTRY
    from repro_torch.store import DEFAULT_PREFETCH_DEPTH, EmbeddingStore

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="smoke_emb_", dir=ROOT / "build"))
    out: dict = {}

    def query_window(tag: str, handles: dict, panels: int, panel_bytes: int) -> list:
        """Warm up, then the card's queries with the counts zeroed just before."""
        top_anomalies_from_store(handles["raw"], 20, device="cuda")  # stream / pinned set-up
        torch.cuda.synchronize()
        reset_stream_stats()
        m0 = REGISTRY.snapshot()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        card = _run_queries(torch, tag, handles, per, "cuda")
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        met = REGISTRY.delta(m0)
        st = stream_stats().snapshot()
        n_q = len(card)
        want = {name: 0 for name in counts} | {"panel_topk_update": n_q * panels}
        if counts != want:
            fail(f"{tag} query launch counts {counts} != {want}")
        cap = DEFAULT_PREFETCH_DEPTH * panel_bytes
        if st["peak_live_bytes"] > cap:
            fail(f"{tag}: stream.peak_live_bytes {st['peak_live_bytes']} > prefetch depth x one "
                 f"raw Z panel ({cap})")
        cpu = _run_queries(torch, tag, handles, per, "cpu")
        z64 = {c: h.to_numpy().astype(np.float64) for c, h in handles.items()}
        _check_queries(tag, card, cpu, z64, handles)
        for c, p in zip(card, cpu):
            r = c["res"]
            log(f"[query] {tag} {c['codec']} {c['query']}: {r.latency_ms:.2f} ms on the card "
                f"(CPU {p['res'].latency_ms:.2f} ms), {r.panels} panels, {r.bytes_read} B read; "
                f"ids equal to the float64 brute force ({c['brute_swaps']} tie swaps) and the CPU's "
                f"({c['cpu_swaps']}); max |value err| {c['max_abs_err']:.3e} ({c['rel_err']:.2e} of "
                f"the largest value; tol {c['tol']:.3e})")
        split = {
            "queries": n_q, "wall_s": wall,
            "phase_query_s": met.get("phase.query.seconds", 0.0),
            "pinned_staging_copy_s": met.get("pipeline.pin_copy_seconds", 0.0),
            "consumer_wait_s": met.get("pipeline.consumer_wait_seconds", 0.0),
            "producer_fetch_s": met.get("pipeline.producer_fetch_seconds", 0.0),
            "kernels_est_s": sum(c["kernel_est_s"] for c in card),
        }
        stores = {id(h.store): h.store for h in handles.values()}.values()
        maps = {"kept": sum(s._n_maps for s in stores),
                "limit_per_store": handles["raw"].store.maps_limit}
        log(f"[query] {tag}: {n_q} queries, launches {counts['panel_topk_update']} "
            f"(= {n_q} x {panels}); "
            f"stream.peak_live_bytes {st['peak_live_bytes']} (cap {cap}); "
            f"bytes read {st['bytes_read']}, H2D {st['bytes_h2d']}; time split (s, host clock): "
            + ", ".join(f"{k[:-2]} {v:.4f}" for k, v in split.items() if k.endswith("_s"))
            + " (kernels_est: panels x phase-2 device ms a launch; producer_fetch: the panel "
            "reads, on the consumer's thread); kept "
            f"panel maps {maps['kept']} (limit {maps['limit_per_store']} a store)")
        out[tag] = {"counts": counts, "stream": st, "split": split, "panel_maps": maps,
                    "queries": [{**{k: v for k, v in c.items() if k != "res"},
                                 "latency_ms": c["res"].latency_ms, "panels": c["res"].panels,
                                 "bytes_read": c["res"].bytes_read,
                                 "cpu_latency_ms": p["res"].latency_ms}
                                for c, p in zip(card, cpu)]}
        return card

    try:
        cfg = CommuteConfig(eps_rp=1e-3, d=6, q=10)
        raw = EmbeddingStore.create(tmp / "raw", n=N_MAIN, k=K_MAIN, seed=cfg.seed,
                                    meta={"dataset": "climate", "n": N_MAIN, "seed": 0})
        if raw.panel_rows != PH_QUERY:
            fail(f"default panel rows at n={N_MAIN} is {raw.panel_rows}, expected {PH_QUERY}")
        seq = climate_snapshot_sequence(73, 144, t_steps=3, device="cuda")
        torch.cuda.synchronize()
        m0 = REGISTRY.snapshot()
        kernels.reset_launch_counts()
        res = SequenceDetector(cfg, top_k=TOP_K, device="cuda", emb_store=raw).run(seq.snapshots())
        torch.cuda.synchronize()
        counts_w = kernels.launch_counts()
        met = REGISTRY.delta(m0)
        if counts_w != resident["counts"]:
            fail(f"publishing write path launch counts {counts_w} != phase 3's {resident['counts']}")
        if raw.embedding_ids != ["t0000", "t0001", "t0002"]:
            fail(f"published artifacts {raw.embedding_ids}")
        if [r.top_idx.tolist() for r in res.transitions] != resident["top_idx"]:
            fail("the publishing run's top-20 ids differ from phase 3's")
        last = raw.latest()
        bf = EmbeddingStore.create(tmp / "bf16", n=N_MAIN, k=K_MAIN, codec="bf16", seed=cfg.seed)
        bf.put_embedding(last.emb_id, last.to_numpy(), last.vol, last.deg, zbar=last.zbar)
        pub = met.get("phase.publish.seconds", 0.0)
        log(f"[query] write path with publishing: transitions "
            f"{', '.join(f'{t:.3f}' for t in res.transition_seconds)} s (phase 3: "
            f"{', '.join(f'{t:.3f}' for t in resident['seconds'])} s); 3 artifacts of "
            f"{N_MAIN}x{K_MAIN} in {N_MAIN // PH_QUERY} panels published in {pub:.3f} s; launches "
            f"as phase 3; top-{TOP_K} ids as phase 3")
        out["write"] = {"transition_seconds": res.transition_seconds, "publish_s": pub}
        del seq, res
        gc.collect()
        torch.cuda.empty_cache()

        handles = {"raw": last, "bf16": bf.latest()}
        card = query_window("n=10512", handles, N_MAIN // PH_QUERY, PH_QUERY * K_MAIN * 4)
        # The bar takes the median of five raw top-20 queries: the window's and
        # four more, since the host's share of a query varies from call to call.
        q20s = [next(c["res"].latency_ms for c in card
                     if c["codec"] == "raw" and c["query"] == "top raw k=20")]
        q20s += [top_anomalies_from_store(last, 20, device="cuda").latency_ms for _ in range(4)]
        q20 = sorted(q20s)[2]
        t_res = min(resident["seconds"])
        log(f"[query] n={N_MAIN}: raw top-20 query, median of {', '.join(f'{t:.2f}' for t in q20s)} "
            f"ms: {q20:.2f} ms against a resident transition {t_res * 1e3:.1f} ms (phase 3, "
            f"fastest): {t_res * 1e3 / q20:.1f}x (bar: 10x)")
        if t_res * 1e3 < 10.0 * q20:
            fail(f"raw top-20 query {q20:.2f} ms (median of five) is not 10x faster than a "
                 f"transition ({t_res * 1e3:.1f} ms)")
        out["read_write_ratio"] = t_res * 1e3 / q20
        out["raw_top20_latencies_ms"] = q20s

        t0 = time.perf_counter()
        rng = np.random.default_rng(0)
        z = rng.standard_normal((N_LARGE, K_LARGE), dtype=np.float32)
        deg = rng.uniform(0.5, 2.0, N_LARGE).astype(np.float32)
        large = {}
        for codec in ("raw", "bf16"):
            st = EmbeddingStore.create(tmp / f"large_{codec}", n=N_LARGE, k=K_LARGE, codec=codec)
            if st.panel_rows != PH_LARGE:
                fail(f"default panel rows at n={N_LARGE} is {st.panel_rows}, expected {PH_LARGE}")
            large[codec] = st.put_embedding("t0000", z, float(deg.sum(dtype=np.float64)), deg)
        log(f"[query] n={N_LARGE} (360 x 720), k={K_LARGE}: wrote a raw ({z.nbytes / 1e6:.1f} MB) "
            f"and a bf16 ({z.nbytes / 2e6:.1f} MB) artifact of {N_LARGE // PH_LARGE} panels in "
            f"{time.perf_counter() - t0:.1f} s")
        query_window(f"n={N_LARGE}", large, N_LARGE // PH_LARGE, PH_LARGE * K_LARGE * 4)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_lm_kernels(torch, rows: list) -> dict:
    """wkv and flash_attention at the serve path's prefill shapes (batch 4,
    prompt 1024).  Returns per-launch times (ms) for the split of phase 8."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv as wk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # -- wkv: rwkv6-3b's prefill, B*H = 4 x 40 heads of 64, S = 1024
    bh, s, dh = SERVE_BATCH * 40, SERVE_PROMPT, 64
    tol_b, tol_f = 2.0**-7, 1e-4  # bf16 y: two bf16 steps; fp32 y and every state: 1e-4
    r, k, v = (randn(bh, s, dh, dtype=bf16) for _ in range(3))
    lw = -torch.exp(randn(bh, s, dh) * 0.5 - 6.0)  # the init's decays (w_base = -6)
    u = 0.1 * randn(bh, dh)
    name = f"wkv ({bh},{s},{dh}) bf16"
    y, st = wk.wkv(r, k, v, lw, u, return_state=True)
    wy, wst = ref.wkv(r, k, v, lw, u, return_state=True)
    check = check_close(f"{name} y", y, wy, tol_b)
    st_err, _ = check_close(f"{name} s_final", st, wst, tol_f)
    check_bitwise(torch, name, lambda: torch.cat([t.float().flatten() for t in wk.wkv(
        r, k, v, lw, u, return_state=True)]))
    forms = {}
    s0 = randn(bh, dh, dh)
    for form, args, kw in (
        ("fp32, s0 in", [t.float() for t in (r, k, v)] + [lw, u], {"s0": s0}),
        ("bf16 ragged S=1000", [t[:, :1000].contiguous() for t in (r, k, v, lw)] + [u], {}),
    ):
        got = wk.wkv(*args, return_state=True, **kw)
        want = ref.wkv(*args, return_state=True, **kw)
        tol = tol_f if args[0].dtype == f32 else tol_b
        e_y, _ = check_close(f"wkv {form} y", got[0], want[0], tol)
        e_s, _ = check_close(f"wkv {form} s_final", got[1], want[1], tol_f)
        check_bitwise(torch, f"wkv {form}", lambda: wk.wkv(*args, **kw))
        forms[form] = {"y_err": e_y, "s_final_err": e_s, "tol_y": tol}
        log(f"[kernels] wkv {form}: y max_abs_err {e_y:.3e} (tol {tol:g} x max|plain|), "
            f"s_final {e_s:.3e} (tol {tol_f:g}), bitwise repeatable")
    # strong decays (tests/test_kernels.py's lw = -exp(0.5 N - 1)) against the
    # per-step oracle, |err| <= 1e-3 + 1e-3 |oracle| as that test asks
    for shape in ((3, 64, 16), (3, 96, 16), (3, 128, 16), (bh, s, dh)):
        a = [randn(*shape) for _ in range(3)] + [-torch.exp(randn(*shape) * 0.5 - 1.0)]
        uu = 0.1 * randn(shape[0], shape[2])
        got, want = wk.wkv(*a, uu), ref.wkv(*a, uu)
        excess = float(((got - want).abs() - 1e-3 - 1e-3 * want.abs()).max())
        if not excess <= 0.0:
            fail(f"wkv at strong decay {shape}: exceeds 1e-3 + 1e-3|oracle| by {excess:.3e}")
        forms[f"strong decay {shape}"] = {"max_abs_err": float((got - want).abs().max())}
    log(f"[kernels] wkv at strong decay (lw = -exp(0.5 N - 1)), shapes (3,64|96|128,16) and "
        f"({bh},{s},{dh}) fp32: within 1e-3 + 1e-3 |oracle| of the per-step recurrence")
    ms = time_ms(torch, lambda: wk.wkv(r, k, v, lw, u, return_state=True), reps=20)
    dev_ms = kernel_device_ms(torch, lambda: wk.wkv(r, k, v, lw, u, return_state=True), 20,
                              ("wkv_",))
    plain = time_ms(torch, lambda: ref.wkv(r, k, v, lw, u, return_state=True), reps=1)
    # operations on fp32 FFMA, per token and head: y = r.S (2 dk dv) and
    # S <- w S + k v^T (2 dk dv); exponentials: the function needs three per row
    # and channel (r to the row before, k from the chunk start, k to the chunk
    # end), as the TPU kernel computes them
    exps = 3.0 * bh * s * dh
    log(f"[kernels] wkv ({bh},{s},{dh}) bf16: {ms:.4f} ms (device {fmt_ms(dev_ms)}) as three "
        f"launches; {exps / 1e6:.1f}M exponentials at the SFUs' "
        f"{PEAK_SFU_OPS / 1e12:g} T/s in the bound")
    rows.append(kernel_row(
        "wkv", "wkv.cu", "src/repro/kernels/wkv.py:71", f"({bh},{s},{dh}) r/k/v bf16, lw fp32",
        check, tol_b, ms, plain, 4.0 * bh * s * dh * dh,
        nbytes(r, k, v, lw, u, y, st), None, sfu_ops=exps, device_ms=dev_ms,
        kernel_route="chunk-parallel scan (state, scan, outputs) on fp32 FFMA",
        s_final_err=st_err, forms=forms))

    # -- flash_attention: qwen2-1.5b's prefill, 4 x 12 q heads over 4 x 2 KV heads of 128
    nkv, grp, d = SERVE_BATCH * 2, 6, 128
    q = randn(nkv * grp, s, d, dtype=bf16)
    kk, vv = randn(nkv, s, d, dtype=bf16), randn(nkv, s, d, dtype=bf16)
    name = f"flash_attention q ({nkv * grp},{s},{d}) k/v ({nkv},{s},{d}) bf16 causal"

    def route(fn):  # which route a call took, from the tensor-core counter
        before = fa.wgmma_launches
        out = fn()
        return out, "wgmma" if fa.wgmma_launches > before else "simt"

    main_out, main_route = route(lambda: fa.flash_attention(q, kk, vv, groups=grp))
    if main_route != "wgmma":
        fail(f"{name}: took the {main_route} route, want the tensor-core (wgmma) route")
    check = check_close(name, main_out, ref.flash_attention(q, kk, vv, groups=grp), tol_b)
    check_bitwise(torch, name, lambda: fa.flash_attention(q, kk, vv, groups=grp))
    fforms = {}
    for form, args, causal, tol, want_route in (
        ("bf16 non-causal", (q, kk, vv), False, tol_b, "wgmma"),
        ("bf16 causal ragged S=1000", tuple(t[:, :1000].contiguous() for t in (q, kk, vv)),
         True, tol_b, "wgmma"),
        ("bf16 causal D=64", tuple(t[..., :64].contiguous() for t in (q, kk, vv)), True, tol_b,
         "wgmma"),
        ("fp32 causal", tuple(t.float() for t in (q, kk, vv)), True, tol_f, "simt"),
    ):
        got, took = route(lambda: fa.flash_attention(*args, causal=causal, groups=grp))
        if took != want_route:
            fail(f"flash_attention {form}: took the {took} route, want {want_route}")
        err, _ = check_close(f"flash_attention {form}", got,
                             ref.flash_attention(*args, causal=causal, groups=grp), tol)
        check_bitwise(torch, f"flash_attention {form}",
                      lambda: fa.flash_attention(*args, causal=causal, groups=grp))
        fforms[form] = {"max_abs_err": err, "tol": tol, "route": took}
        log(f"[kernels] flash_attention {form}: {took} route; max_abs_err {err:.3e} (tol {tol:g} "
            f"x max|plain|), bitwise repeatable")
    ms_f = time_ms(torch, lambda: fa.flash_attention(q, kk, vv, groups=grp), reps=20)
    plain_f = time_ms(torch, lambda: ref.flash_attention(q, kk, vv, groups=grp), reps=3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (t.view(SERVE_BATCH, -1, s, d) for t in (q, kk, vv))
    lib = time_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=True, enable_gqa=True), reps=20)
    # the SIMT kernel (the earlier design, now the fp32 route) on the same bf16
    # inputs, through the library entry the wrapper no longer sends bf16 D=128 to
    simt_out = torch.empty_like(q)
    lib_fn = _build.library().rt_flash_attention

    def simt():
        _build.check(lib_fn(q.data_ptr(), kk.data_ptr(), vv.data_ptr(), simt_out.data_ptr(),
                            nkv * grp, s, s, d, grp, 1, 1.0 / d**0.5, 1,
                            _build.stream_handle(q)), "flash_attention SIMT")

    simt_ms = time_ms(torch, simt, reps=20)
    simt_err, _ = check_close(f"{name} (SIMT kernel)", simt_out, main_out, tol_b)
    log(f"[kernels] {name}: wgmma route {ms_f:.4f} ms, SDPA {lib:.4f} ms ({ms_f / lib:.2f}x), "
        f"the SIMT kernel on the same inputs {simt_ms:.4f} ms (its output within {simt_err:.3e} "
        f"of the wgmma route's)")
    pairs = nkv * grp * s * (s + 1) / 2  # the causal (q, k) pairs these inputs need
    rows.append(kernel_row(
        "flash_attention", "flash_attention.cu", "src/repro/kernels/flash_attention.py:70",
        f"q ({nkv * grp},{s},{d}) k/v ({nkv},{s},{d}) bf16 causal, groups {grp}", check, tol_b,
        ms_f, plain_f, 4.0 * d * pairs, nbytes(q, kk, vv, q), lib, peak_ops=PEAK_BF16_OPS,
        forms=fforms, library_call="scaled_dot_product_attention(is_causal, enable_gqa)",
        kernel_route="wgmma (bf16, D in {64, 128}); SIMT for fp32 and other D",
        simt_kernel_ms=simt_ms))
    return {"wkv_ms": ms, "flash_attention_ms": ms_f}


def device_split(torch, fn) -> dict:
    """Device time of one call of ``fn`` by kernel family, from a torch.profiler
    trace: our two LM kernels, cuBLAS products, and the rest; ``busy`` is the
    union of kernel intervals over the host wall of the call.  Empty when the
    trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return {}
    split = {"wkv": 0.0, "flash_attention": 0.0, "matmul": 0.0, "other": 0.0}
    busy, cur_s, cur_e = 0.0, None, None
    for start, end, name in spans:
        low = name.lower()
        fam = ("wkv" if "wkv_" in low else "flash_attention" if "flash_kernel" in low
               else "matmul" if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass"))
               else "other")
        split[fam] += (end - start) / 1e3
        if cur_e is None or start > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    busy = (busy + cur_e - cur_s) / 1e3
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "kernels": len(spans), **{f"{k}_ms": v for k, v in split.items()}}


def fmt_split(sp: dict) -> str:
    if not sp:
        return "device split not measured (the trace held no device events)"
    return (f"device busy {sp['busy_ms']:.1f} of {sp['wall_ms']:.1f} ms (idle "
            f"{100 * sp['idle_share']:.1f}%), {sp['kernels']} kernels: matmul "
            f"{sp['matmul_ms']:.1f} ms, wkv {sp['wkv_ms']:.1f}, flash_attention "
            f"{sp['flash_attention_ms']:.1f}, other {sp['other_ms']:.1f}")


def phase_serve(torch, per: dict) -> dict:
    """Both models at full width and depth: generate, exact launch counts, then
    card vs CPU at depth 2 in fp32."""
    import gc

    import numpy as np

    from repro_torch import configs, kernels
    from repro_torch.models import lm
    from repro_torch.serving import ServeConfig, ServeEngine

    out = {}
    for arch, kname in SERVE_MODELS:
        cfg = configs.get_config(arch)
        spec = lm.build_spec(cfg)
        t0 = time.perf_counter()
        params = lm.init_params(spec, seed=0, device="cuda")
        s_max = SERVE_PROMPT + SERVE_NEW
        eng = ServeEngine(spec, params, s_max=s_max, batch=SERVE_BATCH,
                          cfg=ServeConfig(max_new_tokens=SERVE_NEW), device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab, size=(SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
        eng.generate(prompts[:, :64])  # warm-up: cuBLAS handles and workspaces
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # what the first full-size generate spends besides the work: the
        # allocator's new segments (cudaMalloc) and the host's garbage collector
        gc_t = {"s": 0.0, "n": 0, "t0": 0.0}

        def on_gc(ph, _info):
            if ph == "start":
                gc_t["t0"] = time.perf_counter()
            else:
                gc_t["s"] += time.perf_counter() - gc_t["t0"]
                gc_t["n"] += 1

        mem0 = torch.cuda.memory_stats()
        gc.callbacks.append(on_gc)
        kernels.reset_launch_counts()
        try:
            toks = eng.generate(prompts)
        finally:
            gc.callbacks.remove(on_gc)
        counts = kernels.launch_counts()
        mem1 = torch.cuda.memory_stats()
        peak = torch.cuda.max_memory_allocated() / 1e9
        st = eng.stats
        toks2 = eng.generate(prompts)  # the same requests again: nothing left to grow
        first = {"ttft_ms": st.ttft_s * 1e3, "second_ttft_ms": eng.stats.ttft_s * 1e3,
                 "second_tokens_equal": bool(np.array_equal(toks2, toks)),
                 "segments_allocated": mem1.get("segment.all.allocated", 0)
                 - mem0.get("segment.all.allocated", 0),
                 "reserved_gb_added": (mem1.get("reserved_bytes.all.current", 0)
                                       - mem0.get("reserved_bytes.all.current", 0)) / 1e9,
                 "alloc_retries": mem1.get("num_alloc_retries", 0)
                 - mem0.get("num_alloc_retries", 0),
                 "gc_ms": gc_t["s"] * 1e3, "gc_collections": gc_t["n"],
                 "regrow_ttft_ms": [], "regrow_segments": []}
        for _ in range(3):  # the allocator's growth alone: its cache emptied, every shape seen
            torch.cuda.empty_cache()
            seg0 = torch.cuda.memory_stats().get("segment.all.allocated", 0)
            eng.generate(prompts)
            first["regrow_ttft_ms"].append(eng.stats.ttft_s * 1e3)
            first["regrow_segments"].append(
                torch.cuda.memory_stats().get("segment.all.allocated", 0) - seg0)
        # the attention model's prefill takes the tensor-core route every time
        routes = {"flash_attention_wgmma": cfg.n_layers} if kname == "flash_attention" else {}
        want = {name: 0 for name in counts} | {kname: cfg.n_layers} | routes
        if counts != want:
            fail(f"serve {arch}: launch counts {counts} != {want}")
        if toks.shape != (SERVE_BATCH, SERVE_NEW) or toks.min() < 0 or toks.max() >= cfg.vocab:
            fail(f"serve {arch}: tokens of shape {toks.shape} in [{toks.min()}, {toks.max()}] "
                 f"(want ({SERVE_BATCH}, {SERVE_NEW}) below vocab {cfg.vocab})")
        # prefill alone (its kernel share) and decode alone (no launches)
        tokens = torch.from_numpy(prompts).long().cuda()
        with torch.inference_mode():
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = lm.prefill(spec, eng.params, tokens, s_max)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            c_pre = kernels.launch_counts()
            real = logits[:, : cfg.vocab].float()
            if not bool(torch.isfinite(real).all()):
                fail(f"serve {arch}: prefill logits not finite")
            kernels.reset_launch_counts()
            tok = logits.float().argmax(-1)
            for _ in range(2):
                logits, cache = lm.decode_step(spec, eng.params, tok, cache)
                tok = logits.float().argmax(-1)
            if not bool(torch.isfinite(logits[:, : cfg.vocab].float()).all()):
                fail(f"serve {arch}: decode logits not finite")
            c_dec = kernels.launch_counts()
        if c_pre != {name: 0 for name in c_pre} | {kname: cfg.n_layers} | routes:
            fail(f"serve {arch}: prefill launches {c_pre}, want {kname} {cfg.n_layers}"
                 + (" (all on the tensor-core route)" if routes else ""))
        if sum(c_dec.values()) != 0:
            fail(f"serve {arch}: decode launched kernels {c_dec}")
        # device time by kernel family (torch.profiler), one prefill and one
        # decode step; the idle share is against the unprofiled host walls
        with torch.inference_mode():
            sp_pre = device_split(torch, lambda: lm.prefill(spec, eng.params, tokens, s_max))
            tok = logits.float().argmax(-1)
            sp_dec = device_split(torch, lambda: lm.decode_step(spec, eng.params, tok, cache))
        kern_s = cfg.n_layers * per[f"{kname}_ms"] / 1e3
        step_ms = st.decode_s / st.decode_steps * 1e3
        tok_s = SERVE_BATCH * st.decode_steps / st.decode_s
        n_params = lm.param_count(params)
        log(f"[serve] {arch} ({n_params / 1e9:.3f} B params, {cfg.n_layers} layers, fp32 params, "
            f"{cfg.compute_dtype} compute; init {init_s:.1f} s): batch {SERVE_BATCH} x prompt "
            f"{SERVE_PROMPT}, {SERVE_NEW} greedy tokens: time to first token "
            f"{st.ttft_s * 1e3:.1f} ms; decode {step_ms:.2f} ms/step, {tok_s:.1f} tok/s; peak "
            f"device memory {peak:.2f} GB; launches {kname} {counts[kname]} (prefill "
            f"{c_pre[kname]}, decode 0" + (f"; tensor-core route {c_pre['flash_attention_wgmma']}"
                                           if routes else "") + ")")
        log(f"[serve] {arch} prefill alone {prefill_s * 1e3:.1f} ms: {kname} ~{kern_s * 1e3:.1f} "
            f"ms ({cfg.n_layers} x {per[f'{kname}_ms']:.3f} ms from phase 2, "
            f"{100 * kern_s / prefill_s:.1f}%), the rest ~{(prefill_s - kern_s) * 1e3:.1f} ms")
        log(f"[serve] {arch} time to first token {first['ttft_ms']:.1f} ms (first full-size "
            f"generate: {first['segments_allocated']} new allocator segments, +"
            f"{first['reserved_gb_added']:.2f} GB reserved, {first['alloc_retries']} allocation "
            f"retries; the host's garbage collector {first['gc_ms']:.1f} ms in "
            f"{first['gc_collections']} collections); a second generate of the same requests "
            f"{first['second_ttft_ms']:.1f} ms; after emptying the allocator's cache (the growth "
            f"alone) {', '.join(f'{t:.1f}' for t in first['regrow_ttft_ms'])} ms with "
            f"{', '.join(map(str, first['regrow_segments']))} new segments")
        for what, sp, wall in (("prefill", sp_pre, prefill_s * 1e3), ("decode step", sp_dec, step_ms)):
            if sp:
                sp["idle_share_unprofiled"] = max(0.0, 1.0 - sp["busy_ms"] / wall)
            log(f"[serve] {arch} {what} under torch.profiler: {fmt_split(sp)}"
                + (f"; against the unprofiled {wall:.1f} ms the card is idle "
                   f"{100 * sp['idle_share_unprofiled']:.1f}%" if sp else ""))
        out[arch] = {"counts": counts, "prefill_counts": c_pre, "decode_counts": c_dec,
                     "params": n_params, "init_s": init_s, "ttft_ms": st.ttft_s * 1e3,
                     "decode_ms_per_step": step_ms, "decode_tok_s": tok_s, "peak_gb": peak,
                     "prefill_ms": prefill_s * 1e3, "prefill_kernel_ms_est": kern_s * 1e3,
                     "prefill_device_split": sp_pre, "decode_device_split": sp_dec,
                     "first_generate": first,
                     "first_tokens": toks[0, :8].tolist()}
        del params, eng, logits, cache, tokens
        gc.collect()
        torch.cuda.empty_cache()

        # card vs CPU: full width, depth 2, fp32 compute, a ragged prompt of 100
        spec = lm.build_spec(cfg.replace(n_layers=2, compute_dtype="float32"))
        params = lm.init_params(spec, seed=0, device="cuda")
        prompts = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 100)).astype(np.int32)
        res = {}
        for d in ("cuda", "cpu"):
            eng = ServeEngine(spec, params, s_max=108, cfg=ServeConfig(max_new_tokens=8), device=d)
            toks = eng.generate(prompts)
            with torch.inference_mode():
                lg, _ = lm.prefill(spec, eng.params, torch.from_numpy(prompts).long().to(d), 108)
            res[d] = (toks, lg[:, : cfg.vocab].float().cpu())
            del eng
        if not np.array_equal(res["cuda"][0], res["cpu"][0]):
            fail(f"serve {arch} depth 2: greedy tokens differ between card and CPU: "
                 f"{res['cuda'][0].tolist()} vs {res['cpu'][0].tolist()}")
        err, scale = check_close(f"serve {arch} depth 2 prefill logits", res["cuda"][1],
                                 res["cpu"][1], 1e-3)
        log(f"[serve] {arch} depth 2, fp32, batch 2 x prompt 100, 8 new tokens: greedy tokens "
            f"equal on card and CPU; prefill logits max |diff| {err:.3e} (tol 1e-3 x max|logit| "
            f"{scale:.3e})")
        out[arch]["card_vs_cpu"] = {"tokens_equal": True, "logits_err": err, "max_logit": scale}
        del params, res
        gc.collect()
        torch.cuda.empty_cache()
    return out


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
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    log(f"[build] {len(_build.SOURCES)} sources built with nvcc for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s (cached: {info.get('cached')}; {nvcc}); ptxas: "
        f"registers per kernel {regs}, {spills} bytes of spill stores in all")

    rows: list = []
    phase_kernels(torch, rows)
    per_launch = phase_stream_kernels(torch, rows)
    per_query = phase_query_kernel(torch, rows)
    per_lm = phase_lm_kernels(torch, rows)
    torch.cuda.empty_cache()
    resident = phase_main_path(torch)
    torch.cuda.empty_cache()
    yardstick = phase_chain_yardstick(torch, resident)
    phase_end_to_end(torch)
    oocore, yardstick["out-of-core stream_gemm"] = phase_oocore(torch, rows, resident, per_launch)
    chain64 = report_chain_yardstick(torch, yardstick)
    del yardstick
    phase_oocore_end_to_end(torch)
    torch.cuda.empty_cache()
    query = phase_query(torch, resident, per_query)
    torch.cuda.empty_cache()
    serve = phase_serve(torch, per_lm)
    for row in rows:
        by_path = {"resident": resident["counts"][row["name"]],
                   "oocore": oocore["counts"][row["name"]],
                   "query": query["n=10512"]["counts"][row["name"]],
                   f"query n={N_LARGE}": query[f"n={N_LARGE}"]["counts"][row["name"]]}
        by_path |= {f"serve {arch}": serve[arch]["counts"][row["name"]] for arch, _ in SERVE_MODELS}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        if row["name"] == "flash_attention":
            row["launches_wgmma"] = sum(serve[arch]["counts"]["flash_attention_wgmma"]
                                        for arch, _ in SERVE_MODELS)
        if row["name"] == "stream_gemm":
            row["launches_tc"] = oocore["counts"]["stream_gemm_tc"]
    (OUT / "chip_smoke_oocore.json").write_text(json.dumps(
        {"card": smi, "per_launch": per_launch, **oocore, "chain_float64_yardstick": chain64},
        indent=1))
    (OUT / "chip_smoke_query.json").write_text(json.dumps({"card": smi, **query}, indent=1))
    (OUT / "chip_smoke_serve.json").write_text(json.dumps({"card": smi, **serve}, indent=1))

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
