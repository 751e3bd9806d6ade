#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port of CADDeLaG (one NVIDIA H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi), and the build of the CUDA
   kernels from ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a;
2. each kernel held against its plain PyTorch version on the card at the
   main paths' shapes (``wkv`` and ``flash_attention`` at phase 9's prefill
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
   its earlier (SIMT) design timed on the same inputs, its ``q_offset`` form
   (the seqshard tile: the prompt's second half of queries against all keys)
   against the plain version and the whole sequence's rows, the SHA-256 of
   its other forms' outputs (``scripts/flash_bits.py``), and ``flash_attention``
   at zamba2's shared-block prefill (q/k/v 128 x 1024 x 224 bf16, causal, the
   tensor-core route, its ptxas registers and spills) beside the SIMT kernel
   on the same inputs, SDPA and its bound; then the pinned
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
5. the out-of-core main path: the first two snapshots of the same n=10512
   sequence (one transition) written to a tiled
   on-disk store, scored from it with the chain's working matrices in a
   host-RAM scratch store and the ``stream_gemm`` / ``fused_panel_matvec``
   kernels; exact launch counts of that run alone (every K step on
   ``stream_gemm``'s tensor-core route, every chi build on its skinny one),
   top-20 ids equal to phase 3's, and the device residency bounds;
6. the out-of-core pipeline at n=1536 with the bf16 tile codec, on the card
   and on the CPU: equal top-20 ids and allclose scores;
7. the incremental delta chain (``--incremental-chain``, rank 4, budget 0.1)
   on the slowly drifting GMM sequence of ``tests/test_delta_chain.py`` at
   n=10512 with the main path's d, q and eps: resident over T=4 against a
   full rebuild of the same snapshots (1 rebuild, 3 delta updates, 0
   fallbacks; ``block_matmul`` launched 11 times against 44; each delta's
   logical FLOPs and scratch at most a third of a full build's; its run
   report and Chrome trace written under ``OUT`` and held to the port's
   validators and the registry; scores against the full rebuild's within
   1e-2 of V_G E|z|^2, top-20 overlap at least 18), then out of core over
   T=3 from an on-disk raw store with a host-RAM scratch (exact launch
   counts, scores within rtol 1e-3, atol 1e-3 of V_G E|z|^2 of the
   resident incremental run's, the 4-panel residency cap, an empty scratch
   after ``finalize()``), then n=1536 on the card and on the CPU, resident
   and out of core, drifting and with a fresh GMM draw mid-sequence (equal
   drift decisions and chain counters, one fallback and one rebuild for
   the fresh draw, scores within 1e-2 of the largest, top-20 ids equal but
   for ties within 1e-3 of it);
8. the query read path: phase 3's sequence again, publishing every
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
9. the serve path of the LM substrate: rwkv6-3b and qwen2-1.5b at full
   width and depth (random weights from seed 0, fp32 parameters, bf16
   compute) through ``ServeEngine.generate``, a batch of 4 prompts of 1024
   tokens and 32 greedy new tokens each: time to first token, decode time
   per step, peak device memory, exact launch counts (``wkv`` once per rwkv
   layer and ``flash_attention`` once per attention layer in prefill, all
   on its tensor-core route, no launch in decode), and one prefill and one
   decode step under
   ``torch.profiler`` (device time by kernel family, the card's idle share);
   then each model at depth 2 in fp32 on the card and on the CPU: equal
   greedy tokens and prefill logits within 1e-3 of the largest;
10. the paper's workloads (``[paper]`` lines): (a) the synthetic transition
   of section 4.2.1 (``gmm_graph_sequence``, A1 = P, A2 = Q + (R + R^T)/2,
   about 300 injected node pairs) at n=10512 through ``detect_anomalies``
   with ``CLIMATE.commute`` (exact launch counts, precision@20 against the
   injected truth, seconds and peak memory), and ``estimate_solution`` /
   ``residual_norm`` at q=1 and q=10 on its A1; the same at n=1536 on the
   card and on the CPU (truth, components and injection mask bitwise,
   scores within 1e-3 of the largest, top-20 ids equal but for ties,
   residuals within rel 1e-4 plus fp32's rounding bound for L x - b);
   (b) ``gmm_store_sequence`` writing T=2 snapshots of n=10512 tile by tile
   (every tile of the first within rtol 1e-6, atol 1e-6 of the card's
   ``similarity_graph``), and at n=4096 an out-of-core chain from that
   writer's store, ``estimate_solution`` with ``solver_batch`` 1 and 4
   (bitwise equal, at least 2x fewer scratch reads) and ``residual_norm`` on
   a store-backed L against the resident one; (c) the four
   ``examples/torch_*.py``: top-k ids equal but for ties, card against CPU,
   at their defaults (the telemetry example's CPU run scores the card run's
   report), then climate at 73 x 144, T=4 and election at n=10512, T=3 on
   the card, with their verdict lines;
11. the resident main path on a device grid (``[grid]`` lines; one card
   holds all four tiles of a 2x2 grid, so its times are one card's, not
   multi-GPU ones): (a) ``matmul`` with the ``xla``, ``summa`` and
   ``cannon`` schedules at 10512^2 on phase 2's operands (max |C -
   float64|, exactly 4, 4 and 8 ``block_matmul`` launches, CUDA-event ms
   beside the 1x1 call's), ``summa`` on a 1x2 grid and ``cannon`` refused
   there; (b) ``edge_projection`` on each of the four tiles at its global
   (row0, col0), and ``cad_scores`` on each with the tile's Z rows and Z
   columns, against their plain versions, twice bitwise, and the column
   tiles' sums against the whole-row call; (c) phase 3's sequence on the
   2x2 grid with ``cannon`` and with ``summa``: exact launch counts,
   seconds per transition and peak memory beside phase 3's, scores within
   1e-3 of its largest and top-20 ids equal to its but for ties, and which
   run is nearer the float64 chain; (d) n=1536 on the grid, card against
   the CPU grid; (e) ``caddelag-run-torch --data 2 --model 2`` refused on
   one card, naming the card count;
12. the out-of-core, store-streamed and incremental paths on a device grid
   (``[grid oocore]`` lines; 2x2 tiles on the one card): first the grid
   pipeline's H2D choice (``[h2d]``: a pinned column slice against a
   contiguous pinned tile, and the tile-major host copy), then each of
   its kernels on one panel tile at the shapes (a) gives it, against its
   plain version, twice bitwise, timed; (a) the first two
   snapshots of phase 5's sequence in a raw store of grid 8 (1314-row
   panels), scored out of core on a 2x2 grid with a host-RAM scratch and
   the ``stream_gemm`` kernels: exact launch counts (a K step is 4
   tensor-core launches of (657 x 1314) @ (1314 x 5256); with two column
   shards the chi build and the solve steps run ``stream_gemm``'s skinny
   route per panel tile and ``fused_panel_matvec`` never runs), scores
   within 1e-3 of phase 5's transition 0's largest and top-20 ids equal but
   for ties, wall, phase seconds, peak memory and stream bytes beside phase
   5's; (b) the same snapshots streamed from the store and resident on the
   2x2 grid: degrees, Y and scores bitwise, or their gap; (c) n=1536 card
   grid against CPU grid: the bf16 out-of-core path on a 2x1 grid
   (``fused_panel_matvec`` per row tile; two snapshots), the incremental
   chain on a 2x2 grid resident and out of core over three snapshots
   (phase 7's gates: scores against the full rebuild within
   ``INC_ERR_LIMIT``, top-20 overlap with the one-device delta run at
   least ``INC_OVERLAP_MIN``, card against CPU within
   ``INC_CARD_CPU_RTOL``), an embedding store published from a 2x2 run
   queried raw at top-20 against a brute force;
   (d) ``caddelag-run-torch --device cpu --data 2 --model 2`` with each of
   ``--store``, ``--oocore-chain``, ``--incremental-chain`` and
   ``--emb-store``: top-k equal to the 1x1 run's;
13. the other decoder-only families served (``[serve2]`` lines): granite-3-2b,
   stablelm-1.6b, granite-moe-3b-a800m, zamba2-7b and chameleon-34b at full
   width and depth, deepseek-67b at 50 of its 95 layers and
   llama4-maverick-400b-a17b at 2 of its 48 (one dense layer, one MoE layer
   of 128 experts and the shared expert), random weights from seed 0,
   through ``ServeEngine.generate`` with phase 9's requests: exact launch
   counts (``flash_attention`` once per attention block in prefill, zamba2's
   13 shared-block calls at D=224 and the others all on the tensor-core
   route; none in decode), tokens in range, finite logits,
   time to first token, decode time per step, peak device memory (at most
   76 GB) and the prefill's device split; then each model card against CPU
   in fp32 at full width and depth 2 (zamba2 7, so the shared block runs
   once; llama4 at its SMOKE config): greedy tokens equal, prefill logits
   within 1e-3 of the largest, and each MoE layer's expert ids and kept
   masks equal but for flips between probabilities within 1e-5 (counted);
14. the encoder-decoder family served (``[seamless]`` lines):
   seamless-m4t-medium at full width and depth (12 + 12 layers) through
   ``ServeEngine.generate(prompts, frames)``, phase 9's requests over
   frames (4, 1024, 1024): exact launch counts by route and by (S, T,
   causal) -- the encoder and the cross-attention non-causal, the decoder
   causal, all on the tensor-core route, none in decode -- time to first
   token, decode time per step, peak memory and the prefill's device
   split; a 256-token prompt over the same frames (cross-attention at
   S=256, T=1024); the kernel at both non-causal shapes against its plain
   version; card against CPU in fp32 at 2 + 2 layers, full width, over
   64 frames (tokens equal, logits within 1e-3 of the largest);
15. training (``[train]`` lines) through ``launch.train.train_loop``:
   granite-3-2b at full width and depth (remat, fp32 master weights, bf16
   compute, AdamW, batch 8 x 512, 4 steps), seamless-m4t-medium (2 steps
   with frames) and rwkv6-3b at 4 of 32 layers (2 steps): per-step loss,
   grad norm and ms, tokens/s, peak memory, the step's bound, exact launch
   counts (each kernel twice a layer under remat, through its autograd
   Function); granite's step under ``torch.profiler`` and the attention
   backward's share of a step; each model's first step on the card (bf16)
   against the CPU (fp32) at full width and 2 layers (loss within 2^-7,
   grad norm within 2^-6, relative; rwkv6's grad norm reported: its bf16
   gradient at init is not within rounding of fp32 in the JAX package
   either), and on the card in fp32 against the CPU (both within 1e-3); a
   restart from a checkpoint bitwise equal to the uninterrupted run under
   deterministic algorithms.

16. the dry run (``[dryrun]`` lines) of ``repro_torch.launch.dryrun``: every
   cell of ``--all --mesh both`` (32 archs x shapes on the 16x16 and
   2x16x16 logical grids) and the 16x16 chain cell (n=65536, d=6, three
   schedules) on the meta device, one line a cell with its per-tile bytes
   against 80 GB; granite-3-2b's phase-15 cell at 1x1, its parameter and
   optimizer bytes equal to phase 15's tensors on the card, dot_flops
   against ``_train_bound``'s ops and the activation estimate against the
   card's peak; the 2x2 chain at n=10512 whose moved bytes equal phase 11's
   counter readings on the card (``[grid] ... tile moves`` lines); the
   collective bytes of granite-3-2b's train_4k, prefill_32k and decode_32k
   cells on the 16x16 grid, counted by running the port's grid step on
   meta tiles (non-null and non-zero, one line a cell and its bytes by JAX
   op type); the cells in parallel processes, run beside the kernel build
   (they need no card, and the build leaves most cores idle while its
   longest source compiles) and checked here; its seconds, under
   ``DRYRUN_BUDGET_S``.  Phases 17-19 hold the same meta count, of each
   step they run on the card's grid, equal to the card's counter;
17. the LM substrate on a 2x2 grid of the one card (``[lmgrid]`` lines,
   ``make_context([cuda:0] * 4, 2)``): qwen2-1.5b at full width and depth
   served through ``ServeEngine.generate(grid=)`` with phase 9's requests
   and weights under the serve rules (exact launches: four tiles, once per
   attention block in prefill, all on the tensor-core route, none in
   decode; time to first token, decode ms a step, peak memory and the bytes
   a prefill and a decode step move between grid positions, beside phase
   9's 1x1 figures; how many bf16 greedy tokens equal phase 9's; one more
   decode step under ``torch.profiler``: device busy share, copies), then in
   fp32 at depth 2 the grid against 1x1 on the card (tokens equal, prefill
   logits within 1e-3 of the largest); granite-3-2b at full width trained 2
   steps on the grid through ``train_loop(grid=)`` (AdamW, bf16, remat:
   loss, grad norm, ms a step, moved bytes by kind, peak <= 76 GB, exact
   launches, each tile's parameter and optimizer bytes equal to the dry
   run's ``argument_bytes`` on a 2x2 grid; one more step under
   ``torch.profiler``: device busy share, copies); in fp32 at depth 2 one step
   under the baseline, fsdp and seqshard rules against the 1x1 step (loss
   and grad norm within 1e-5; seqshard launches ``flash_attention`` with
   ``q_offset > 0``); one int8 compressed step on a 2x2x2 grid of the card
   (finite; synced gradients within the int8 bound of the pods' mean); a
   2x2 checkpoint resumed on 1x1 under deterministic algorithms (losses
   within 1e-5 of the grid run's); its seconds (aim: under 90);
18. the MoE and vlm families on device grids of the one card (``[moegrid]``
   lines): granite-moe-3b at full width and depth served on 2x2 (phase 13's
   requests, 8 greedy tokens), llama4 at full width (2 of its 48 layers, as
   phase 13) on 1x4 and chameleon-34b at full width (16 of its 48 layers)
   on 2x2 (exact launches, time to first token, decode ms a step, peak <= 76
   GB while the engine cuts its tiles and while it serves, the bytes a
   prefill and a decode step move by kind, each tile's bytes equal to the
   dry run's decode_32k ``argument_bytes`` where the parameter and compute
   dtypes are one, each prefill tile routing its batch shard and each
   decode tile all tokens where the experts divide their axis, the dropped
   slots per MoE layer against granite-moe's 1x1 prefill);
   granite-moe at full width trained 2 steps on 2x2 (AdamW, bf16, remat;
   every layer; its tiles' state equal to the dry run's); the card's 2x2
   grid against the CPU's in fp32 for granite-moe at full width and depth 2
   and llama4 at SMOKE (tokens equal, logits within 1e-3 of the largest,
   expert ids and kept masks, one train step's loss and grad norm within
   1e-5); llama4 SMOKE's gathered decode step on 2x2 and 1x4 against 1x1
   from one cache (logits within 1e-3); its seconds (aim: under 150);
19. the last LM families on a 2x2 grid of the one card (``[famgrid]``
   lines): rwkv6-3b, zamba2-7b (81 layers, its 13 shared-block calls) and
   seamless-m4t-medium (12 + 12 layers, over frames (4, 1024, 1024)) at
   full width and depth, served with phase 9's requests (8 greedy tokens):
   exact launches (``wkv`` 4 x 32, ``flash_attention`` 4 x 13 on ``wgmma``
   at D=224 and 4 x 36 on ``wgmma`` by (S, T, causal), none in
   decode), time to first token, decode ms a step and peak (<= 76 GB, also
   while the engine cuts its tiles) beside the 1x1 phases 9, 13 and 14, the
   bytes a prefill and a decode step move by kind, each tile's parameter
   bytes equal to the dry run's decode_32k ``argument_bytes``, and each
   tile form of the kernels (``wkv`` (40, 1024, 64)) against its plain
   version, twice bitwise, timed beside its bound and SDPA; rwkv6-3b at 4
   of its 32 layers trained 2 steps (AdamW, bf16, remat: ``wkv`` twice a
   layer a tile, its tiles' state equal to the dry run's); the card's 2x2
   grid against the CPU's in fp32 (zamba2 at depth 7, rwkv6 at 2, seamless
   at 2 + 2 over 64 frames: tokens equal, logits within 1e-3 of the
   largest, one train step's loss and grad norm within 1e-5); its seconds
   (aim: under 150).

A copy of the script beside another tree's ``src/`` (a parent commit's
``git archive``) runs the same phases on that tree's package, so both trees
are measured by the same code in one call.

The line before the last is the JSON ``kernels`` table (``launches`` sums
the main paths of phases 3, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 17, 18 and 19;
``launches_by_path`` splits them); the last line is ``{"ok": true,
"device": {...}}``.  It imports neither JAX nor the JAX package.  Long logs go to ``OUT``, a gitignored directory beside
the script; the on-disk stores of phases 5, 7, 8, 10 and 12 and phase 15's
checkpoints live under ``build/`` and are removed at the end of their phase.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import threading
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
T_MAIN = 3  # snapshots of the climate sequence (its draws depend on it: phases 5 and 12 store
# the first snapshots of this sequence)
T_OOC = 2  # snapshots of the out-of-core main path (two, not three: phase 12's time)
T_INC = 4  # snapshots of the resident incremental run (phase 7)
T_INC_OOC = 3  # and of the out-of-core one
N_INC_SMALL = 1536  # phase 7's card-against-CPU runs
# Phase 7's accuracy gates, set from its readings on an H100 (PERF.md): the
# resident delta run against the full rebuild, max error 1.0e-3, 4.2e-3,
# 2.3e-3 of V_G E|z|^2 and top-20 overlap 20, 20, 20; the n=1536 card against
# the CPU, at most 3.6e-3 of the largest score.
INC_ERR_LIMIT = 1e-2  # of V_G E|z|^2
INC_OVERLAP_MIN = 18
INC_CARD_CPU_RTOL = 1e-2  # of the largest score
CHAIN_GEMMS = 2 * (6 - 1) + 1  # d = 6: T and P per level, then P2
REFINE_STEPS = 10 - 1  # q = 10
PH_QUERY = 144  # the embedding store's default panel at n=10512: 73 panels
N_LARGE, K_LARGE, PH_LARGE = 360 * 720, 20, 128  # the synthetic artifact: 2025 panels
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 1024, 32  # the serve path's requests
SERVE_MODELS = (("rwkv6-3b", "wkv"), ("qwen2-1.5b", "flash_attention"))  # (arch, its kernel)
N_PAPER_SMALL = 1536  # phase 10's card-against-CPU size
N_OOC_SOLVE = 4096  # phase 10's out-of-core chain and solver calls
T_PAPER_STORE = 2  # snapshots gmm_store_sequence writes at n=10512
PAPER_PAIRS = 300  # phase 10's injected entries of R (inject_p = PAPER_PAIRS / n^2)
QUERIES = (  # (label, k, corrected, nearest-neighbor node or None)
    ("top raw k=20", 20, False, None),
    ("top raw k=300", 300, False, None),
    ("top corrected k=20", 20, True, None),
    ("top corrected k=300", 300, True, None),
    ("neighbors of node 0 k=20", 20, False, 0),
)


def log(msg: str) -> None:
    # one write a line: phase 16's cells log from a thread beside the build
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


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


def _ranking_flips(card: list, cpu: list, score, tol: float) -> list:
    """Where two top-k rankings of the same entries disagree, the pairs
    involved whose CPU scores (``score[entry]``) lie more than ``tol`` apart
    (empty: they differ only at ties).

    An entry in one top-k and not the other is held against the CPU's k-th
    score; two entries in both, ranked in opposite orders, against each other."""
    bad = []
    edge = float(score[cpu[-1]])
    for i in set(card) ^ set(cpu):
        if abs(float(score[i]) - edge) > tol:
            bad.append((i, cpu[-1]))
    both = [i for i in card if i in cpu]
    pos = {i: cpu.index(i) for i in both}
    for a_i, a in enumerate(both):
        for b in both[a_i + 1:]:
            if pos[a] > pos[b] and abs(float(score[a]) - float(score[b])) > tol:
                bad.append((a, b))
    return bad


def check_card_vs_cpu(tag: str, gpu, cpu, rtol: float = 1e-3, ties: bool = False) -> list:
    """Scores within ``rtol`` of each transition's largest CPU score; top-20
    ids equal per transition and sequence-wide ((node, transition) entries),
    or with ``ties``, differing only between entries whose CPU scores lie
    within 1e-3 of the largest score of each other.  Returns each
    transition's max |diff| as a share of its largest score."""
    import numpy as np

    rel, cpu_scores = [], []
    for t, (rg, rc) in enumerate(zip(gpu.transitions, cpu.transitions)):
        sg, sc = rg.scores.cpu().numpy(), rc.scores.cpu().numpy()
        cpu_scores.append(sc)
        err = float(np.abs(sg - sc).max())
        scale = float(np.abs(sc).max())
        if not np.isfinite(sg).all() or err > rtol * scale:
            fail(f"{tag} transition {t}: card vs CPU max |diff| {err:.3e} > {rtol:g} x "
                 f"max score {scale:.3e}")
        card_ids, cpu_ids = rg.top_idx.tolist(), rc.top_idx.tolist()
        if card_ids != cpu_ids and (not ties
                                    or _ranking_flips(card_ids, cpu_ids, sc, 1e-3 * scale)):
            fail(f"{tag} transition {t}: top-{TOP_K} ids differ: {card_ids} vs {cpu_ids}"
                 + (" beyond ties within 1e-3 of the largest score" if ties else ""))
        srt = np.sort(sc)[::-1]
        log(f"[e2e] {tag} transition {t}: card vs CPU max |diff| {err:.3e} (tol {rtol:g} x "
            f"max score {scale:.3e}; {err / scale:.3e} of it); top-{TOP_K} ids "
            f"{'equal' if card_ids == cpu_ids else 'equal but for ties'}; score gap at rank "
            f"{TOP_K} {srt[TOP_K - 1] - srt[TOP_K]:.3e}")
        rel.append(err / scale)
    keys = [list(zip(r.global_top_idx.tolist(), r.global_top_step.tolist())) for r in (gpu, cpu)]
    if keys[0] != keys[1]:
        score = {(i, s): float(cpu_scores[s][i]) for i, s in keys[0] + keys[1]}
        tol = 1e-3 * max(float(np.abs(s).max()) for s in cpu_scores)
        if not ties or _ranking_flips(keys[0], keys[1], score, tol):
            fail(f"{tag}: sequence-wide top-{TOP_K} differs between card and CPU: {keys[0]} vs "
                 f"{keys[1]}")
    log(f"[e2e] {tag} sequence-wide top-{TOP_K} "
        f"{'equal' if keys[0] == keys[1] else 'equal but for ties'} on card and CPU")
    return rel


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
    from repro_torch.graphs import climate_snapshot_sequence
    from repro_torch.obs import REGISTRY, disable_tracing, enable_tracing
    from repro_torch.store import TileStore

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="smoke_store_", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        seq = climate_snapshot_sequence(73, 144, t_steps=T_MAIN, device="cuda")
        store = TileStore.create(tmp, n=N_MAIN, grid=STORE_GRID, codec="raw")
        ids = []
        for t, a in zip(range(T_OOC), seq.snapshots()):
            ids.append(store.put_snapshot(f"t{t:04d}", a.cpu().numpy()).snap_id)
            del a
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


def _drifting_gmm(n: int, t_steps: int, device: str, seed: int = 5):
    """tests/test_delta_chain.py's slowly drifting sequence: 3 movers a step,
    no injected edges."""
    from repro_torch.graphs import gmm_snapshot_sequence

    return gmm_snapshot_sequence(n, t_steps, seed=seed, noise=0.02, inject_steps=set(),
                                 drift_nodes=3, device=device)


def _chain_counts(met: dict | None) -> dict:
    """A push's chain counters: rebuilds, delta updates, fallbacks and the
    logical pass sizes, as the run report's ``chain`` section reads them."""
    from repro_torch.obs.report import CHAIN_FIELDS

    return {f: (met or {}).get(f"chain.{f}", 0.0) for f in CHAIN_FIELDS}


def _inc_decisions(res) -> list:
    """(rebuilds, delta updates, fallbacks) of the first push, then of each transition."""
    return [tuple(int(_chain_counts(m)[f]) for f in ("full_rebuilds", "incremental_updates",
                                                      "drift_fallbacks"))
            for m in (res.warmup_metrics, *res.transition_metrics)]


def _check_inc_counts(tag: str, res, want: tuple) -> None:
    """Run totals (rebuilds, delta updates, fallbacks) equal to ``want``."""
    got = tuple(sum(d[i] for d in _inc_decisions(res)) for i in range(3))
    if got != want:
        fail(f"{tag}: full rebuilds / incremental updates / drift fallbacks {got} != {want}")


def _inc_score_errors(tag: str, res, ref_scores: list, scale: float) -> tuple:
    """Scores of ``res`` against ``ref_scores``: the largest error of each
    transition as a share of ``scale``, and the transitions outside
    tests/test_delta_chain.py's acceptance tolerance, rtol 1e-3 and atol
    1e-3 x ``scale``."""
    import numpy as np

    errs, outside = [], []
    for t, r in enumerate(res.transitions):
        s = r.scores.cpu().numpy().astype(np.float64)
        f = np.asarray(ref_scores[t], np.float64)
        if s.shape != f.shape or not np.isfinite(s).all():
            fail(f"{tag} transition {t}: scores not finite of shape {f.shape}")
        if (np.abs(s - f) - (1e-3 * np.abs(f) + 1e-3 * scale)).max() > 0:
            outside.append(t)
        errs.append(float(np.abs(s - f).max() / scale))
    return errs, outside


def _inc_run(torch, cfg, snaps, tag: str, trace_to: Path | None = None) -> dict:
    """One sequence run on the card with fenced phase seconds, its launch counts,
    registry delta and peak device memory; with ``trace_to``, the tracer holds
    this run alone and its Chrome trace is written there."""
    from repro_torch import kernels
    from repro_torch.core import SequenceDetector, reset_stream_stats, stream_stats
    from repro_torch.obs import REGISTRY, disable_tracing, enable_tracing, tracer

    det = SequenceDetector(cfg, top_k=TOP_K, device="cuda")
    if trace_to is not None:
        tracer().clear()
    enable_tracing(fence=True)  # phase seconds are device walls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_stream_stats()
    m0 = REGISTRY.snapshot()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = det.run(snaps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    disable_tracing()
    if trace_to is not None:
        tracer().save(str(trace_to))
    chain_s = [m.get("phase.chain.seconds", 0.0) for m in res.transition_metrics]
    log(f"[incremental] {tag}: run wall {wall:.3f} s; chain builds {res.chain_builds}; chain "
        f"seconds per transition {', '.join(f'{s:.4f}' for s in chain_s)}; (rebuilds, delta "
        f"updates, fallbacks) per push {_inc_decisions(res)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    return {"res": res, "counts": counts, "met": REGISTRY.delta(m0), "wall": wall,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "chain_s": chain_s,
            "stream": stream_stats().snapshot()}


def phase_incremental(torch) -> dict:
    """The incremental delta chain on the card (phase 7): resident at n=10512
    against a full rebuild of the same drifting sequence, with a validated run
    report and Chrome trace; out of core from an on-disk store; then n=1536
    card against CPU, resident and out of core, and an abrupt snapshot."""
    import gc
    import itertools
    import shutil
    import tempfile
    from dataclasses import replace

    from repro_torch.core import (
        CommuteConfig,
        SequenceDetector,
        commute_time_embedding,
        full_build_gemm_cost,
    )
    from repro_torch.obs import REGISTRY
    from repro_torch.obs import report as obs_report
    from repro_torch.obs.report import CHAIN_FIELDS
    from repro_torch.store import TileStore

    full_cfg = CommuteConfig(eps_rp=1e-3, d=6, q=10)  # the main path's, richardson
    inc_cfg = replace(full_cfg, incremental_chain=True)  # the CLI's rank 4, budget 0.1
    out: dict = {}

    # -- 1. resident, n=10512, T=4: incremental against full rebuild ----------
    seq = _drifting_gmm(N_MAIN, T_INC, "cuda")
    full = _inc_run(torch, full_cfg, seq.snapshots(), f"resident full rebuild n={N_MAIN} "
                    f"T={T_INC}")
    full_scores = [r.scores.cpu().numpy() for r in full["res"].transitions]
    full_top = [r.top_idx.tolist() for r in full["res"].transitions]
    full_secs = full["res"].transition_seconds
    del full["res"]
    gc.collect()
    torch.cuda.empty_cache()
    OUT.mkdir(exist_ok=True)
    inc = _inc_run(torch, inc_cfg, seq.snapshots(), f"resident incremental n={N_MAIN} "
                   f"T={T_INC}", trace_to=OUT / "incremental_trace.json")
    res = inc["res"]
    _check_inc_counts("resident incremental", res, (1, T_INC - 1, 0))
    want = {name: 0 for name in inc["counts"]} | {
        "block_matmul": CHAIN_GEMMS, "edge_projection": T_INC, "cad_scores": T_INC - 1}
    if inc["counts"] != want:
        fail(f"resident incremental launch counts {inc['counts']} != {want}")
    if full["counts"]["block_matmul"] != T_INC * CHAIN_GEMMS:
        fail(f"full-rebuild block_matmul launches {full['counts']['block_matmul']} != "
             f"{T_INC * CHAIN_GEMMS}")
    emb = commute_time_embedding(next(seq.snapshots()), full_cfg, device="cuda")
    z = emb.z.double()
    scale = float(emb.vol) * float((z * z).sum(1).mean())
    del emb, z
    # At n=10512 the reference's algorithm misses its own acceptance
    # tolerance against the full rebuild from the second delta on (the sketch
    # truncates the degree-scaling part of dS, which every neighbour of a
    # mover carries; tests/test_torch_delta_chain.py's slow
    # test_reference_and_port_share_the_accuracy_limit shows the JAX package
    # doing the same at n=2048), so that tolerance is printed and the gate is
    # INC_ERR_LIMIT, set from this run's readings.
    errs, outside = _inc_score_errors("resident incremental", res, full_scores, scale)
    flops_full, _, scratch_full = full_build_gemm_cost(N_MAIN, full_cfg.d)
    ratios = []
    for t, m in enumerate(res.transition_metrics):
        c = _chain_counts(m)
        if not (0 < c["gemm_flops"] <= flops_full / 3
                and 0 < c["scratch_bytes"] <= scratch_full / 3):
            fail(f"incremental transition {t}: chain.gemm_flops {c['gemm_flops']:.4e} / "
                 f"scratch_bytes {c['scratch_bytes']:.4e} not within a third of a full build's "
                 f"{flops_full:.4e} / {scratch_full:.4e}")
        ratios.append((flops_full / c["gemm_flops"], scratch_full / c["scratch_bytes"]))
    overlap = [len(set(r.top_idx.tolist()) & set(f)) for r, f in zip(res.transitions, full_top)]
    if max(errs) > INC_ERR_LIMIT or min(overlap) < INC_OVERLAP_MIN:
        fail(f"resident incremental against the full rebuild: max score error "
             f"{', '.join(f'{e:.3e}' for e in errs)} of the scale {scale:.4e} (limit "
             f"{INC_ERR_LIMIT:g}), top-{TOP_K} overlap {overlap} (at least {INC_OVERLAP_MIN})")
    drift = REGISTRY.series("chain.drift")[-(T_INC - 1):]

    # the run report and the trace of the incremental run
    doc = obs_report.build_run_report(
        config={"n": N_MAIN, "t_steps": T_INC, "d": inc_cfg.d, "q": inc_cfg.q,
                "eps": inc_cfg.eps_rp, "incremental_chain": True,
                "delta_rank": inc_cfg.delta_rank, "delta_budget": inc_cfg.delta_budget,
                "device": "cuda"},
        result=res, n=N_MAIN, k_rp=K_MAIN)
    obs_report.save_run_report(doc, str(OUT / "incremental_report.json"))
    for path in ("incremental_report.json", "incremental_trace.json"):
        try:
            obs_report.validate_file(str(OUT / path))
        except ValueError as e:
            fail(f"{path} does not pass the port's validator: {e}")
    for f in CHAIN_FIELDS:
        if doc["chain"][f] != REGISTRY.value(f"chain.{f}"):
            fail(f"run report chain.{f} {doc['chain'][f]} != the registry's "
                 f"{REGISTRY.value(f'chain.{f}')}")
        pushes = _chain_counts(res.warmup_metrics)[f] + sum(t["chain"][f]
                                                            for t in doc["transitions"])
        if not math.isclose(pushes, inc["met"].get(f"chain.{f}", 0.0), rel_tol=1e-12):
            fail(f"run report: chain.{f} over the pushes {pushes} != the run's "
                 f"{inc['met'].get(f'chain.{f}', 0.0)}")
    n_events = len(json.loads((OUT / "incremental_trace.json").read_text())["traceEvents"])
    log(f"[incremental] resident n={N_MAIN} T={T_INC} (d={inc_cfg.d}, q={inc_cfg.q}, "
        f"k={K_MAIN}, rank {inc_cfg.delta_rank}, budget {inc_cfg.delta_budget}): 1 rebuild, "
        f"{T_INC - 1} delta updates, 0 fallbacks; drift {', '.join(f'{d:.4e}' for d in drift)}; "
        f"block_matmul launches {inc['counts']['block_matmul']} against the full run's "
        f"{full['counts']['block_matmul']}; chain seconds per transition "
        f"{', '.join(f'{s:.4f}' for s in inc['chain_s'])} against "
        f"{', '.join(f'{s:.4f}' for s in full['chain_s'])}; full-build / delta FLOPs and "
        f"scratch {', '.join(f'{a:.1f}x / {b:.1f}x' for a, b in ratios)}; peak device memory "
        f"{inc['peak_gb']:.3f} GB against {full['peak_gb']:.3f} GB; top-{TOP_K} overlap with "
        f"the full rebuild {overlap}")
    log(f"[incremental] scores against the full rebuild: max error "
        f"{', '.join(f'{e:.3e}' for e in errs)} of the scale V_G E|z|^2 = {scale:.4e} "
        f"(limit {INC_ERR_LIMIT:g}); top-{TOP_K} overlap {overlap} (at least "
        f"{INC_OVERLAP_MIN}); transitions outside the JAX tolerance (rtol 1e-3, atol 1e-3 x "
        f"scale): {outside}")
    log(f"[incremental] run report (schema {doc['schema']}) and Chrome trace ({n_events} "
        f"events) of the incremental run pass the port's validators; its chain section (the "
        f"process's totals, as in the reference) equals the registry's counters, its pushes' "
        f"chain deltas sum to this run's: "
        f"{', '.join(f'{f} {inc['met'].get(f'chain.{f}', 0.0):.6g}' for f in CHAIN_FIELDS)}")
    out["resident"] = {
        "counts": inc["counts"], "counts_full": full["counts"], "wall_s": inc["wall"],
        "wall_full_s": full["wall"], "chain_s": inc["chain_s"], "chain_full_s": full["chain_s"],
        "peak_gb": inc["peak_gb"], "peak_full_gb": full["peak_gb"], "drift": list(drift),
        "flops_ratio": [a for a, _ in ratios], "scratch_ratio": [b for _, b in ratios],
        "max_err_of_scale": errs, "outside_tolerance": outside, "scale": scale,
        "top20_overlap": overlap,
        "transition_s": res.transition_seconds, "transition_full_s": full_secs}
    inc_scores = [r.scores.cpu().numpy() for r in res.transitions]
    del res, inc["res"]
    gc.collect()
    torch.cuda.empty_cache()

    # -- 2. out of core, incremental, T=3 from an on-disk raw store ------------
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="smoke_inc_store_", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        store = TileStore.create(tmp, n=N_MAIN, grid=STORE_GRID, codec="raw")
        for t, a in enumerate(itertools.islice(seq.snapshots(), T_INC_OOC)):
            store.put_snapshot(f"t{t:03d}", a.cpu().numpy())
            del a
        del seq
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[incremental] wrote {T_INC_OOC} snapshots of n={N_MAIN} into a raw "
            f"{STORE_GRID}x{STORE_GRID} tile store on disk in {time.perf_counter() - t0:.1f} s")
        # the host-RAM scratch the chain build would make for itself (grid 8:
        # 1314-row panels), handed in so it can be inspected after finalize()
        scratch = TileStore.create(None, n=N_MAIN, grid=N_MAIN // PH_OOC, codec="raw")
        cfg = replace(inc_cfg, oocore=True, use_gemm_kernel=True, oocore_dir=scratch)
        handles = [store.snapshot(f"t{t:03d}") for t in range(T_INC_OOC)]
        ooc = _inc_run(torch, cfg, handles, f"out-of-core incremental n={N_MAIN} T={T_INC_OOC}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = ooc["res"]
    _check_inc_counts("out-of-core incremental", res, (1, T_INC_OOC - 1, 0))
    g = N_MAIN // PH_OOC
    want = {name: 0 for name in ooc["counts"]} | {
        "edge_projection": T_INC_OOC * STORE_GRID, "cad_scores": (T_INC_OOC - 1) * STORE_GRID,
        "stream_gemm": CHAIN_GEMMS * g * g + T_INC_OOC * g, "stream_gemm_tc": CHAIN_GEMMS * g * g,
        "fused_panel_matvec": T_INC_OOC * REFINE_STEPS * g}
    if ooc["counts"] != want:
        fail(f"out-of-core incremental launch counts {ooc['counts']} != {want}")
    # gated against run 1's incremental scores (the same algorithm on the other route)
    vs_res, off = _inc_score_errors("out-of-core incremental", res, inc_scores, scale)
    if off:
        fail(f"out-of-core incremental transitions {off}: scores off the resident incremental "
             f"run's by more than rtol 1e-3, atol 1e-3 x scale {scale:.4e}")
    errs_ooc, _ = _inc_score_errors("out-of-core incremental", res, full_scores, scale)
    live_cap = 4 * PH_OOC * N_MAIN * 4
    if ooc["stream"]["peak_live_bytes"] > live_cap:
        fail(f"out-of-core incremental stream.peak_live_bytes {ooc['stream']['peak_live_bytes']} "
             f"> 4 panels ({live_cap})")
    if scratch.snapshot_ids:
        fail(f"out-of-core incremental: after finalize() the scratch store holds "
             f"{scratch.snapshot_ids} (retained levels leaked)")
    log(f"[incremental] out-of-core n={N_MAIN} T={T_INC_OOC}: 1 rebuild, {T_INC_OOC - 1} delta "
        f"updates, 0 fallbacks; launches {ooc['counts']}; chain seconds per transition "
        f"{', '.join(f'{s:.3f}' for s in ooc['chain_s'])}; max score error against the "
        f"resident incremental run {', '.join(f'{e:.3e}' for e in vs_res)} of the scale (tol "
        f"1e-3, rtol 1e-3), against the full rebuild {', '.join(f'{e:.3e}' for e in errs_ooc)}; "
        f"stream.peak_live_bytes {ooc['stream']['peak_live_bytes'] / 1e6:.1f} MB (cap "
        f"{live_cap / 1e6:.1f} MB); scratch store empty after finalize()")
    out["oocore"] = {"counts": ooc["counts"], "wall_s": ooc["wall"], "chain_s": ooc["chain_s"],
                     "peak_gb": ooc["peak_gb"], "max_err_of_scale": errs_ooc,
                     "max_err_of_scale_vs_resident": vs_res,
                     "transition_s": res.transition_seconds, "stream": ooc["stream"]}
    del res, ooc["res"]
    gc.collect()
    torch.cuda.empty_cache()

    # -- 3. n=1536: card against CPU, resident and out of core; an abrupt snapshot.
    # Scores within INC_CARD_CPU_RTOL of the largest, not phase 4's 1e-3: the
    # sketch carries the card's and the CPU's different fp32 roundings into a
    # quiet transition's scores several times more than a full rebuild does.
    # Top-20 ids equal but for ties within phase 4's tolerance (1e-3 of the
    # largest score): a quiet transition's rank-20/21 gap can be far narrower
    # than the two devices' rounding moves a score.
    n = N_INC_SMALL
    quiet = [a.cpu() for a in _drifting_gmm(n, T_INC, "cpu").snapshots()]
    # a fresh GMM draw (tests/test_delta_chain.py:168) mid-sequence, then its own slow drift
    abrupt = [*quiet[:2], *(a.cpu() for a in _drifting_gmm(n, 2, "cpu", seed=99).snapshots())]
    for storage in ("resident", "out-of-core"):
        cfg = inc_cfg if storage == "resident" else replace(inc_cfg, oocore=True,
                                                           use_gemm_kernel=True)
        for name, snaps, want_d in (("drifting", quiet, [(1, 0, 0)] + [(0, 1, 0)] * (T_INC - 1)),
                                    ("abrupt", abrupt, [(1, 0, 0), (0, 1, 0), (1, 0, 1),
                                                        (0, 1, 0)])):
            runs = {}
            for dev in ("cuda", "cpu"):
                if storage == "resident":
                    src = [a.to(dev) for a in snaps]
                else:
                    st = TileStore.create(None, n=n, grid=STORE_GRID, codec="raw")
                    src = [st.put_snapshot(f"t{t:03d}", a.numpy()) for t, a in enumerate(snaps)]
                runs[dev] = SequenceDetector(cfg, top_k=TOP_K, device=dev).run(src)
            tag = f"incremental n={n} {storage} {name}"
            dec = {dev: _inc_decisions(r) for dev, r in runs.items()}
            if dec["cuda"] != dec["cpu"] or dec["cuda"] != want_d:
                fail(f"{tag}: (rebuilds, delta updates, fallbacks) per push card {dec['cuda']}, "
                     f"CPU {dec['cpu']}, want {want_d}")
            cnt = {dev: [_chain_counts(m) for m in (r.warmup_metrics, *r.transition_metrics)]
                   for dev, r in runs.items()}
            if cnt["cuda"] != cnt["cpu"]:
                fail(f"{tag}: chain counters differ between card and CPU")
            rel = check_card_vs_cpu(tag, runs["cuda"], runs["cpu"], rtol=INC_CARD_CPU_RTOL,
                                    ties=True)
            log(f"[incremental] {tag}: (rebuilds, delta updates, fallbacks) per push "
                f"{dec['cuda']} on card and CPU; chain counters equal; card against CPU max "
                f"|diff| {', '.join(f'{e:.3e}' for e in rel)} of the largest score (limit "
                f"{INC_CARD_CPU_RTOL:g})")
    return out


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
    prompt 1024).  Returns per-launch times (ms) for the split of phase 9."""
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
    fforms["bf16 causal q_offset"] = _flash_q_offset(torch, fa, ref, route, sdpa, q, kk, vv,
                                                     grp, main_out, tol_b)
    # the existing forms' outputs, for a bitwise comparison with another
    # tree's kernel on the same inputs (scripts/flash_bits.py recomputes them)
    digests = _flash_digests(torch, fa)
    q4, k4, v4 = (t.view(SERVE_BATCH, -1, s, d) for t in (q, kk, vv))
    lib = time_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=True, enable_gqa=True), reps=20)
    # the SIMT kernel (the earlier design, now the fp32 route) on the same bf16
    # inputs, through the library entry the wrapper no longer sends bf16 D=128 to
    simt_out = torch.empty_like(q)
    lib_fn = _build.library().rt_flash_attention

    def simt():
        _build.check(lib_fn(q.data_ptr(), kk.data_ptr(), vv.data_ptr(), simt_out.data_ptr(),
                            nkv * grp, s, s, d, grp, 1, 0, 1.0 / d**0.5, 1,
                            _build.stream_handle(q)), "flash_attention SIMT")

    simt_ms = time_ms(torch, simt, reps=20)
    simt_err, _ = check_close(f"{name} (SIMT kernel)", simt_out, main_out, tol_b)
    log(f"[kernels] {name}: wgmma route {ms_f:.4f} ms, SDPA {lib:.4f} ms ({ms_f / lib:.2f}x), "
        f"the SIMT kernel on the same inputs {simt_ms:.4f} ms (its output within {simt_err:.3e} "
        f"of the wgmma route's)")
    d224 = _flash_d224(torch, fa, ref, randn, route, sdpa, tol_b)
    pairs = nkv * grp * s * (s + 1) / 2  # the causal (q, k) pairs these inputs need
    rows.append(kernel_row(
        "flash_attention", "flash_attention.cu", "src/repro/kernels/flash_attention.py:70",
        f"q ({nkv * grp},{s},{d}) k/v ({nkv},{s},{d}) bf16 causal, groups {grp}", check, tol_b,
        ms_f, plain_f, 4.0 * d * pairs, nbytes(q, kk, vv, q), lib, peak_ops=PEAK_BF16_OPS,
        forms=fforms, library_call="scaled_dot_product_attention(is_causal, enable_gqa)",
        kernel_route="wgmma (bf16, D in {64, 128, 224}); SIMT for fp32 and other D up to 256",
        simt_kernel_ms=simt_ms, d224=d224, output_digests=digests))
    return {"wkv_ms": ms, "flash_attention_ms": ms_f}


def _flash_q_offset(torch, fa, ref, route, sdpa, q, k, v, grp: int, whole, tol: float) -> dict:
    """flash_attention at the seqshard preset's tile: the second half of the
    prompt's queries (q_offset = S / 2) against all S keys, bf16 causal on
    the tensor-core route; against the plain version with the same offset
    and against the whole sequence's rows, twice bitwise, timed beside the
    plain version, SDPA with the lower-right causal mask, and its bound (the
    causal pairs these rows need)."""
    s, d = q.shape[1], q.shape[2]
    off = s // 2
    qo = q[:, off:].contiguous()
    name = (f"flash_attention q ({qo.shape[0]},{s - off},{d}) q_offset {off} over k/v {s} bf16 "
            f"causal")
    out, took = route(lambda: fa.flash_attention(qo, k, v, groups=grp, q_offset=off))
    if took != "wgmma":
        fail(f"{name}: took the {took} route, want wgmma")
    check = check_close(name, out, ref.flash_attention(qo, k, v, groups=grp, q_offset=off), tol)
    rows_err, _ = check_close(f"{name} against the whole sequence's rows", out, whole[:, off:], tol)
    same_rows = bool(torch.equal(out, whole[:, off:]))
    check_bitwise(torch, name, lambda: fa.flash_attention(qo, k, v, groups=grp, q_offset=off))
    ms = time_ms(torch, lambda: fa.flash_attention(qo, k, v, groups=grp, q_offset=off), reps=20)
    plain = time_ms(torch, lambda: ref.flash_attention(qo, k, v, groups=grp, q_offset=off), reps=3)
    b = SERVE_BATCH
    q4, k4, v4 = qo.view(b, -1, s - off, d), k.view(b, -1, s, d), v.view(b, -1, s, d)
    mask = (torch.arange(s - off, device=q.device)[:, None] + off
            >= torch.arange(s, device=q.device)[None, :])
    lib = time_ms(torch, lambda: sdpa(q4, k4, v4, attn_mask=mask, enable_gqa=True), reps=20)
    pairs = qo.shape[0] * sum(range(off + 1, s + 1))  # row i sees off + i + 1 keys
    bms, by = bound_ms(4.0 * d * pairs, nbytes(qo, k, v, qo), PEAK_BF16_OPS)
    log(f"[kernels] {name}: wgmma route; max_abs_err {check[0]:.3e} (tol {tol:g} x max|plain|), "
        f"against the whole sequence's rows {rows_err:.3e} "
        f"({'bitwise equal' if same_rows else 'not bitwise'}); "
        f"bitwise repeatable; {ms:.4f} ms, plain {plain:.3f} ms, SDPA (lower-right causal mask) "
        f"{lib:.4f} ms, bound {bms:.4f} ms ({by})")
    return {"shape": name, "route": took, "max_abs_err": check[0], "whole_rows_err": rows_err,
            "whole_rows_bitwise": same_rows, "ms": ms, "plain_ms": plain, "library_ms": lib,
            "library_call": "scaled_dot_product_attention(attn_mask lower-right, enable_gqa)",
            "bound_ms": bms, "bound_by": by}


def _flash_digests(torch, fa) -> dict:
    """SHA-256 of the bits of flash_attention's output for phase 2's earlier
    forms (no q_offset argument), on inputs remade from a fixed seed
    (``scripts/flash_bits.py``, which prints the same for another tree)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("flash_bits", ROOT / "scripts" / "flash_bits.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.digests(torch, fa)
    log(f"[kernels] flash_attention output digests (scripts/flash_bits.py): {json.dumps(out)}")
    return out


def _flash_d224(torch, fa, ref, randn, route, sdpa, tol: float) -> dict:
    """flash_attention at zamba2's shared-block prefill: q/k/v (4 x 32, 1024,
    224) bf16, causal, groups 1, on the tensor-core route; against the plain
    version, twice bitwise, ptxas's registers and spills of its instance (none
    allowed), timed (events and device) beside the SIMT kernel on the same
    inputs (the route's earlier design, through the library entry the wrapper
    no longer sends bf16 D=224 to), SDPA and its bound."""
    from repro_torch.kernels import _build

    bh, s, d = SERVE_BATCH * 32, SERVE_PROMPT, 224
    q, k, v = (randn(bh, s, d, dtype=torch.bfloat16) for _ in range(3))
    name = f"flash_attention ({bh},{s},{d}) bf16 causal"
    usage = _build.ptxas_usage(_build.BUILD_INFO.get("log", ""), "flash_kernel_wgmmaILi224E")
    if usage is None:
        fail(f"{name}: the build log holds no ptxas report for flash_kernel_wgmma<224>")
    if usage["spill_stores"] or usage["spill_loads"]:
        fail(f"{name}: flash_kernel_wgmma<224> spills ({usage})")
    out, took = route(lambda: fa.flash_attention(q, k, v))
    if took != "wgmma":
        fail(f"{name}: took the {took} route, want the tensor-core (wgmma) route")
    check = check_close(name, out, ref.flash_attention(q, k, v), tol)
    check_bitwise(torch, name, lambda: fa.flash_attention(q, k, v))
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v), reps=20)
    dev_ms = kernel_device_ms(torch, lambda: fa.flash_attention(q, k, v), 20,
                              ("flash_kernel_wgmma",))
    plain = time_ms(torch, lambda: ref.flash_attention(q, k, v), reps=2)
    q4, k4, v4 = (t.view(SERVE_BATCH, -1, s, d) for t in (q, k, v))
    lib = time_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=True), reps=20)
    simt_out = torch.empty_like(q)
    lib_fn = _build.library().rt_flash_attention

    def simt():
        _build.check(lib_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), simt_out.data_ptr(),
                            bh, s, s, d, 1, 1, 0, 1.0 / d**0.5, 1, _build.stream_handle(q)),
                     "flash_attention SIMT")

    simt_ms = time_ms(torch, simt, reps=5)
    simt_err, _ = check_close(f"{name} (SIMT kernel)", simt_out, out, tol)
    ops = 4.0 * d * bh * s * (s + 1) / 2  # the causal pairs' two products
    bms, by = bound_ms(ops, nbytes(q, k, v, q), PEAK_BF16_OPS)
    log(f"[kernels] {name}: wgmma route (flash_kernel_wgmma<224>: {usage['registers']} "
        f"registers, {usage['spill_stores']} bytes of spill stores, {usage['spill_loads']} of "
        f"spill loads); max_abs_err {check[0]:.3e} (tol {tol:g} x max|plain| {check[1]:.3e}), "
        f"bitwise repeatable; {ms:.4f} ms (device {fmt_ms(dev_ms)}), the SIMT kernel on the "
        f"same inputs {simt_ms:.4f} ms (its output within {simt_err:.3e} of the wgmma route's), "
        f"plain {plain:.3f} ms, SDPA {lib:.4f} ms, bound {bms:.4f} ms ({by}: "
        f"{ops / 1e9:.1f} GFLOP at {PEAK_BF16_OPS / 1e12:g} T/s bf16)")
    return {"shape": f"q/k/v ({bh},{s},{d}) bf16 causal, groups 1", "route": took,
            "max_abs_err": check[0], "max_abs_plain": check[1], "tolerance": f"{tol:g} x max|plain|",
            "ms": ms, "device_ms": dev_ms, "simt_kernel_ms": simt_ms, "simt_vs_wgmma_err": simt_err,
            "plain_ms": plain, "library_ms": lib,
            "library_call": "scaled_dot_product_attention(is_causal)", "bound_ms": bms,
            "bound_by": by, "ptxas": usage}


def device_split(torch, fn) -> dict:
    """Device time of one call of ``fn`` by kernel family, from a torch.profiler
    trace: our two LM kernels, cuBLAS products, and the rest; ``copy`` is the
    part of the rest in copies and concatenations (memcpy, ``cat``, copy
    kernels); ``busy`` is the union of kernel intervals over the host wall of
    the call.  Empty when the trace holds no device events."""
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
    split = {"wkv": 0.0, "flash_attention": 0.0, "matmul": 0.0, "other": 0.0, "copy": 0.0}
    busy, cur_s, cur_e = 0.0, None, None
    for start, end, name in spans:
        low = name.lower()
        fam = ("wkv" if "wkv_" in low else "flash_attention" if "flash_kernel" in low
               else "matmul" if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass"))
               else "other")
        split[fam] += (end - start) / 1e3
        if fam == "other" and any(w in low for w in ("memcpy", "catarray", "copy_kernel")):
            split["copy"] += (end - start) / 1e3
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
            f"{sp['flash_attention_ms']:.1f}, other {sp['other_ms']:.1f} (of it copies "
            f"{sp['copy_ms']:.1f})")


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
                     "first_tokens": toks[0, :8].tolist(), "tokens": toks.tolist()}
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


# ---------------------------------------------------------------------------
# phase 13: every other decoder-only family served
# ---------------------------------------------------------------------------

# (arch, depth served at full width (None: the config's own), the card-vs-CPU
# check's depth at full width ("smoke": the SMOKE config)).  deepseek-67b's
# 95 layers are 134 GB of bf16 weights (1.38 GB a layer and 3.4 GB of
# embedding and head): 48 layers peaked at 72.03 GB on an H100 80GB HBM3 at
# 700 W, 1.40 GB a layer with its KV cache, so 50 is the deepest under
# SERVE2_PEAK_GB.  llama4's one MoE layer is 32 GB of bf16 experts, so it
# serves one dense and one MoE layer, and is checked at its SMOKE config (that
# layer is 64 GB in fp32).  zamba2 is checked at depth 7 = attn_every + 1, so
# that its shared block runs once.
SERVE2_MODELS = (("granite-3-2b", None, 2), ("stablelm-1.6b", None, 2),
                 ("granite-moe-3b-a800m", None, 2), ("zamba2-7b", None, 7),
                 ("chameleon-34b", None, 2), ("deepseek-67b", 50, 2),
                 ("llama4-maverick-400b-a17b", 2, "smoke"))
SERVE2_PEAK_GB = 76.0  # a served model's peak device memory, of the card's 80 GB
ROUTE_FLIP_MARGIN = 1e-5  # card vs CPU: a routing flip only between probabilities this close


def _attention_blocks(spec) -> int:
    return sum(bt in ("attn", "attn_moe", "shared_attn") for bt in spec.layers())


def _flash_route(spec, fa) -> str:
    """The route the model's prefill attention takes on the card."""
    import torch

    cfg = spec.cfg
    hd = 2 * cfg.d_model // cfg.n_heads if spec.has_shared_attn else cfg.hd
    return fa.kernel_route(getattr(torch, cfg.compute_dtype), hd), hd


def _routing_card_vs_cpu(tag: str, card: list, cpu: list) -> list:
    """Each MoE layer's expert ids and kept masks (each tile's, on a grid),
    card against CPU, by ``moe.compare_routings``: a flip is allowed where
    the two probabilities lie within ROUTE_FLIP_MARGIN (the CPU's) and is
    counted; from a tile's first flipped token on, that tile's later tokens
    see other inputs and are not compared (the logits and token gates still
    hold)."""
    from repro_torch.models import moe

    try:
        out = moe.compare_routings(card, cpu, ROUTE_FLIP_MARGIN)
    except ValueError as e:
        fail(f"{tag}: {e}")
    for r in out:
        if r["flips"]:
            log(f"[serve2] {tag} MoE layer {r['layer']} tile {r['tile']}: {r['flips']} routing "
                f"flips between probabilities within {r['max_margin']:.3e} (allowed: "
                f"{ROUTE_FLIP_MARGIN:g}); tokens from {r['first_flipped_token']} on not compared")
    return out


def phase_serve_families(torch) -> dict:
    """Phase 13: the dense, vlm, moe and hybrid families at full width through
    ``ServeEngine.generate`` (SERVE_BATCH x SERVE_PROMPT, SERVE_NEW greedy
    tokens), exact launch counts by route, then each model card vs CPU in
    fp32 at depth 2 (zamba2 7, llama4 its SMOKE config)."""
    import gc

    import numpy as np

    from repro_torch import configs, kernels
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    from repro_torch.serving import ServeConfig, ServeEngine

    t_phase = time.perf_counter()
    out = {}
    s_max = SERVE_PROMPT + SERVE_NEW
    for arch, depth, check_depth in SERVE2_MODELS:
        t_model = time.perf_counter()
        full = configs.get_config(arch)
        cfg = full if depth is None else full.replace(n_layers=depth)
        spec = lm.build_spec(cfg)
        route_name, hd = _flash_route(spec, fa)
        n_attn = _attention_blocks(spec)
        t0 = time.perf_counter()
        params = lm.init_params(spec, seed=0, device="cuda")
        eng = ServeEngine(spec, params, s_max=s_max, batch=SERVE_BATCH,
                          cfg=ServeConfig(max_new_tokens=SERVE_NEW), device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = lm.param_count(params)
        weights_gb = sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab, size=(SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
        eng.generate(prompts[:, :64])  # the one warm-up: cuBLAS handles and workspaces
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        toks = eng.generate(prompts)
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        st = eng.stats
        want = {name: 0 for name in counts} | {"flash_attention": n_attn}
        if route_name == "wgmma":
            want["flash_attention_wgmma"] = n_attn
        if counts != want:
            fail(f"serve {arch}: launch counts {counts} != {want} ({n_attn} attention blocks "
                 f"at head dim {hd}, the {route_name} route)")
        if toks.shape != (SERVE_BATCH, SERVE_NEW) or toks.min() < 0 or toks.max() >= cfg.vocab:
            fail(f"serve {arch}: tokens of shape {toks.shape} in [{toks.min()}, {toks.max()}] "
                 f"(want ({SERVE_BATCH}, {SERVE_NEW}) below vocab {cfg.vocab})")
        if peak > SERVE2_PEAK_GB:
            fail(f"serve {arch}: peak device memory {peak:.2f} GB > {SERVE2_PEAK_GB:g} GB")
        tokens = torch.from_numpy(prompts).long().cuda()
        with torch.inference_mode():
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = lm.prefill(spec, eng.params, tokens, s_max)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            c_pre = kernels.launch_counts()
            if not bool(torch.isfinite(logits[:, : cfg.vocab].float()).all()):
                fail(f"serve {arch}: prefill logits not finite")
            kernels.reset_launch_counts()
            tok = logits.float().argmax(-1)
            for _ in range(2):
                logits, cache = lm.decode_step(spec, eng.params, tok, cache)
                tok = logits.float().argmax(-1)
            if not bool(torch.isfinite(logits[:, : cfg.vocab].float()).all()):
                fail(f"serve {arch}: decode logits not finite")
            c_dec = kernels.launch_counts()
            del cache
            sp_pre = device_split(torch, lambda: lm.prefill(spec, eng.params, tokens, s_max))
        if c_pre != want:
            fail(f"serve {arch}: prefill launches {c_pre}, want {want}")
        if sum(c_dec.values()) != 0:
            fail(f"serve {arch}: decode launched kernels {c_dec}")
        if sp_pre:
            sp_pre["idle_share_unprofiled"] = max(0.0, 1.0 - sp_pre["busy_ms"] / (prefill_s * 1e3))
        step_ms = st.decode_s / st.decode_steps * 1e3
        tok_s = SERVE_BATCH * st.decode_steps / st.decode_s
        depth_note = ("full depth" if depth is None
                      else f"reduced from {full.n_layers} layers")
        log(f"[serve2] {arch} ({n_params / 1e9:.3f} B params, {weights_gb:.2f} GB of "
            f"{cfg.param_dtype} weights, {cfg.n_layers} layers, {depth_note}; {cfg.compute_dtype} "
            f"compute; init {init_s:.1f} s): batch {SERVE_BATCH} x prompt {SERVE_PROMPT}, "
            f"{SERVE_NEW} greedy tokens: time to first token {st.ttft_s * 1e3:.1f} ms; decode "
            f"{step_ms:.2f} ms/step, {tok_s:.1f} tok/s; peak device memory {peak:.2f} GB; "
            f"launches flash_attention {counts['flash_attention']} on the {route_name} route at "
            f"D={hd} (prefill {c_pre['flash_attention']}, decode 0); prefill alone "
            f"{prefill_s * 1e3:.1f} ms")
        log(f"[serve2] {arch} prefill under torch.profiler: {fmt_split(sp_pre)}"
            + (f"; against the unprofiled {prefill_s * 1e3:.1f} ms the card is idle "
               f"{100 * sp_pre['idle_share_unprofiled']:.1f}%" if sp_pre else ""))
        out[arch] = {"n_layers": cfg.n_layers, "full_n_layers": full.n_layers,
                     "reduced": depth is not None, "params": n_params, "weights_gb": weights_gb,
                     "param_dtype": cfg.param_dtype, "init_s": init_s,
                     "route": route_name, "head_dim": hd, "attention_blocks": n_attn,
                     "counts": counts, "prefill_counts": c_pre, "decode_counts": c_dec,
                     "ttft_ms": st.ttft_s * 1e3, "decode_ms_per_step": step_ms,
                     "decode_tok_s": tok_s, "peak_gb": peak, "prefill_ms": prefill_s * 1e3,
                     "prefill_device_split": sp_pre,
                     "first_tokens": toks[0, :8].tolist()}
        del params, eng, logits, tokens
        gc.collect()
        torch.cuda.empty_cache()
        out[arch]["card_vs_cpu"] = _serve2_card_vs_cpu(torch, arch, check_depth, np)
        out[arch]["seconds"] = time.perf_counter() - t_model
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[serve2] phase 13 in {out['seconds']:.1f} s ("
        + ", ".join(f"{a} {out[a]['seconds']:.1f}" for a, *_ in SERVE2_MODELS) + ")")
    return out


def _serve2_card_vs_cpu(torch, arch: str, depth, np) -> dict:
    """One model card against CPU: full width at ``depth`` ("smoke": the SMOKE
    config), fp32 compute, batch 2 x a ragged prompt of 100, 8 greedy tokens:
    tokens equal, prefill logits within 1e-3 of the largest, MoE routing per
    layer (_routing_card_vs_cpu)."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.models import moe
    from repro_torch.serving import ServeConfig, ServeEngine

    t0 = time.perf_counter()
    if depth == "smoke":
        cfg, setup = configs.get_smoke(arch), "SMOKE config"
    else:
        cfg = configs.get_config(arch).replace(n_layers=depth, compute_dtype="float32")
        setup = f"full width, depth {cfg.n_layers}"
    spec = lm.build_spec(cfg)
    params = lm.init_params(spec, seed=0, device="cuda")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 100)).astype(np.int32)
    res = {}
    for d in ("cuda", "cpu"):
        eng = ServeEngine(spec, params, s_max=108, cfg=ServeConfig(max_new_tokens=8), device=d)
        toks = eng.generate(prompts)
        with torch.inference_mode(), moe.record_routing() as routes:
            lg, _ = lm.prefill(spec, eng.params, torch.from_numpy(prompts).long().to(d), 108)
        res[d] = (toks, lg[:, : cfg.vocab].float().cpu(), routes)
        del eng, lg
    if not np.array_equal(res["cuda"][0], res["cpu"][0]):
        fail(f"serve {arch} card vs CPU: greedy tokens differ: {res['cuda'][0].tolist()} vs "
             f"{res['cpu'][0].tolist()}")
    err, scale = check_close(f"serve {arch} card vs CPU prefill logits", res["cuda"][1],
                             res["cpu"][1], 1e-3)
    routing = _routing_card_vs_cpu(f"serve {arch} card vs CPU", res["cuda"][2], res["cpu"][2])
    n_moe = spec.layers().count("attn_moe")
    log(f"[serve2] {arch} card vs CPU ({setup}, fp32, batch 2 x prompt 100, 8 new tokens, "
        f"{time.perf_counter() - t0:.1f} s): greedy tokens equal; prefill logits max |diff| "
        f"{err:.3e} (tol 1e-3 x max|logit| {scale:.3e})"
        + (f"; MoE routing of {n_moe} layers: flips {sum(r['flips'] for r in routing)}, "
           f"dropped slots {[r.get('dropped') for r in routing]}" if n_moe else ""))
    del params, res
    return {"setup": setup, "n_layers": cfg.n_layers, "tokens_equal": True, "logits_err": err,
            "max_logit": scale, "routing": routing, "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 14: the encoder-decoder family served (seamless-m4t-medium)
# ---------------------------------------------------------------------------

SEAMLESS = "seamless-m4t-medium"
SEAMLESS_FRAMES = 1024  # encoder positions of a request: frames (B, 1024, d_model)
SEAMLESS_SHORT = 256  # a second request's prompt against the same frames: S != T across


class _FlashShapes:
    """Records (q rows S, k rows T, causal) of every ``flash_attention`` call
    while installed, and how many calls each form (q and k shapes, groups,
    causal, dtype) took; the wrapper itself still counts its launches."""

    def __init__(self, fa):
        self.fa, self.calls, self.forms = fa, [], {}

    def __enter__(self):
        self.orig = self.fa.flash_attention

        def spy(q, k, v, *, causal=True, groups=1, q_offset=0):
            self.calls.append((q.shape[1], k.shape[1], bool(causal)))
            key = (tuple(q.shape), tuple(k.shape), int(groups), bool(causal), q.dtype)
            self.forms[key] = self.forms.get(key, 0) + 1
            return self.orig(q, k, v, causal=causal, groups=groups, q_offset=q_offset)

        self.fa.flash_attention = spy
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention = self.orig
        return False

    def summary(self) -> dict:
        return _call_summary(self.calls)


def _call_summary(calls) -> dict:
    """{"S=.. T=.. causal|non-causal": count} of (S, T, causal) triples."""
    out: dict = {}
    for s, t, causal in calls:
        key = f"S={s} T={t} {'causal' if causal else 'non-causal'}"
        out[key] = out.get(key, 0) + 1
    return out


def _seamless_calls(n_enc: int, n_dec: int, s: int, t: int) -> dict:
    """The flash_attention calls of one seamless prefill: the encoder over T
    frames, then each decoder block causal over the S-token prompt and across
    to the T encoder positions."""
    return _call_summary([(t, t, False)] * n_enc + [(s, s, True), (s, t, False)] * n_dec)


def _flash_form(torch, fa, ref, name: str, q, k, v, causal: bool, groups: int, tol: float,
                sdpa, route: str | None = None) -> dict:
    """The kernel at one of the path's shapes against its plain version, twice
    bitwise, timed beside the plain version, SDPA and the bound; with
    ``route``, the route the call must take ("wgmma" or "simt")."""
    before = fa.wgmma_launches
    got = fa.flash_attention(q, k, v, causal=causal, groups=groups)
    took = "wgmma" if fa.wgmma_launches > before else "simt"
    if route is not None and took != route:
        fail(f"flash_attention {name}: took the {took} route, want {route}")
    err, scale = check_close(name, got, ref.flash_attention(q, k, v, causal=causal,
                                                            groups=groups), tol)
    check_bitwise(torch, name, lambda: fa.flash_attention(q, k, v, causal=causal, groups=groups))
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=causal, groups=groups), reps=20)
    plain = time_ms(torch, lambda: ref.flash_attention(q, k, v, causal=causal, groups=groups),
                    reps=3)
    bhq, s, d = q.shape
    b4 = [x.view(1, -1, x.shape[1], d) for x in (q, k, v)]
    lib = time_ms(torch, lambda: sdpa(*b4, is_causal=causal, enable_gqa=True), reps=20)
    t = k.shape[1]
    pairs = bhq * (s * (s + 1) / 2 if causal else s * t)
    bms, by = bound_ms(4.0 * d * pairs, nbytes(q, k, v, q), PEAK_BF16_OPS)
    log(f"[kernels] flash_attention {name}: {took} route; max_abs_err {err:.3e} (tol {tol:g} x "
        f"max|plain| {scale:.3e}), bitwise repeatable; {ms:.4f} ms, plain {plain:.3f} ms, SDPA "
        f"{lib:.4f} ms, bound {bms:.4f} ms ({by})")
    return {"route": took, "max_abs_err": err, "max_abs_plain": scale, "tol": tol, "ms": ms,
            "plain_ms": plain, "library_ms": lib, "bound_ms": bms, "bound_by": by}


def _wkv_form(torch, name: str, bh: int, s: int, dh: int) -> dict:
    """The wkv kernel at one of the path's shapes (r/k/v bf16, the init's
    decays) against its plain version, twice bitwise, timed beside it."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv as wk

    g = torch.Generator(device="cuda").manual_seed(15)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    r, k, v = (randn(bh, s, dh).to(torch.bfloat16) for _ in range(3))
    lw = -torch.exp(randn(bh, s, dh) * 0.5 - 6.0)
    u = 0.1 * randn(bh, dh)
    err, scale = check_close(name, wk.wkv(r, k, v, lw, u), ref.wkv(r, k, v, lw, u), 2.0**-7)
    check_bitwise(torch, name, lambda: wk.wkv(r, k, v, lw, u))
    ms = time_ms(torch, lambda: wk.wkv(r, k, v, lw, u), reps=20)
    plain = time_ms(torch, lambda: ref.wkv(r, k, v, lw, u), reps=1)
    bms, by = bound_ms(4.0 * bh * s * dh * dh, nbytes(r, k, v, lw, u, r), sfu_ops=3.0 * bh * s * dh)
    log(f"[kernels] wkv {name}: max_abs_err {err:.3e} (tol {2.0**-7:g} x max|plain| {scale:.3e}), "
        f"bitwise repeatable; {ms:.4f} ms, plain {plain:.3f} ms, bound {bms:.4f} ms ({by})")
    return {"max_abs_err": err, "max_abs_plain": scale, "tol": 2.0**-7, "ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by}


def phase_seamless(torch, rows: list) -> dict:
    """Phase 14: seamless-m4t-medium at full width and depth (12 + 12 layers)
    through ``ServeEngine.generate(prompts, frames)``: SERVE_BATCH requests of
    a SERVE_PROMPT-token prompt over frames (B, SEAMLESS_FRAMES, d_model)
    fp32 (cast to bf16), SERVE_NEW greedy tokens; exact launch counts by
    route and by (S, T, causal); a second request of SEAMLESS_SHORT tokens
    over the same frames (cross-attention with S != T); the kernel at the
    path's shapes; then card vs CPU in fp32 at 2 + 2 layers, full width."""
    import gc

    import numpy as np

    from repro_torch import configs, kernels
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import lm
    from repro_torch.serving import ServeConfig, ServeEngine

    t_phase = time.perf_counter()
    log(f"[seamless] phase 14 starts with {torch.cuda.memory_allocated() / 1e9:.2f} GB in use")
    cfg = configs.get_config(SEAMLESS)
    spec = lm.build_spec(cfg)
    n_enc, n_dec = len(spec.enc_layers()), len(spec.layers())
    s_max = SERVE_PROMPT + SERVE_NEW
    t0 = time.perf_counter()
    params = lm.init_params(spec, seed=0, device="cuda")
    eng = ServeEngine(spec, params, s_max=s_max, batch=SERVE_BATCH,
                      cfg=ServeConfig(max_new_tokens=SERVE_NEW), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = lm.param_count(params)
    rng = np.random.default_rng(0)  # as the launcher draws them: prompts, then frames
    prompts = rng.integers(0, cfg.vocab, size=(SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    frames = rng.normal(size=(SERVE_BATCH, SEAMLESS_FRAMES, cfg.d_model)).astype(np.float32)
    eng.generate(prompts[:, :64], frames=frames[:, :64])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with _FlashShapes(fa) as shapes:
        toks = eng.generate(prompts, frames=frames)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    st = eng.stats
    n_calls = n_enc + 2 * n_dec
    want = {name: 0 for name in counts} | {"flash_attention": n_calls,
                                           "flash_attention_wgmma": n_calls}
    if counts != want:
        fail(f"seamless: launch counts {counts} != {want} (all on the tensor-core route)")
    t_len = SEAMLESS_FRAMES
    want_shapes = _seamless_calls(n_enc, n_dec, SERVE_PROMPT, t_len)
    if shapes.summary() != want_shapes:
        fail(f"seamless: flash_attention calls {shapes.summary()} != {want_shapes}")
    if toks.shape != (SERVE_BATCH, SERVE_NEW) or toks.min() < 0 or toks.max() >= cfg.vocab:
        fail(f"seamless: tokens of shape {toks.shape} in [{toks.min()}, {toks.max()}]")
    # the S != T request: a shorter prompt over the same frames
    kernels.reset_launch_counts()
    with _FlashShapes(fa) as shapes2:
        toks2 = eng.generate(prompts[:, :SEAMLESS_SHORT], frames=frames)
    counts2 = kernels.launch_counts()
    want2 = _seamless_calls(n_enc, n_dec, SEAMLESS_SHORT, t_len)
    if shapes2.summary() != want2 or counts2 != want:
        fail(f"seamless S != T request: calls {shapes2.summary()} != {want2}, counts {counts2}")
    if toks2.min() < 0 or toks2.max() >= cfg.vocab:
        fail("seamless S != T request: tokens out of range")
    ttft2 = eng.stats.ttft_s
    tokens = torch.from_numpy(prompts).long().cuda()
    fr = torch.from_numpy(frames).cuda()
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(spec, eng.params, tokens, s_max, frames=fr)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        if not bool(torch.isfinite(logits[:, : cfg.vocab].float()).all()):
            fail("seamless: prefill logits not finite")
        kernels.reset_launch_counts()
        tok = logits.float().argmax(-1)
        for _ in range(2):
            logits, cache = lm.decode_step(spec, eng.params, tok, cache)
            tok = logits.float().argmax(-1)
        if not bool(torch.isfinite(logits[:, : cfg.vocab].float()).all()):
            fail("seamless: decode logits not finite")
        if sum(kernels.launch_counts().values()):
            fail(f"seamless: decode launched kernels {kernels.launch_counts()}")
        del cache
        sp_pre = device_split(torch, lambda: lm.prefill(spec, eng.params, tokens, s_max,
                                                        frames=fr))
    if sp_pre:
        sp_pre["idle_share_unprofiled"] = max(0.0, 1.0 - sp_pre["busy_ms"] / (prefill_s * 1e3))
    step_ms = st.decode_s / st.decode_steps * 1e3
    log(f"[seamless] {SEAMLESS} ({n_params / 1e9:.3f} B params, {n_enc} + {n_dec} layers, full "
        f"depth, fp32 params, bf16 compute; init {init_s:.1f} s): batch {SERVE_BATCH} x prompt "
        f"{SERVE_PROMPT} over frames ({SERVE_BATCH}, {SEAMLESS_FRAMES}, {cfg.d_model}), "
        f"{SERVE_NEW} greedy tokens: time to first token {st.ttft_s * 1e3:.1f} ms; decode "
        f"{step_ms:.2f} ms/step, {SERVE_BATCH * st.decode_steps / st.decode_s:.1f} tok/s; peak "
        f"device memory {peak:.2f} GB; launches flash_attention {counts['flash_attention']} "
        f"({counts['flash_attention_wgmma']} on the wgmma route, D={cfg.hd}): "
        f"{shapes.summary()}; decode 0; prefill alone {prefill_s * 1e3:.1f} ms")
    log(f"[seamless] prompt {SEAMLESS_SHORT} over the same {SEAMLESS_FRAMES} frames: time to "
        f"first token {ttft2 * 1e3:.1f} ms; launches {shapes2.summary()}, all on the wgmma route")
    log(f"[seamless] prefill under torch.profiler: {fmt_split(sp_pre)}"
        + (f"; against the unprofiled {prefill_s * 1e3:.1f} ms the card is idle "
           f"{100 * sp_pre['idle_share_unprofiled']:.1f}%" if sp_pre else ""))
    out = {"params": n_params, "init_s": init_s, "counts": counts, "calls": shapes.summary(),
           "ttft_ms": st.ttft_s * 1e3, "decode_ms_per_step": step_ms, "peak_gb": peak,
           "prefill_ms": prefill_s * 1e3, "prefill_device_split": sp_pre,
           "short_prompt": {"counts": counts2, "calls": shapes2.summary(),
                            "ttft_ms": ttft2 * 1e3},
           "first_tokens": toks[0, :8].tolist()}
    del params, eng, logits, tokens, fr
    gc.collect()
    torch.cuda.empty_cache()

    # the kernel at the path's shapes (bf16, D = 64, the wgmma route)
    g = torch.Generator(device="cuda").manual_seed(14)
    bh = SERVE_BATCH * cfg.n_heads

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    forms = {}
    for name, s, t, causal in (
            (f"encoder q/k/v ({bh},{t_len},{cfg.hd}) non-causal", t_len, t_len, False),
            (f"cross q ({bh},{SEAMLESS_SHORT},{cfg.hd}) k/v ({bh},{t_len},{cfg.hd}) non-causal",
             SEAMLESS_SHORT, t_len, False)):
        forms[name] = _flash_form(torch, fa, ref, name, randn(bh, s, cfg.hd), randn(bh, t, cfg.hd),
                                  randn(bh, t, cfg.hd), causal, 1, 2.0**-7, sdpa)
    next(r for r in rows if r["name"] == "flash_attention")["seamless_forms"] = forms
    out["kernel_forms"] = forms
    out["card_vs_cpu"] = _seamless_card_vs_cpu(torch, np)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[seamless] phase 14 in {out['seconds']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _seamless_card_vs_cpu(torch, np) -> dict:
    """seamless at full width, 2 + 2 layers, fp32 compute, batch 2 x a ragged
    prompt of 100 over 64 frames (S != T across), 8 greedy tokens: tokens
    equal, prefill logits within 1e-3 of the largest (phase 13's gate);
    the card's prefill launches flash_attention 6 times (SIMT route, fp32)."""
    from repro_torch import configs, kernels
    from repro_torch.models import lm
    from repro_torch.serving import ServeConfig, ServeEngine

    t0 = time.perf_counter()
    cfg = configs.get_config(SEAMLESS).replace(enc_layers=2, dec_layers=2, n_layers=4,
                                               compute_dtype="float32")
    spec = lm.build_spec(cfg)
    params = lm.init_params(spec, seed=0, device="cuda")
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab, size=(2, 100)).astype(np.int32)
    frames = rng.normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    res = {}
    for d in ("cuda", "cpu"):
        eng = ServeEngine(spec, params, s_max=108, cfg=ServeConfig(max_new_tokens=8), device=d)
        toks = eng.generate(prompts, frames=frames)
        kernels.reset_launch_counts()
        with torch.inference_mode():
            lg, _ = lm.prefill(spec, eng.params, torch.from_numpy(prompts).long().to(d), 108,
                               frames=torch.from_numpy(frames).to(d))
        res[d] = (toks, lg[:, : cfg.vocab].float().cpu(), kernels.launch_counts())
        del eng, lg
    if res["cuda"][2]["flash_attention"] != 6 or res["cpu"][2]["flash_attention"] != 0:
        fail(f"seamless card vs CPU: launches {res['cuda'][2]} (card), {res['cpu'][2]} (CPU)")
    if not np.array_equal(res["cuda"][0], res["cpu"][0]):
        fail(f"seamless card vs CPU: greedy tokens differ: {res['cuda'][0].tolist()} vs "
             f"{res['cpu'][0].tolist()}")
    err, scale = check_close("seamless card vs CPU prefill logits", res["cuda"][1], res["cpu"][1],
                             1e-3)
    log(f"[seamless] card vs CPU (full width, 2 + 2 layers, fp32, batch 2 x prompt 100 over 64 "
        f"frames, 8 new tokens, {time.perf_counter() - t0:.1f} s): greedy tokens equal; prefill "
        f"logits max |diff| {err:.3e} (tol 1e-3 x max|logit| {scale:.3e}); the card's prefill "
        f"launched flash_attention 6 times (2 encoder, 2 causal, 2 across at S=100, T=64)")
    del params, res
    return {"tokens_equal": True, "logits_err": err, "max_logit": scale,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 15: training
# ---------------------------------------------------------------------------

# (arch, depth trained at full width (None: the config's own), batch, seq, steps)
TRAIN_MODELS = (("granite-3-2b", None, 8, 512, 4), (SEAMLESS, None, 4, 512, 2),
                ("rwkv6-3b", 4, 4, 512, 2))
# Card (the configs' bf16 compute) against the CPU (the same weights in fp32
# compute), the first step's loss and grad norm, relative.  Written before
# the first run: a bf16 rounding moves a value by at most u = 2^-9 of it; the
# loss of a 2-layer model sits behind about four roundings on its path to
# the logits (the layer inputs, the attention output, the MLP output, the
# logits), so at most 4u = 2^-7; the gradient passes those of the forward and
# as many again in the backward, and the kernel's P rounded to bf16: 2^-6.
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 2.0**-7, 2.0**-6
# rwkv6-3b's bf16 gradient at init is not within rounding of its fp32 one in
# the JAX package either (at the same weights on a CPU: grad norm 35.47
# against 71.68): the first position's WKV output is the bonus term alone,
# (sum r u k) v, a near-cancelled sum whose per-head std (median 0.066, down
# to 7.9e-5, against 16.6 at later positions) the group norm divides by.  Its
# grad norm against fp32 is reported, not gated; the fp32 check below gates it.
TRAIN_GNORM_UNGATED = ("rwkv6-3b",)
# Card against CPU both in fp32: loss and grad norm within 1e-3, relative.
# The same position-0 group norm makes rwkv6's fp32 gradient amplify
# last-bit differences: the port's and the JAX package's grad norms at the
# same weights differ by 1.9e-4 on a CPU.
TRAIN_FP32_RTOL = 1e-3
TRAIN_CHECK_DEPTH = 2  # layers of the card-vs-CPU models (seamless: 2 + 2)


def _train_calls(spec) -> tuple[str, int]:
    """(the path's kernel, its calls in one forward)."""
    if spec.layers()[0] == "rwkv":
        return "wkv", len(spec.layers())
    return "flash_attention", len(spec.enc_layers()) + len(spec.layers()) * (
        2 if spec.is_encdec else 1)


def _train_bound(spec, n_params: int, n_embed: int, tokens: int, seq: int) -> dict:
    """The least time of a step: its products on the bf16 tensor cores (2
    operations per parameter and token in the forward, again in the remat
    recompute and twice in the backward: 8; the embedding table only through
    the tied or separate unembedding, counted once as a matrix) plus the
    attention's products, and AdamW's bytes (p, g, m, v read, p, m, v
    written, fp32) at the HBM rate."""
    cfg = spec.cfg
    matmul_params = n_params - n_embed * (0 if cfg.tie_embeddings else 1)
    ops = 8.0 * matmul_params * tokens
    if _train_calls(spec)[0] == "flash_attention":
        # QK^T and PV: 4 S T D a head and sequence (causal: half), T = S (the
        # frames are as long as the tokens); the forward, its recompute and
        # the backward's two: x4
        pairs = sum({"attn": 0.5, "enc": 1.0, "dec": 1.5}[bt]
                    for bt in spec.enc_layers() + spec.layers())
        ops += 4 * 4.0 * cfg.hd * cfg.n_heads * (tokens // seq) * seq * seq * pairs
    opt_bytes = 7 * 4.0 * n_params
    return {"ops": ops, "ops_ms": ops / PEAK_BF16_OPS * 1e3, "optimizer_bytes": opt_bytes,
            "optimizer_ms": opt_bytes / PEAK_BYTES * 1e3,
            "bound_ms": ops / PEAK_BF16_OPS * 1e3 + opt_bytes / PEAK_BYTES * 1e3}


def phase_train(torch, rows: list) -> dict:
    """Phase 15: ``launch.train.train_loop`` on the card: granite-3-2b at full
    width and depth (AdamW, batch 8 x 512, 4 steps), seamless-m4t-medium (2
    steps with frames) and rwkv6-3b at 4 of 32 layers (2 steps, ``wkv`` in
    the step); exact launch counts (remat: each kernel twice a layer and
    step); the backward's attention share; card vs CPU at full width and
    TRAIN_CHECK_DEPTH layers; the restart check."""
    import gc

    from repro_torch import configs, kernels
    from repro_torch.launch.train import train_loop
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    log(f"[train] phase 15 starts with {torch.cuda.memory_allocated() / 1e9:.2f} GB in use")
    out = {}
    for arch, depth, batch, seq, steps in TRAIN_MODELS:
        t_model = time.perf_counter()
        full = configs.get_config(arch)
        cfg = full if depth is None else full.replace(n_layers=depth)
        spec = lm.build_spec(cfg)
        kernel, calls = _train_calls(spec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        hist: list = []
        params, opt, losses = train_loop(cfg, steps=steps, batch=batch, seq=seq, device="cuda",
                                         history=hist)
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        want = {name: 0 for name in counts} | {kernel: 2 * calls * steps}
        if kernel == "flash_attention":
            want["flash_attention_wgmma"] = 2 * calls * steps
        if counts != want:
            fail(f"train {arch}: launch counts {counts} != {want} ({calls} calls a forward, "
                 f"twice under remat, {steps} steps)")
        if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist):
            fail(f"train {arch}: a loss or grad norm is not finite: {hist}")
        n_params = lm.param_count(params)
        n_embed = params["embed"].numel()
        param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        opt_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(opt))
        tokens = batch * seq
        steady = hist[1:] if len(hist) > 1 else hist
        step_ms = sum(h["seconds"] for h in steady) / len(steady) * 1e3
        bound = _train_bound(spec, n_params, n_embed, tokens, seq)
        depth_note = "full depth" if depth is None else f"reduced from {full.n_layers} layers"
        log(f"[train] {arch} ({n_params / 1e9:.3f} B params, {len(spec.enc_layers()) + len(spec.layers())} "
            f"layers, {depth_note}; fp32 master weights, {cfg.compute_dtype} compute, remat "
            f"{cfg.remat}, {cfg.optimizer}): batch {batch} x seq {seq}, {steps} steps: "
            + "; ".join(f"step {i} loss {h['loss']:.4f} grad norm {h['grad_norm']:.4f} "
                        f"{h['seconds'] * 1e3:.1f} ms" for i, h in enumerate(hist)))
        log(f"[train] {arch}: {step_ms:.1f} ms a step after the first ({tokens / step_ms * 1e3:.0f} "
            f"tokens/s); peak device memory {peak:.2f} GB; launches {kernel} {counts[kernel]} "
            f"({calls} calls a forward x 2 (remat) x {steps} steps"
            + (f", all {counts['flash_attention_wgmma']} on the wgmma route"
               if kernel == "flash_attention" else "") + "); bound "
            f"{bound['bound_ms']:.1f} ms ({bound['ops'] / 1e12:.1f} TFLOP of products at "
            f"{PEAK_BF16_OPS / 1e12:g} TFLOP/s: {bound['ops_ms']:.1f} ms; AdamW's "
            f"{bound['optimizer_bytes'] / 1e9:.1f} GB at {PEAK_BYTES / 1e12:g} TB/s: "
            f"{bound['optimizer_ms']:.1f} ms), {100 * bound['bound_ms'] / step_ms:.1f}% of it")
        res = {"n_layers": cfg.n_layers, "reduced": depth is not None, "params": n_params,
               "batch": batch, "seq": seq, "steps": hist, "step_ms": step_ms,
               "tokens_per_s": tokens / step_ms * 1e3, "peak_gb": peak, "counts": counts,
               "bound": bound, "param_bytes": param_bytes, "opt_bytes": opt_bytes,
               "peak_bytes": torch.cuda.max_memory_allocated()}
        if arch == "granite-3-2b":
            res |= _train_split(torch, spec, params, opt, batch, seq, step_ms, rows)
        if kernel == "wkv":
            shape = (batch * cfg.d_model // cfg.rwkv_head_dim, seq, cfg.rwkv_head_dim)
            res["kernel_form"] = _wkv_form(torch, f"training ({shape[0]},{seq},{shape[2]}) bf16",
                                           *shape)
            next(r for r in rows if r["name"] == "wkv")["train_form"] = res["kernel_form"]
        del params, opt
        gc.collect()
        torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t_model
        out[arch] = res
    out["card_vs_cpu"] = {arch: _train_card_vs_cpu(torch, arch) for arch, *_ in TRAIN_MODELS}
    gc.collect()
    torch.cuda.empty_cache()
    out["restart"] = _train_restart(torch)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[train] phase 15 in {out['seconds']:.1f} s ("
        + ", ".join(f"{a} {out[a]['seconds']:.1f}" for a, *_ in TRAIN_MODELS) + ")")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _train_split(torch, spec, params, opt, batch: int, seq: int, step_ms: float,
                 rows: list) -> dict:
    """granite-3-2b: one more step under torch.profiler (device split); the
    kernel at one layer's shape against its plain version; the attention's
    gradient alone: FlashAttentionFn forward and backward at that shape
    (CUDA events) against the kernel forward alone, x the layers, as a
    share of the step."""
    from repro_torch.data import DataConfig, host_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import attention
    from repro_torch.training import OptConfig, make_train_step

    cfg = spec.cfg
    step = make_train_step(spec, OptConfig(lr=1e-3, warmup_steps=5, total_steps=10),
                           device="cuda")
    b = host_batch(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0), 4)
    sp = device_split(torch, lambda: step(params, opt, b))
    log(f"[train] {cfg.name} one step under torch.profiler: {fmt_split(sp)}")
    g = torch.Generator(device="cuda").manual_seed(15)
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = (torch.randn((batch, seq, h, hd), generator=g, device="cuda").to(torch.bfloat16)
               .requires_grad_(True) for h in (nh, nkv, nkv))
    gout = torch.randn((batch, seq, nh, hd), generator=g, device="cuda").to(torch.bfloat16)

    def heads_first(x):
        return x.detach().transpose(1, 2).reshape(-1, seq, hd).contiguous()

    form = _flash_form(torch, fa, ref, f"training q ({batch * nh},{seq},{hd}) k/v "
                       f"({batch * nkv},{seq},{hd}) bf16 causal, groups {nh // nkv}",
                       heads_first(q), heads_first(k), heads_first(v), True, nh // nkv, 2.0**-7,
                       torch.nn.functional.scaled_dot_product_attention)
    next(r for r in rows if r["name"] == "flash_attention")["train_form"] = form

    def fwd_bwd():
        out = attention._flash(cfg, q, k, v, causal=True)
        torch.autograd.grad(out, (q, k, v), gout)

    with torch.no_grad():
        fwd_ms = time_ms(torch, lambda: attention._flash(cfg, q, k, v, causal=True), reps=10)
    both_ms = time_ms(torch, fwd_bwd, reps=5)
    layers = len(spec.layers())
    # a step runs the forward twice (remat) and the backward once a layer
    bwd_step_ms = (both_ms - fwd_ms) * layers
    share = bwd_step_ms / step_ms
    log(f"[train] {cfg.name} attention gradient at q ({batch},{seq},{nh},{hd}) k/v "
        f"({batch},{seq},{nkv},{hd}) bf16 causal: kernel forward {fwd_ms:.3f} ms, forward and "
        f"the chunked fp32 backward {both_ms:.3f} ms; the backward x {layers} layers "
        f"{bwd_step_ms:.1f} ms, {100 * share:.1f}% of a {step_ms:.1f} ms step")
    return {"device_split": sp, "kernel_form": form, "attention_forward_ms": fwd_ms,
            "attention_fwd_bwd_ms": both_ms, "attention_backward_step_ms": bwd_step_ms,
            "attention_backward_share": share}


def _train_card_vs_cpu(torch, arch: str) -> dict:
    """The first train step on the card against the CPU (fp32 compute) from
    the same weights and batch (2 x 64): the card in bf16 compute (the
    kernels through their autograd Functions on the tensor-core route) with
    the loss within TRAIN_LOSS_RTOL and the grad norm within TRAIN_GNORM_RTOL
    (reported only for TRAIN_GNORM_UNGATED), and the card in fp32 with both
    within TRAIN_FP32_RTOL, relative."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, host_batch
    from repro_torch.models import lm
    from repro_torch.training import OptConfig, init_state, make_train_step
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    full = configs.get_config(arch)
    d = TRAIN_CHECK_DEPTH
    cfg = (full.replace(enc_layers=d, dec_layers=d, n_layers=2 * d) if full.family == "encdec"
           else full.replace(n_layers=d))
    spec = lm.build_spec(cfg)
    ocfg = OptConfig(name=cfg.optimizer, lr=1e-3, warmup_steps=5, total_steps=10)
    params, opt = init_state(spec, ocfg, seed=0, device="cuda")
    batch = host_batch(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2, seed=0,
                                  frames_dim=cfg.d_model if cfg.input_mode == "frames" else 0), 0)
    spec32 = lm.build_spec(cfg.replace(compute_dtype="float32"))
    metrics = {}
    for name, sp, dev in (("card bf16", spec, "cuda"), ("card fp32", spec32, "cuda"),
                          ("cpu fp32", spec32, "cpu")):
        p = tree_map(lambda t: t.detach().to(dev, copy=True).requires_grad_(True), params)
        o = tree_map(lambda t: t.to(dev, copy=True), opt)
        _, _, m = make_train_step(sp, ocfg, device=dev)(p, o, batch)
        metrics[name] = {k: float(v) for k, v in m.items()}
        del p, o
    del params, opt
    res = {**metrics, "seconds": time.perf_counter() - t0}
    ref = metrics["cpu fp32"]
    notes = []
    for name, key, tol in (("card bf16", "loss", TRAIN_LOSS_RTOL),
                           ("card bf16", "grad_norm", TRAIN_GNORM_RTOL),
                           ("card fp32", "loss", TRAIN_FP32_RTOL),
                           ("card fp32", "grad_norm", TRAIN_FP32_RTOL)):
        got = metrics[name][key]
        rel = abs(got - ref[key]) / abs(ref[key])
        res[f"{name} {key} rel"] = rel
        gated = not (name == "card bf16" and key == "grad_norm" and arch in TRAIN_GNORM_UNGATED)
        notes.append(f"{name} {key} {got:.6f} (relative {rel:.3e}, "
                     + (f"tol {tol:g})" if gated else "reported, not gated)"))
        if gated and not rel <= tol:
            fail(f"train {arch} card vs CPU: {key} {got:.6f} ({name}) against {ref[key]:.6f} "
                 f"(CPU, fp32): relative gap {rel:.3e} > {tol:g}")
    log(f"[train] {arch} card vs CPU (fp32), full width, "
        f"{len(spec.enc_layers()) + len(spec.layers())} layers, batch 2 x 64, first step "
        f"({res['seconds']:.1f} s): CPU loss {ref['loss']:.6f}, grad norm "
        f"{ref['grad_norm']:.6f}; " + "; ".join(notes))
    return res


def _train_restart(torch) -> dict:
    """granite-3-2b at full width, 2 layers, batch 4 x 256, under
    ``torch.use_deterministic_algorithms(True)``: three steps straight (A);
    two steps with a checkpoint at step 2 (B); a fresh ``train_loop`` that
    restores it and takes step 3 (C).  C's loss and final state must equal
    A's bitwise.  Ops without a deterministic implementation are named (the
    flag's warnings); then two straight runs without the flag show whether
    the path repeats without it."""
    import os
    import shutil
    import warnings

    from repro_torch import configs
    from repro_torch.launch.train import train_loop
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    cfg = configs.get_config("granite-3-2b").replace(n_layers=2)
    kw = dict(batch=4, seq=256, device="cuda", log_every=100)
    root = ROOT / "build" / "smoke_restart"
    shutil.rmtree(root, ignore_errors=True)
    prev_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # cuBLAS's deterministic workspaces
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pa, oa, la = train_loop(cfg, steps=3, ckpt_dir=str(root / "a"), ckpt_every=2, **kw)
            _, _, lb = train_loop(cfg, steps=2, ckpt_dir=str(root / "b"), ckpt_every=2, **kw)
            pc, oc, lc = train_loop(cfg, steps=3, ckpt_dir=str(root / "b"), **kw)
    finally:
        torch.use_deterministic_algorithms(False)
        if prev_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev_env
    nondet = sorted({str(w.message).split(" does not have")[0] for w in caught
                     if "deterministic" in str(w.message)})
    a_leaves, c_leaves = tree_leaves({"p": pa, "o": oa}), tree_leaves({"p": pc, "o": oc})
    diffs = [float((x.detach().double() - y.detach().double()).abs().max())
             for x, y in zip(a_leaves, c_leaves)]
    bitwise = lc == la[2:] and lb == la[:2] and all(torch.equal(x, y)
                                                    for x, y in zip(a_leaves, c_leaves))
    del pa, oa, pc, oc, a_leaves, c_leaves
    # without the flag: two straight runs of two steps
    _, _, l1 = train_loop(cfg, steps=2, **kw)
    _, _, l2 = train_loop(cfg, steps=2, **kw)
    shutil.rmtree(root, ignore_errors=True)
    res = {"deterministic_bitwise": bitwise, "losses_straight": la, "losses_first_two": lb,
           "loss_restored": lc, "max_abs_state_diff": max(diffs), "ops_without_deterministic":
           nondet, "without_flag_losses": [l1, l2], "without_flag_repeats": l1 == l2,
           "seconds": time.perf_counter() - t0}
    log(f"[train] restart (granite-3-2b, 2 layers, batch 4 x 256, deterministic algorithms on): "
        f"straight losses {la}; restored from the step-2 checkpoint, step 3 loss {lc}; final "
        f"parameters and moments {'bitwise equal' if bitwise else 'differ'} (max |diff| "
        f"{max(diffs):.3e}); ops the flag names as lacking a deterministic implementation: "
        f"{nondet or 'none'}; without the flag two straight runs give losses {l1} and {l2} "
        f"({'equal' if l1 == l2 else 'not equal'}) ({res['seconds']:.1f} s)")
    if not bitwise:
        fail(f"train restart: under deterministic algorithms the restored step 3 differs from "
             f"the uninterrupted run (losses {lc} vs {la[2:]}, max |state diff| {max(diffs):.3e}, "
             f"ops without a deterministic implementation {nondet})")
    return res


# ---------------------------------------------------------------------------
# phase 16: the dry run (every cell on the meta device) and its card anchors
# ---------------------------------------------------------------------------

DRYRUN_BUDGET_S = 120.0  # the phase's time limit, its anchors included
# the cells whose collective bytes phase 16 counts on the 16x16 meta grid
DRYRUN_COLLECTIVE_CELLS = (("granite-3-2b", "train_4k"), ("granite-3-2b", "prefill_32k"),
                           ("granite-3-2b", "decode_32k"))


def meta_anchor(tag: str, card: dict, spec, kind: str, batch: int, seq: int, grid, rules,
                path: str, *, steps: int = 1, **kw) -> dict:
    """The dry run's count of one step that a phase ran on the card's grid:
    the same spec, kind, batch, length and rules on a grid of meta tiles
    shaped as ``grid`` (``dryrun.extrapolated_moves``, from depths 1 and 2),
    times ``steps``, equal to the card's ``lm_moves()`` reading ``card`` of
    ``path``, kind by kind; ``kw`` goes to ``grid_step_moves`` (``s_max``,
    ``pos``, ``enc_len``, ``store_rules``, ``opt_name``)."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import as_grid

    t0 = time.perf_counter()
    mg = dryrun.meta_grid(as_grid(grid))
    shape = configs.ShapeSpec(f"{kind}_anchor", kind, seq, batch)
    moves, runs = dryrun.extrapolated_moves(spec, shape, mg, rules, **kw)
    meta = {k: v * steps for k, v in moves[path].items()}
    if meta != card:
        fail(f"{tag}: the meta count {meta} (depths {runs}, x {steps}) != the card's {card}")
    seconds = time.perf_counter() - t0
    log(f"{tag}: the dry run's meta count (depths {runs} extrapolated to "
        f"{dryrun._counts(spec)}, x {steps} steps) equals the card's counter: "
        + ", ".join(f"{k} {meta[f'{k}_bytes']:.0f} B ({meta[f'{k}s']:g})"
                    for k in ("gather", "reduce", "reduce_scatter", "permute")
                    if meta[f"{k}s"]) + f" ({seconds:.1f} s on the host)")
    return {"meta": meta, "depths_run": runs, "seconds": seconds}


def _dryrun_anchor(torch, train: dict) -> dict:
    """(b) granite-3-2b's phase-15 cell (batch 8 x 512, full width and depth,
    1x1) dry: parameter and optimizer bytes against phase 15's tensors on the
    card (exact), dot_flops against ``_train_bound``'s ops, the activation
    estimate (and one full-depth meta step's peak) against the card's peak."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import LogicalGrid
    from repro_torch.models import common as cm
    from repro_torch.models import lm

    arch, _, batch, seq, _ = TRAIN_MODELS[0]
    t15 = train[arch]
    grid = LogicalGrid(("data", "model"), (1, 1))
    shape = configs.ShapeSpec(f"train_b{batch}_s{seq}", "train", seq, batch)
    cell = dryrun.dry_cell(arch, shape, grid)
    if (cell["param_bytes_per_tile"], cell["opt_state_bytes_per_tile"]) != (
            t15["param_bytes"], t15["opt_bytes"]):
        fail(f"dryrun {arch} {shape.name}: parameter / optimizer bytes "
             f"{cell['param_bytes_per_tile']} / {cell['opt_state_bytes_per_tile']} != phase 15's "
             f"tensors on the card {t15['param_bytes']} / {t15['opt_bytes']}")
    spec = lm.build_spec(configs.get_config(arch))
    full = dryrun.run_step(spec, shape, batch, grid=grid, rules=dict(cm.DEFAULT_RULES))
    if full["dot_flops"] != cell["dot_flops"]:
        fail(f"dryrun {arch}: the full-depth step's dot_flops {full['dot_flops']:.6e} != the "
             f"extrapolated {cell['dot_flops']:.6e}")
    ops = t15["bound"]["ops"]
    est = cell["argument_bytes_per_tile"] + cell["activation_bytes_estimate"]
    out = {"cell": cell, "full_depth_peak_live_bytes": full["peak_live_bytes"],
           "train_bound_ops": ops, "dot_flops_over_bound_ops": cell["dot_flops"] / ops,
           "card_peak_bytes": t15["peak_bytes"], "estimate_over_card_peak": est / t15["peak_bytes"]}
    log(f"[dryrun] {arch} phase 15's cell (batch {batch} x {seq}, {spec.cfg.n_layers} layers, "
        f"1x1) on meta: parameters {cell['param_bytes_per_tile']} B and AdamW state "
        f"{cell['opt_state_bytes_per_tile']} B, equal to phase 15's tensors on the card; "
        f"dot_flops {cell['dot_flops']:.4e} against _train_bound's {ops:.4e} ops "
        f"({cell['dot_flops'] / ops:.4f}x; the full-depth meta step counts the same); "
        f"activation estimate {cell['activation_bytes_estimate'] / 1e9:.3f} GB (one full-depth "
        f"step: {full['peak_live_bytes'] / 1e9:.3f} GB) + arguments "
        f"{cell['argument_bytes_per_tile'] / 1e9:.3f} GB = {est / 1e9:.3f} GB against "
        f"torch.cuda.max_memory_allocated {t15['peak_bytes'] / 1e9:.3f} GB over phase 15's "
        f"{arch} run ({est / t15['peak_bytes']:.3f}x)")
    return out


class DryrunCells:
    """Phase 16 (a), started in a thread before the kernel build: ``dryrun
    --all --mesh both`` in a process a core and, meanwhile, the 16x16 chain
    cell on meta, one ``[dryrun]`` line a cell (per-tile GB against 80 GB).
    Nothing of it needs the card.  ``join()`` returns (records, chain, the
    cells' seconds) or raises what the work raised."""

    def __init__(self):
        self.box: dict = {}
        self.thread = threading.Thread(target=self._run)

    def _run(self):
        from repro_torch import configs
        from repro_torch.launch import dryrun

        try:
            t0 = time.perf_counter()
            chain_thread = threading.Thread(target=self._chain)
            chain_thread.start()
            want = {(a, s, "single") for a, s in DRYRUN_COLLECTIVE_CELLS}
            self.box["records"] = dryrun.run_cells(
                configs.all_cells(), ["single", "multi"], str(OUT / "dryrun_torch"), log=log,
                collectives=want)
            self.box["seconds"] = time.perf_counter() - t0
            chain_thread.join()
        except Exception as e:  # re-raised by join(), in the main thread
            self.box["error"] = e

    def _chain(self):
        from repro_torch.launch import dryrun

        try:
            self.box["chain"] = dryrun.dry_chain(65536, 6, log=log)
        except Exception as e:
            self.box["error"] = e

    def start(self) -> "DryrunCells":
        self.thread.start()
        return self

    def join(self) -> tuple:
        self.thread.join()
        if "error" in self.box:
            raise self.box["error"]
        return self.box["records"], self.box["chain"], self.box["seconds"]


def phase_dryrun(torch, train: dict, grid: dict, cells: tuple) -> dict:
    """Phase 16: (a) the cells and the 16x16 chain (``DryrunCells``'s
    ``cells``, run beside the kernel build): every cell ``ok``, the
    collective bytes counted (the grid step on meta tiles) for
    DRYRUN_COLLECTIVE_CELLS on the 16x16 grid only, each non-null and
    non-zero; (b) :func:`_dryrun_anchor`; (c) the 2x2 chain at n=10512, d=6
    on meta, whose moved bytes times phase 11's chain builds equal phase
    11's counter readings on the card exactly, for cannon and summa; (a)'s
    seconds and these under DRYRUN_BUDGET_S."""
    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    out_dir = OUT / "dryrun_torch"
    want = {(a, s, "single") for a, s in DRYRUN_COLLECTIVE_CELLS}
    records, chain, t_cells = cells
    bad = [f"{r['arch']} {r['shape']} {r['mesh']}: {r['error']}" for r in records
           if r["status"] != "ok"]
    if bad:
        fail(f"dryrun cells failed: {bad}")
    counted = [r for r in records if (r["arch"], r["shape"], "single") in want
               and r["mesh"] == {"data": 16, "model": 16}]
    if len(counted) != len(want):
        fail(f"dryrun: {len(counted)} cells with collectives, want {sorted(want)}")
    for r in counted:
        ana = r["analysis"]
        if not ana["collective_total_bytes"] or ana["collective_bytes"] is None:
            fail(f"dryrun {r['arch']} {r['shape']}: collective bytes {ana['collective_bytes']}")
        log(f"[dryrun] {r['arch']} {r['shape']} 16x16 collectives a tile (the grid step on meta "
            f"tiles, {r['collective_seconds']:.1f} s): "
            + ", ".join(f"{op} {b / 256 / 1e9:.4f} GB ({ana['collective_counts'][op]})"
                        for op, b in ana["collective_bytes"].items() if b))
    slowest = max(records, key=lambda r: r["seconds"])
    (out_dir / "chain__n65536__d6__16x16.json").write_text(json.dumps(chain, indent=1))
    anchor = _dryrun_anchor(torch, train)
    small = dryrun.dry_chain(N_MAIN, 6, rows=2, cols=2, schedules=("summa", "cannon"), log=log)
    for sched, r in small["schedules"].items():
        run = grid["main_path"][sched]
        want = {k: v * run["chain_builds"] for k, v in r["moves_analytic"].items()}
        if run["moved"] != {k: float(v) for k, v in want.items()}:
            fail(f"dryrun chain 2x2 {sched}: {r['moves_analytic']} moved a chain x "
                 f"{run['chain_builds']} builds != phase 11's counter on the card {run['moved']}")
        log(f"[dryrun] chain n={N_MAIN} d=6 2x2 {sched}: "
            f"{r['collective_total_bytes'] / 1e9:.4f} GB moved a chain x {run['chain_builds']} "
            f"builds equals phase 11's counter on the card")
    seconds = t_cells + time.perf_counter() - t_phase
    log(f"[dryrun] phase 16 in {seconds:.1f} s (the {len(records)} cells {t_cells:.1f} s in "
        f"{dryrun.worker_count()} processes beside the kernel build, slowest {slowest['arch']} "
        f"{slowest['shape']} "
        f"{slowest['mesh']['data']}-data {slowest['seconds']:.2f} s; the 16x16 chain "
        f"{chain['seconds']:.1f} s; limit {DRYRUN_BUDGET_S:.0f} s)")
    if seconds > DRYRUN_BUDGET_S:
        fail(f"phase 16 took {seconds:.1f} s, over its {DRYRUN_BUDGET_S:.0f} s limit")
    return {"cells": records, "chain_16x16": chain, "anchor": anchor, "chain_2x2": small,
            "seconds": seconds, "cells_seconds": t_cells}


# ---------------------------------------------------------------------------
# phase 10: the paper's workloads
# ---------------------------------------------------------------------------


def _inject_p(n: int) -> float:
    """Phase 10's injection rate: each of the n^2 entries of R with probability
    PAPER_PAIRS / n^2, so n^2 p / 2 = 150 and about 300 node pairs get an
    edge.  The JAX default 0.05 gives every node hundreds of injected edges at
    n=10512, and then every node is truth."""
    return PAPER_PAIRS / n ** 2


def _residual_floor(torch, l_mat, x, b) -> float:
    """fp32's forward-error bound for ||L x - b|| / ||b||: eps32 x || |L| |x| || / ||b||
    (in float64): how far an fp32 evaluation of the residual may stray, apart
    from any difference in x."""
    eps32 = torch.finfo(torch.float32).eps
    return float(eps32 * (l_mat.double().abs() @ x.double().abs()).norm() / b.double().norm())


def _paper_solver(torch, a1, cfg) -> dict:
    """``estimate_solution`` at q=1 and q=10 on A1's chain, with the embedding's
    right-hand sides (Y = B^T W^1/2 Q), and ``residual_norm`` of each."""
    from repro_torch.core import (chain_product, edge_projection, estimate_solution,
                                  laplacian, residual_norm)

    op = chain_product(a1, cfg.d, schedule=cfg.schedule, dtype=cfg.dtype, deflate=cfg.deflate,
                       fuse_l=cfg.fuse_l, device=a1.device)
    b = edge_projection(a1, cfg.seed, cfg.k_rp(int(a1.shape[0])))
    l_mat = laplacian.laplacian(a1, op.deg)
    out = {}
    for q in (1, 10):
        x = estimate_solution(op, b, q)
        out[q] = {"residual": float(residual_norm(l_mat, x, b)),
                  "floor": _residual_floor(torch, l_mat, x, b)}
    return out


def _paper_synthetic(torch, n: int, device: str) -> dict:
    """The synthetic transition on ``device``: ``gmm_graph_sequence`` and
    ``detect_anomalies`` with ``CLIMATE.commute``, then the solver calls."""
    from repro_torch.configs.caddelag import CLIMATE
    from repro_torch.core import detect_anomalies
    from repro_torch.graphs import gmm_graph_sequence

    cfg = CLIMATE.commute
    t0 = time.perf_counter()
    seq = gmm_graph_sequence(n, seed=0, inject_p=_inject_p(n), device=device)
    gen_s = time.perf_counter() - t0
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = detect_anomalies(seq.a1, seq.a2, cfg, top_k=TOP_K, device=device)
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    if res.scores.shape != (n,) or not bool(torch.isfinite(res.scores).all()):
        fail(f"paper n={n} on {device}: scores not finite of shape ({n},)")
    truth = seq.anomalous_nodes
    top = res.top_idx.tolist()
    out = {"res": res, "truth": truth, "components": seq.components, "gen_s": gen_s,
           "seconds": seconds, "peak_gb": peak,
           "precision20": len(set(top) & set(truth.tolist())),
           "strongest20": len(set(top) & set(truth[:TOP_K].tolist())),
           "solver": _paper_solver(torch, seq.a1, cfg)}
    if n <= N_PAPER_SMALL:  # the injection mask: A2 against the same draws without R
        clean = gmm_graph_sequence(n, seed=0, inject_p=0.0, device=device)
        out["mask"] = (seq.a2 != clean.a2).cpu().numpy()
    return out


def _check_topk_card_cpu(tag: str, card: list, cpu: list) -> None:
    """Per transition: top-k ids equal, or differing only between entries whose
    CPU scores lie within 1e-3 of the largest of each other."""
    for t, (rg, rc) in enumerate(zip(card, cpu, strict=True)):
        sc = rc.scores.cpu().numpy()
        tol = 1e-3 * float(abs(sc).max())
        g, c = rg.top_idx.tolist(), rc.top_idx.tolist()
        if g != c and _ranking_flips(g, c, sc, tol):
            fail(f"{tag} transition {t}: top-{len(c)} ids differ between card and CPU beyond ties "
                 f"within 1e-3 of the largest score: {g} vs {c}")
        log(f"[paper] {tag} transition {t}: top-{len(c)} ids "
            f"{'equal' if g == c else 'equal but for ties'} on card and CPU")


def _run_example(name: str, argv: list) -> tuple:
    """``examples/torch_<name>.py``'s ``main(argv)``: (its results, its printed
    lines, seconds)."""
    import contextlib
    import importlib.util
    import io

    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        results = mod.main(argv)
    return results, [ln for ln in buf.getvalue().splitlines() if ln.strip()], \
        time.perf_counter() - t0


def phase_paper(torch, smi: str) -> dict:
    """The paper's workloads through the port's entry points (phase 10):
    (a) the synthetic transition at n=10512 and the solver API, n=1536 card
    against CPU; (b) the tile-by-tile writer at n=10512 and the out-of-core
    chain and solver at n=4096; (c) the four examples, card against CPU at
    their defaults, then at full size on the card."""
    import gc
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import kernels

    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    out: dict = {}

    # (a) the synthetic benchmark, resident
    before = kernels.launch_counts()
    big = _paper_synthetic(torch, N_MAIN, "cuda")
    seg = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    want = {k: 0 for k in seg} | {"block_matmul": 3 * CHAIN_GEMMS, "edge_projection": 3,
                                  "cad_scores": 1}
    if seg != want:
        fail(f"paper n={N_MAIN}: launch counts {seg} != {want} (two chains for the transition, "
             f"one for the solver calls)")
    sol = big["solver"]
    log(f"[paper] synthetic n={N_MAIN} (gmm_graph_sequence, inject_p {_inject_p(N_MAIN):.4e}: "
        f"n^2 p / 2 = {PAPER_PAIRS // 2}; {big['truth'].size} truth nodes), CLIMATE.commute "
        f"(eps 1e-3, d=6, q=10, k={K_MAIN}): transition {big['seconds']:.3f} s, peak device "
        f"memory {big['peak_gb']:.2f} GB on {smi}; graphs built in {big['gen_s']:.2f} s (host draws "
        f"of R included); precision@{TOP_K} {big['precision20']}/{TOP_K}, overlap with the "
        f"{TOP_K} strongest truth nodes {big['strongest20']}/{TOP_K}; estimate_solution + "
        f"residual_norm: q=1 {sol[1]['residual']:.4e}, q=10 {sol[10]['residual']:.4e} (fp32 "
        f"floor {sol[10]['floor']:.1e}); launches {seg}")
    out["synthetic"] = {k: big[k] for k in ("seconds", "peak_gb", "gen_s", "precision20",
                                            "strongest20", "solver")}
    out["synthetic"] |= {"n": N_MAIN, "inject_p": _inject_p(N_MAIN),
                         "truth_nodes": int(big["truth"].size), "counts": seg}
    del big
    gc.collect()
    torch.cuda.empty_cache()
    # The same draws with no point noise (A2 = P + (R + R^T)/2): how much of
    # the ranking the injections alone decide at this n.
    from repro_torch.configs.caddelag import CLIMATE
    from repro_torch.core import detect_anomalies
    from repro_torch.graphs import gmm_graph_sequence

    seq = gmm_graph_sequence(N_MAIN, seed=0, noise=0.0, inject_p=_inject_p(N_MAIN), device="cuda")
    top = detect_anomalies(seq.a1, seq.a2, CLIMATE.commute, top_k=TOP_K).top_idx.tolist()
    quiet = {"precision20": len(set(top) & set(seq.anomalous_nodes.tolist())),
             "strongest20": len(set(top) & set(seq.anomalous_nodes[:TOP_K].tolist()))}
    log(f"[paper] synthetic n={N_MAIN} with noise 0 (the same injections; A2 - A1 is R alone): "
        f"precision@{TOP_K} {quiet['precision20']}/{TOP_K}, overlap with the {TOP_K} strongest "
        f"truth nodes {quiet['strongest20']}/{TOP_K}")
    out["synthetic"]["noise0"] = quiet
    del seq
    torch.cuda.empty_cache()

    small = {d: _paper_synthetic(torch, N_PAPER_SMALL, d) for d in ("cuda", "cpu")}
    g, c = small["cuda"], small["cpu"]
    for key in ("truth", "components", "mask"):
        if not np.array_equal(g[key], c[key]):
            fail(f"paper n={N_PAPER_SMALL}: {key} differs between card and CPU")
    sc = c["res"].scores.cpu().numpy()
    err = float(np.abs(g["res"].scores.cpu().numpy() - sc).max())
    scale = float(np.abs(sc).max())
    if err > 1e-3 * scale:
        fail(f"paper n={N_PAPER_SMALL}: card vs CPU max |diff| {err:.3e} > 1e-3 x {scale:.3e}")
    _check_topk_card_cpu(f"synthetic n={N_PAPER_SMALL}", [g["res"]], [c["res"]])
    res_line = []
    for q in (1, 10):
        rg, rc = g["solver"][q]["residual"], c["solver"][q]["residual"]
        # rel 1e-4 where fp32 resolves the residual; at its floor, the two
        # evaluations' rounding bounds on top
        tol = 1e-4 * rc + g["solver"][q]["floor"] + c["solver"][q]["floor"]
        if not abs(rg - rc) <= tol:
            fail(f"paper n={N_PAPER_SMALL} q={q}: residual {rg:.6e} on the card, {rc:.6e} on the "
                 f"CPU: |diff| > {tol:.3e} (1e-4 rel + both fp32 floors)")
        res_line.append(f"q={q} {rg:.6e} vs {rc:.6e} (rel diff {abs(rg - rc) / rc:.2e}; fp32 "
                        f"floor {c['solver'][q]['floor'] / rc:.2e} rel)")
    log(f"[paper] synthetic n={N_PAPER_SMALL} card vs CPU: truth ({g['truth'].size} nodes), "
        f"components and injection mask bitwise; scores max |diff| {err:.3e} ({err / scale:.2e} "
        f"of the largest, tol 1e-3); precision@{TOP_K} {g['precision20']} / {c['precision20']}; "
        f"residuals " + "; ".join(res_line))
    out["synthetic_small"] = {"n": N_PAPER_SMALL, "scores_rel_err": err / scale,
                              "residuals": {q: (g["solver"][q], c["solver"][q]) for q in (1, 10)}}
    del small, g, c
    gc.collect()

    # (b) the out-of-core writer and solver
    from repro_torch.core import (chain_product, edge_projection, estimate_solution, laplacian,
                                  reset_stream_stats, residual_norm, stream_stats)
    from repro_torch.graphs import gmm_points, gmm_store_sequence, similarity_graph
    from repro_torch.store import TileStore

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="smoke_paper_", dir=ROOT / "build"))
    try:
        store = TileStore.create(tmp / "n10512", n=N_MAIN, grid=STORE_GRID, codec="raw")
        t0 = time.perf_counter()
        ids = gmm_store_sequence(store, T_PAPER_STORE, seed=0)
        write_s = time.perf_counter() - t0
        pts, _ = gmm_points(N_MAIN, 0)
        a_card = similarity_graph(pts, device="cuda").cpu().numpy()
        tr, worst = store.tile_rows, 0.0
        for r in range(STORE_GRID):
            for cc in range(STORE_GRID):
                tile = store.read_tile(ids[0], r, cc, mmap=False)
                blk = a_card[r * tr:(r + 1) * tr, cc * tr:(cc + 1) * tr]
                if not np.allclose(tile, blk, rtol=1e-6, atol=1e-6):
                    fail(f"gmm_store_sequence tile ({r}, {cc}) differs from the card's "
                         f"similarity_graph beyond rtol 1e-6, atol 1e-6")
                worst = max(worst, float(np.abs(tile - blk).max()))
        del a_card
        log(f"[paper] gmm_store_sequence wrote {T_PAPER_STORE} snapshots of n={N_MAIN} tile by "
            f"tile ({STORE_GRID}x{STORE_GRID} tiles of {tr} rows, "
            f"{T_PAPER_STORE * store.snapshot_nbytes / 1e9:.2f} GB raw on disk) in {write_s:.1f} s; "
            f"every tile of {ids[0]} within rtol 1e-6, atol 1e-6 of the card's similarity_graph "
            f"(max |diff| {worst:.2e})")
        out["writer"] = {"n": N_MAIN, "t_steps": T_PAPER_STORE, "seconds": write_s,
                         "max_abs_diff": worst}
        store.remove_snapshot(ids[1])
        store.remove_snapshot(ids[0])

        store = TileStore.create(tmp / "n4096", n=N_OOC_SOLVE, grid=8, codec="raw")
        (sid,) = gmm_store_sequence(store, 1, seed=1)
        h = store.snapshot(sid)
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        op = chain_product(h, 6, oocore=True, use_gemm_kernel=True, device=torch.device("cuda"))
        y = edge_projection(h, 0, CLIMATE.commute.k_rp(N_OOC_SOLVE), device=torch.device("cuda"))
        torch.cuda.synchronize()
        chain_s = time.perf_counter() - t0
        sols, reads, secs = {}, {}, {}
        for batch in (1, 4):
            reset_stream_stats()
            t0 = time.perf_counter()
            sols[batch] = estimate_solution(op, y, 10, solver_batch=batch)
            torch.cuda.synchronize()
            secs[batch] = time.perf_counter() - t0
            reads[batch] = stream_stats().bytes_read
        op.release_scratch()
        seg = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        if not torch.equal(sols[1], sols[4]):
            fail("out-of-core estimate_solution: solver_batch 4 is not bitwise equal to 1")
        if not reads[1] >= 2 * reads[4] > 0:
            fail(f"out-of-core estimate_solution: scratch reads {reads[1]} (batch 1) vs "
                 f"{reads[4]} (batch 4), not 2x fewer")
        if min(seg["stream_gemm"], seg["fused_panel_matvec"], seg["edge_projection"]) == 0:
            fail(f"out-of-core chain and solve at n={N_OOC_SOLVE}: launch counts {seg}")
        a_dev = torch.from_numpy(h.to_numpy()).cuda()
        l_mat = laplacian.laplacian(a_dev, laplacian.degrees(a_dev))
        l_h = store.put_snapshot("L", l_mat.cpu().numpy())
        x = sols[1]
        r_res = float(residual_norm(l_mat, x, y))
        r_str = float(residual_norm(l_h, x, y, prefetch_depth=2))
        floor = _residual_floor(torch, l_mat, x, y)
        if not abs(r_str - r_res) <= 1e-5 * r_res + 2 * floor:
            fail(f"residual_norm on the store-backed L {r_str:.8e} vs resident {r_res:.8e}: "
                 f"beyond rel 1e-5 plus twice the fp32 floor {floor:.2e}")
        log(f"[paper] out-of-core n={N_OOC_SOLVE} from gmm_store_sequence (grid 8, host-RAM "
            f"scratch, kernels on): chain + edge_projection {chain_s:.2f} s; estimate_solution "
            f"q=10 solver_batch 1 {secs[1]:.3f} s / 4 {secs[4]:.3f} s, bitwise equal, scratch reads "
            f"{reads[1] / 1e6:.1f} / {reads[4] / 1e6:.1f} MB ({reads[1] / reads[4]:.2f}x fewer); "
            f"residual_norm store-backed {r_str:.8e} vs resident {r_res:.8e} (rel diff "
            f"{abs(r_str - r_res) / r_res:.2e}, fp32 floor {floor / r_res:.2e} rel); launches {seg}")
        out["oocore"] = {"n": N_OOC_SOLVE, "chain_s": chain_s, "solve_s": secs,
                         "scratch_read_bytes": reads, "residual_resident": r_res,
                         "residual_streamed": r_str, "residual_floor": floor, "counts": seg}
        del op, y, sols, a_dev, l_mat, x
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the examples: card against CPU at their defaults, then full size on the card
    old_tmp = tempfile.tempdir
    tempfile.tempdir = str(OUT)  # the telemetry example's run report lands under OUT
    try:
        ex = {}
        for name in ("quickstart", "climate_anomaly", "election_anomaly"):
            card, lines, secs = _run_example(name, ["--device", "cuda"])
            cpu, _, _ = _run_example(name, ["--device", "cpu"])
            _check_topk_card_cpu(f"{name} (defaults)", card, cpu)
            ex[name] = {"defaults_s": secs, "defaults_lines": lines}
        card, lines, secs = _run_example("training_telemetry_anomaly", ["--device", "cuda"])
        report = next(ln.split("-> ")[1] for ln in lines if "report ->" in ln)
        cpu, _, _ = _run_example("training_telemetry_anomaly",
                                 ["--device", "cpu", "--report", report])
        _check_topk_card_cpu("training_telemetry_anomaly (defaults, one report)", card, cpu)
        ex["training_telemetry_anomaly"] = {"defaults_s": secs, "defaults_lines": lines}
        full = {"climate_anomaly": ["--lat", "73", "--lon", "144", "--t-steps", "4"],
                "election_anomaly": ["--n", str(N_MAIN), "--t-steps", "3"]}
        for name, argv in full.items():
            _, lines, secs = _run_example(name, argv + ["--device", "cuda"])
            ex[name] |= {"full_s": secs, "full_lines": lines, "full_argv": argv}
    finally:
        tempfile.tempdir = old_tmp
    for name, e in ex.items():  # quickstart runs at its defaults only: phase 10a is its full size
        size = " ".join(e.get("full_argv", [])) or "its defaults"
        secs = e.get("full_s", e["defaults_s"])
        log(f"[paper] examples/torch_{name}.py at {size} on the card, {secs:.2f} s:")
        for ln in e.get("full_lines", e["defaults_lines"]):
            if not ln.startswith(("[telemetry] report", "[telemetry] generating")):
                log(f"[paper]   {ln}")
    out["examples"] = ex

    counts = kernels.launch_counts()
    path_kernels = ("block_matmul", "edge_projection", "cad_scores", "stream_gemm",
                    "fused_panel_matvec")
    if min(counts[k] for k in path_kernels) == 0 or any(
            counts[k] for k in ("panel_topk_update", "wkv", "flash_attention")):
        fail(f"phase 10 launch counts {counts}: want each of {path_kernels} launched, no other")
    log(f"[paper] phase 10 in {time.perf_counter() - t_phase:.1f} s; launches {counts}")
    out["counts"] = counts
    return out


# ---------------------------------------------------------------------------
# phase 11: the resident main path on a device grid (2x2 tiles on one card)
# ---------------------------------------------------------------------------

GRID_GEMM_LAUNCHES = {"xla": 4, "summa": 4, "cannon": 8}  # a 2x2 grid: R*C, R*C, R*C*R


def _phase2_inputs(torch):
    """Phase 2's inputs again, from its generator (seed 0) in its draw order:
    block_matmul's A and B at 10512^2, uniform [-1, 1), edge_projection's
    A, uniform [0, 1) with a zero diagonal (cad_scores' A1), and cad_scores'
    A2, Z1 and Z2."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def uniform(*shape, lo=0.0):
        return torch.rand(shape, generator=g, device=dev) * (1.0 - lo) + lo

    for _ in range(2):  # the ragged fp32 and bf16 operands
        uniform(1000, 777, lo=-1.0), uniform(777, 1030, lo=-1.0)
    a, b = uniform(N_MAIN, N_MAIN, lo=-1.0), uniform(N_MAIN, N_MAIN, lo=-1.0)
    a_ep = uniform(N_MAIN, N_MAIN)
    a_ep.diagonal().zero_()
    a2 = uniform(N_MAIN, N_MAIN)
    z1 = torch.randn((N_MAIN, K_MAIN), generator=g, device=dev)
    z2 = torch.randn((N_MAIN, K_MAIN), generator=g, device=dev)
    return a, b, a_ep, (a2, z1, z2)


def _grid_schedules(torch, rows: list, a, b) -> dict:
    """(a) The three schedules at 10512^2 on a 2x2 grid of cuda:0 against the
    1x1 kernel call: max |C - float64|, exact launches, CUDA-event ms; then
    summa on a 1x2 grid, and cannon on 1x2 refused."""
    from repro_torch import kernels
    from repro_torch.core import make_context, matmul
    from repro_torch.kernels import block_matmul as bm

    dev = torch.device("cuda")
    exact = torch.matmul(a.double(), b.double())
    one = bm.block_matmul(a, b)
    out = {"1x1": {"err_vs_fp64": float((one.double() - exact).abs().max()),
                   "ms": time_ms(torch, lambda: bm.block_matmul(a, b), reps=5)}}
    del one
    for shape, schedules in (((2, 2), ("xla", "summa", "cannon")), ((1, 2), ("summa",))):
        ctx = make_context([dev] * (shape[0] * shape[1]), shape[0])
        ga, gb = ctx.put_matrix(a), ctx.put_matrix(b)
        for schedule in schedules:
            kernels.reset_launch_counts()
            c = matmul(ga, gb, schedule=schedule)
            launches = kernels.launch_counts()["block_matmul"]
            want = shape[0] * shape[1] * (shape[0] if schedule == "cannon" else 1)
            if launches != want:
                fail(f"grid {shape} {schedule}: block_matmul launched {launches} times, want {want}")
            err = float((c.to_dense().double() - exact).abs().max())
            del c
            if err > BM_ERR64_BAR:
                fail(f"grid {shape} {schedule}: max |C - float64| {err:.3e} > {BM_ERR64_BAR:g}")
            ms = time_ms(torch, lambda: matmul(ga, gb, schedule=schedule), reps=3)
            key = f"{shape[0]}x{shape[1]} {schedule}"
            out[key] = {"err_vs_fp64": err, "ms": ms, "launches": launches}
            log(f"[grid] block_matmul {N_MAIN}^2 on {key} (one card, {shape[0] * shape[1]} "
                f"tiles): {launches} launches, max |C - float64| {err:.3e} (1x1 "
                f"{out['1x1']['err_vs_fp64']:.3e}), {ms:.3f} ms against the 1x1 call's "
                f"{out['1x1']['ms']:.3f} ms")
        if shape == (1, 2):
            try:
                matmul(ga, gb, schedule="cannon")
            except ValueError as e:
                if "square" not in str(e):
                    fail(f"cannon on 1x2 raised the wrong error: {e}")
                log(f"[grid] cannon on 1x2 refused: {e}")
            else:
                fail("cannon on a 1x2 grid did not raise")
        del ga, gb
    del exact
    torch.cuda.empty_cache()
    next(r for r in rows if r["name"] == "block_matmul")["grid_schedules"] = out
    return out


def _grid_edge_tiles(torch, rows: list, a) -> dict:
    """(b) edge_projection on each tile of a 2x2 grid at its global (row0,
    col0): against its plain version at phase 2's tolerance, twice bitwise,
    and the column tiles' sums against the whole-row call within 1e-5."""
    from repro_torch.kernels import edge_projection as ep
    from repro_torch.kernels import ref

    n, h, k, tol = N_MAIN, N_MAIN // 2, K_MAIN, 2e-5
    whole = ep.edge_projection(a, seed=0, k=k)
    tiles, sums = {}, {}
    for r0 in (0, h):
        parts = []
        for c0 in (0, h):
            blk = a[r0:r0 + h, c0:c0 + h].contiguous()
            got = ep.edge_projection(blk, seed=0, k=k, row0=r0, col0=c0)
            err, _ = check_close(f"edge_projection tile ({r0}, {c0})", got,
                                 ref.edge_projection(blk, seed=0, k=k, row0=r0, col0=c0), tol)
            check_bitwise(torch, f"edge_projection tile ({r0}, {c0})",
                          lambda: ep.edge_projection(blk, seed=0, k=k, row0=r0, col0=c0))
            tiles[f"{r0},{c0}"] = {"max_abs_err": err}
            parts.append(got)
            del blk
        err_sum, _ = check_close(f"edge_projection column tiles of rows {r0}..{r0 + h}",
                                 parts[0] + parts[1], whole[r0:r0 + h], 1e-5)
        sums[f"rows {r0}"] = err_sum
    blks = [a[r0:r0 + h, c0:c0 + h].contiguous() for r0 in (0, h) for c0 in (0, h)]
    origins = [(r0, c0) for r0 in (0, h) for c0 in (0, h)]
    ms4 = time_ms(torch, lambda: [ep.edge_projection(x, seed=0, k=k, row0=r0, col0=c0)
                                  for x, (r0, c0) in zip(blks, origins)], reps=5)
    del blks
    check = {"tol": f"{tol:g} x max|plain|", "tiles": tiles, "column_sum_max_abs_err": sums,
             "column_sum_tol": "1e-05 x max|whole|", "four_tiles_ms": ms4}
    tile_errs = ", ".join(f"{t} {v['max_abs_err']:.3e}" for t, v in tiles.items())
    sum_errs = ", ".join(f"{r} {e:.3e}" for r, e in sums.items())
    log(f"[grid] edge_projection on the four {h}x{h} tiles (row0, col0 in {{0, {h}}}): max_abs_err "
        f"{tile_errs} (tol {tol:g} x max|plain|), each bitwise repeatable; column-tile sums "
        f"against the whole-row call {sum_errs} (tol 1e-5 x max|whole|); the four tiles "
        f"{ms4:.4f} ms")
    next(r for r in rows if r["name"] == "edge_projection")["tile_check"] = check
    return check


def _grid_cad_tiles(torch, rows: list, a1, a2, z1, z2) -> dict:
    """(b) cad_scores_tile on each tile of a 2x2 grid, with the tile's Z rows
    and a different Z column slice, as the grid's scorer calls it: against
    its plain version at phase 2's tolerance, twice bitwise, and the column
    tiles' sums against the whole-row call within 1e-5."""
    from repro_torch.kernels import cad_score as cad
    from repro_torch.kernels import ref

    n, h, tol = N_MAIN, N_MAIN // 2, 1e-4
    v1, v2 = torch.tensor(10.0, device=a1.device), torch.tensor(12.5, device=a1.device)
    tiles, sums = {}, {}
    args4 = []
    for r0 in (0, h):
        ri = slice(r0, r0 + h)
        whole = cad.cad_scores_tile(a1[ri].contiguous(), a2[ri].contiguous(), z1[ri], z1, z2[ri],
                                    z2, v1, v2)
        parts = []
        for c0 in (0, h):
            cj = slice(c0, c0 + h)
            args = (a1[ri, cj].contiguous(), a2[ri, cj].contiguous(), z1[ri], z1[cj], z2[ri],
                    z2[cj], v1, v2)
            got = cad.cad_scores_tile(*args)
            err, _ = check_close(f"cad_scores tile ({r0}, {c0})", got, ref.cad_scores_tile(*args),
                                 tol)
            check_bitwise(torch, f"cad_scores tile ({r0}, {c0})",
                          lambda: cad.cad_scores_tile(*args))
            tiles[f"{r0},{c0}"] = {"max_abs_err": err}
            parts.append(got)
            args4.append(args)
        err_sum, _ = check_close(f"cad_scores column tiles of rows {r0}..{r0 + h}",
                                 parts[0] + parts[1], whole, 1e-5)
        sums[f"rows {r0}"] = err_sum
        del whole
    ms4 = time_ms(torch, lambda: [cad.cad_scores_tile(*x) for x in args4], reps=5)
    del args4
    check = {"tol": f"{tol:g} x max|plain|", "tiles": tiles, "column_sum_max_abs_err": sums,
             "column_sum_tol": "1e-05 x max|whole|", "four_tiles_ms": ms4}
    tile_errs = ", ".join(f"{t} {v['max_abs_err']:.3e}" for t, v in tiles.items())
    sum_errs = ", ".join(f"{r} {e:.3e}" for r, e in sums.items())
    log(f"[grid] cad_scores on the four {h}x{h} tiles (Z rows at row0, Z columns at col0, both "
        f"in {{0, {h}}}): max_abs_err {tile_errs} (tol {tol:g} x max|plain|), each bitwise "
        f"repeatable; column-tile sums against the whole-row call {sum_errs} (tol 1e-5 x "
        f"max|whole|); the four tiles {ms4:.4f} ms")
    next(r for r in rows if r["name"] == "cad_scores")["tile_check"] = check
    return check


def _grid_main_path(torch, resident: dict, s64, schedule: str) -> dict:
    """(c) Phase 3's resident main path on a 2x2 grid of cuda:0: exact launch
    counts, seconds per transition, peak memory, scores against phase 3's."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import CommuteConfig, SequenceDetector, make_context
    from repro_torch.graphs import climate_snapshot_sequence

    from repro_torch.core.distmatrix import grid_moves
    from repro_torch.obs import REGISTRY

    ctx = make_context([torch.device("cuda")] * 4, 2)
    cfg = CommuteConfig(eps_rp=1e-3, d=6, q=10, schedule=schedule)
    seq = climate_snapshot_sequence(73, 144, t_steps=3, ctx=ctx)
    det = SequenceDetector(cfg, top_k=TOP_K, ctx=ctx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    moves0, builds0 = grid_moves()[schedule], REGISTRY.value("chain.builds")
    t0 = time.perf_counter()
    res = det.run(seq.snapshots())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    moved = {k: v - moves0[k] for k, v in grid_moves()[schedule].items()}
    builds = int(REGISTRY.value("chain.builds") - builds0)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {name: 0 for name in counts} | {
        "block_matmul": 3 * CHAIN_GEMMS * GRID_GEMM_LAUNCHES[schedule],
        "edge_projection": 3 * 4, "cad_scores": 2 * 4}
    if counts != want:
        fail(f"grid {schedule} main-path launch counts {counts} != {want}")
    errs, near = [], {}
    for t, r in enumerate(res.transitions):
        sg, s3 = r.scores.cpu().numpy(), resident["scores"][t]
        scale = float(np.abs(s3).max())
        err = float(np.abs(sg - s3).max())
        if not np.isfinite(sg).all() or err > 1e-3 * scale:
            fail(f"grid {schedule} transition {t}: max |diff| against phase 3 {err:.3e} > 1e-3 x "
                 f"{scale:.3e}")
        ids, ids3 = r.top_idx.tolist(), resident["top_idx"][t]
        if t == 0:  # which run is nearer the float64 chain's scores
            s64n = s64.numpy()
            near = {"grid": float(np.abs(sg - s64n).max()), "phase3": float(np.abs(s3 - s64n).max())}
        if ids != ids3 and _ranking_flips(ids, ids3, s3, 1e-3 * scale):
            fail(f"grid {schedule} transition {t}: top-{TOP_K} ids {ids} differ from phase 3's "
                 f"{ids3} beyond ties within 1e-3 of the largest score (max |score - float64| "
                 f"at transition 0: grid {near['grid']:.3e}, phase 3 {near['phase3']:.3e})")
        errs.append(err / scale)
        log(f"[grid] {schedule} 2x2 transition {t}->{t + 1}: {res.transition_seconds[t]:.3f} s "
            f"(phase 3: {resident['seconds'][t]:.3f} s); max |diff| against phase 3 {err:.3e} "
            f"({err / scale:.3e} of its largest score); top-{TOP_K} ids "
            f"{'equal' if ids == ids3 else 'equal but for ties'}")
    log(f"[grid] {schedule} 2x2 (one card, 4 tiles) n={N_MAIN} T=3: run wall {wall:.3f} s "
        f"(phase 3 {resident['wall']:.3f} s); launches {counts}; peak device memory {peak:.2f} GB "
        f"(phase 3 {resident['peak']:.2f} GB); transition 0 max |score - float64 chain| grid "
        f"{near['grid']:.4e}, phase 3 {near['phase3']:.4e}")
    log(f"[grid] {schedule} 2x2 tile moves between grid positions over {builds} chain builds: "
        f"{moved['gather_bytes'] / 1e9:.4f} GB in {moved['gathers']:.0f} gathers, "
        f"{moved['permute_bytes'] / 1e9:.4f} GB in {moved['permutes']:.0f} permutes "
        f"(one card: counted as four cards would move them)")
    return {"counts": counts, "wall": wall, "seconds": res.transition_seconds, "peak_gb": peak,
            "max_rel_diff_vs_phase3": errs, "vs_float64_t0": near, "moved": moved,
            "chain_builds": builds}


def phase_grid(torch, rows: list, resident: dict, s64) -> dict:
    """Phase 11: the grid's schedules, edge_projection and cad_scores per
    tile, the resident main path on a 2x2 grid of one card with cannon and
    with summa, n=1536 on the grid card against CPU, and a 2x2 grid of cards
    refused on one card."""
    from repro_torch.core import CommuteConfig, SequenceDetector, make_context
    from repro_torch.graphs import climate_snapshot_sequence
    from repro_torch.launch import caddelag_run

    t_phase = time.perf_counter()
    out: dict = {}
    a, b, a_ep, cad_in = _phase2_inputs(torch)
    out["schedules"] = _grid_schedules(torch, rows, a, b)
    del a, b
    out["edge_projection_tiles"] = _grid_edge_tiles(torch, rows, a_ep)
    out["cad_scores_tiles"] = _grid_cad_tiles(torch, rows, a_ep, *cad_in)
    del a_ep, cad_in
    torch.cuda.empty_cache()
    runs = {s: _grid_main_path(torch, resident, s64, s) for s in ("cannon", "summa")}
    out["main_path"] = runs
    torch.cuda.empty_cache()

    cfg = CommuteConfig(eps_rp=1e-3, d=6, q=10)  # (d) n=1536, card grid against CPU grid
    res = {}
    for dev in ("cuda", "cpu"):
        ctx = make_context([dev] * 4, 2)
        seq = climate_snapshot_sequence(32, 48, t_steps=3, ctx=ctx)
        res[dev] = SequenceDetector(cfg, top_k=TOP_K, ctx=ctx).run(seq.snapshots())
    out["n=1536 card vs cpu"] = check_card_vs_cpu("n=1536 2x2 grid", res["cuda"], res["cpu"])

    try:  # (e) a grid of cards needs as many cards
        caddelag_run.main(["--data", "2", "--model", "2", "--n", "64"])
    except ValueError as e:
        if f"has {torch.cuda.device_count()}" not in str(e):
            fail(f"--data 2 --model 2 on one card raised without the device count: {e}")
        log(f"[grid] caddelag-run-torch --data 2 --model 2 refused: {e}")
    else:
        fail("caddelag-run-torch --data 2 --model 2 ran on one card")
    counts = {k: sum(r["counts"][k] for r in runs.values()) for k in runs["cannon"]["counts"]}
    out["counts"] = counts
    log(f"[grid] phase 11 in {time.perf_counter() - t_phase:.1f} s; main-path launches {counts}")
    return out


# ---------------------------------------------------------------------------
# phase 12: the out-of-core, store-streamed and incremental paths on a device
# grid (2x2 tiles on one card)
# ---------------------------------------------------------------------------

STORE_GRID_12 = 8  # phase 12's input store: 1314-row panels (657 rows do not split in 2)
T_GRID_OOC = 2  # snapshots of phase 12 (a): one transition, phase 5's transition 0
T_GRID_SMALL = 2  # and of its n=1536 out-of-core and publishing runs (c), cut for time
T_GRID_INC = 3  # and of its n=1536 incremental runs (c), cut from phase 7's 4 for time


def _ctx(torch, dev: str, rows: int = 2, cols: int = 2):
    from repro_torch.core import make_context

    return make_context([torch.device(dev) if dev == "cuda" else dev] * (rows * cols), rows)


def _grid_h2d(torch) -> dict:
    """The grid pipeline's host-to-device choice, measured on one 1314 x 10512
    fp32 panel: a column half of a pinned panel (not contiguous) against a
    contiguous pinned tile of the same bytes, each copied with
    ``non_blocking=True``.  The host time of the call, whether the copy was
    still running when the call returned (it was asynchronous), and the time
    to the copy's end; then the host copy into one pinned buffer, row-major
    as the one-device pipeline fills it against tile-major as the grid's."""
    import numpy as np

    dev = torch.device("cuda")
    ph, n = PH_OOC, N_MAIN
    host = np.random.default_rng(0).random((ph, n), dtype=np.float32)
    pinned = torch.from_numpy(host).pin_memory()
    tile = pinned[:, : n // 2].contiguous().pin_memory()
    out = {}
    for label, src in (("pinned column slice (not contiguous)", pinned[:, : n // 2]),
                       ("pinned contiguous tile", tile)):
        walls, ends, asyncs = [], [], []
        for _ in range(4):
            torch.cuda.synchronize()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            d = src.to(dev, non_blocking=True)
            walls.append((time.perf_counter() - t0) * 1e3)
            asyncs.append(not torch.cuda.current_stream().query())
            stop.record()
            stop.synchronize()
            ends.append(start.elapsed_time(stop))
            del d
        out[label] = {"mb": ph * (n // 2) * 4 / 1e6, "host_call_ms": float(np.median(walls[1:])),
                      "copy_end_ms": float(np.median(ends[1:])),
                      "returned_before_the_copy_ended": sum(asyncs[1:])}
    copies = {}
    buf = torch.empty((ph, n), dtype=torch.float32, pin_memory=True)
    tiled = torch.empty((2, 2, ph // 2, n // 2), dtype=torch.float32, pin_memory=True)
    for label, fn in (("row-major", lambda: np.copyto(buf.numpy(), host)),
                      ("tile-major 2x2", lambda: np.copyto(
                          tiled.numpy(), host.reshape(2, ph // 2, 2, n // 2).transpose(0, 2, 1, 3)))):
        fn()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        copies[label] = (time.perf_counter() - t0) / 5 * 1e3
    out["host copy into pinned (ms)"] = copies
    nc, ct = out["pinned column slice (not contiguous)"], out["pinned contiguous tile"]
    log(f"[h2d] grid tiles of one {ph}x{n} fp32 panel, {nc['mb']:.1f} MB a column half: a pinned "
        f"column slice (not contiguous) takes {nc['host_call_ms']:.3f} ms of host time a call and "
        f"returned before its copy ended {nc['returned_before_the_copy_ended']}/3 times (copy end "
        f"{nc['copy_end_ms']:.3f} ms); a contiguous pinned tile {ct['host_call_ms']:.3f} ms of host "
        f"time, returned first {ct['returned_before_the_copy_ended']}/3 times (copy end "
        f"{ct['copy_end_ms']:.3f} ms); host copy of the panel into pinned memory row-major "
        f"{copies['row-major']:.2f} ms, tile-major 2x2 {copies['tile-major 2x2']:.2f} ms")
    return out


def _grid_oocore_tiles(torch, rows: list) -> dict:
    """Each kernel of (a) on one panel tile at the shapes that run gives it
    (ph = 1314, a 2x2 grid: tiles of 657 x 5256): the K step's
    (657 x 1314) @ (1314 x 5256) into its accumulator tile, the chi / solve
    product (657 x 5256) @ (5256 x 17), edge_projection and cad_scores on
    the tile at global (row0, col0) = (1971, 5256) with its Z rows and
    columns.  Against the plain versions at phase 2's tolerances, twice
    bitwise, CUDA-event ms beside the plain version's; for the two
    ``stream_gemm`` tiles also the one PyTorch call of the same function
    (``torch.addmm``, ``torch.mm``) and the bound (the K step's three TF32
    products at 495 TFLOP/s, as phase 2's row; the solve's bytes)."""
    from repro_torch.kernels import cad_score as cad
    from repro_torch.kernels import edge_projection as ep
    from repro_torch.kernels import ref
    from repro_torch.kernels import stream_gemm as sg

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    ph, n, k = PH_OOC, N_MAIN, K_MAIN
    pr, pc = ph // 2, n // 2
    row0, col0 = ph + pr, pc

    def uniform(*shape, lo=0.0):
        return torch.rand(shape, generator=g, device=dev) * (1.0 - lo) + lo

    left, right, acc = uniform(pr, ph, lo=-1.0), uniform(ph, pc, lo=-1.0), uniform(pr, pc, lo=-1.0)
    p_tile, y_cols = uniform(pr, pc, lo=-1.0), torch.randn((pc, k), generator=g, device=dev)
    a1, a2 = uniform(pr, pc), uniform(pr, pc)
    z1i, z1j, z2i, z2j = (torch.randn(shape, generator=g, device=dev)
                          for shape in ((pr, k), (pc, k), (pr, k), (pc, k)))
    scratch = torch.empty((sg.scratch_elems(pr, pc, ph),), dtype=torch.float32, device=dev)
    # (library call, bound (ms, by)) of the two stream_gemm tiles
    extra = {
        "stream_gemm": (lambda: torch.addmm(acc, left, right),
                        bound_ms(3 * 2.0 * pr * ph * pc, nbytes(left, right, acc) + pr * pc * 4.0,
                                 PEAK_TF32_OPS)),
        "stream_gemm skinny": (lambda: torch.mm(p_tile, y_cols),
                               bound_ms(2.0 * pr * pc * k, nbytes(p_tile, y_cols) + pr * k * 4.0)),
    }
    cases = {
        "stream_gemm": (f"K step tile ({pr}x{ph})@({ph}x{pc}) + init", 2e-5,
                        lambda: sg.stream_gemm(left, right, acc, scratch=scratch),
                        lambda: ref.stream_gemm(left, right, acc)),
        "stream_gemm skinny": (f"solve tile ({pr}x{pc})@({pc}x{k})", 2e-5,
                               lambda: sg.stream_gemm(p_tile, y_cols),
                               lambda: ref.stream_gemm(p_tile, y_cols)),
        "edge_projection": (f"panel tile {pr}x{pc} at ({row0}, {col0})", 2e-5,
                            lambda: ep.edge_projection(a1, seed=0, k=k, row0=row0, col0=col0),
                            lambda: ref.edge_projection(a1, seed=0, k=k, row0=row0, col0=col0)),
        "cad_scores": (f"panel tile {pr}x{pc} with its Z rows and columns", 1e-4,
                       lambda: cad.cad_scores_tile(a1, a2, z1i, z1j, z2i, z2j, 10.0, 12.5),
                       lambda: ref.cad_scores_tile(a1, a2, z1i, z1j, z2i, z2j, 10.0, 12.5)),
    }
    out = {}
    for name, (shape, tol, fn, plain) in cases.items():
        err, scale = check_close(f"{name} {shape}", fn(), plain(), tol)
        check_bitwise(torch, f"{name} {shape}", fn)
        ms, plain_ms = time_ms(torch, fn, reps=10), time_ms(torch, plain, reps=3)
        out[name] = {"shape": shape, "max_abs_err": err, "max_abs_plain": scale,
                     "tol": f"{tol:g} x max|plain|", "ms": ms, "plain_ms": plain_ms}
        lib_s = ""
        if name in extra:
            call, (bms, by) = extra[name]
            lib = time_ms(torch, call, reps=10)
            out[name] |= {"library_ms": lib, "library_call": "torch.addmm" if name == "stream_gemm"
                          else "torch.mm", "bound_ms": bms, "bound_by": by}
            lib_s = (f", {out[name]['library_call']} {lib:.4f} ms, bound {bms:.4f} ms ({by})")
        row = next(r for r in rows if r["name"] == name.split()[0])
        row.setdefault("grid_oocore_tiles", {})[shape] = out[name]
        log(f"[grid oocore] {name} {shape}: max_abs_err {err:.3e} (tol {tol:g} x max|plain| "
            f"{scale:.3e}), bitwise repeatable; {ms:.4f} ms, plain {plain_ms:.3f} ms{lib_s}")
    return out


def _grid_oocore(torch, oocore: dict, s5_t0) -> dict:
    """(a) The out-of-core main path on a 2x2 grid of cuda:0 at n=10512: the
    first two snapshots of phase 5's sequence in a raw store of grid 8 on disk,
    a host-RAM scratch, the stream_gemm kernels; exact launch counts, scores
    against phase 5's transition 0."""
    import gc
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import CommuteConfig, SequenceDetector, reset_stream_stats, stream_stats
    from repro_torch.graphs import climate_snapshot_sequence
    from repro_torch.obs import REGISTRY, disable_tracing, enable_tracing
    from repro_torch.store import TileStore

    ctx = _ctx(torch, "cuda")
    R, C = ctx.n_row_shards, ctx.n_col_shards
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="smoke_grid_store_", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        # phase 3's sequence (the generator's draws depend on t_steps); two snapshots are stored
        seq = climate_snapshot_sequence(73, 144, t_steps=T_MAIN, device="cuda")
        store = TileStore.create(tmp, n=N_MAIN, grid=STORE_GRID_12, codec="raw")
        for t, a in zip(range(T_GRID_OOC), seq.snapshots()):
            store.put_snapshot(f"t{t:04d}", a.cpu().numpy())
            del a
        del seq
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[grid oocore] wrote {T_GRID_OOC} snapshots of n={N_MAIN} into a raw "
            f"{STORE_GRID_12}x{STORE_GRID_12} tile store on disk in {time.perf_counter() - t0:.1f} s")
        handles = [store.snapshot(f"t{t:04d}") for t in range(T_GRID_OOC)]
        cfg = CommuteConfig(eps_rp=1e-3, d=6, q=10, oocore=True, use_gemm_kernel=True)
        det = SequenceDetector(cfg, top_k=TOP_K, ctx=ctx)
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
        bitwise = _grid_streamed_vs_resident(torch, ctx, handles)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    g = N_MAIN // PH_OOC
    tiles = R * C
    # a K step is R*C tensor-core launches of (ph/R x ph) @ (ph x n/C); with C > 1 the chi
    # build and every solve step run stream_gemm's skinny route per panel tile
    want = {name: 0 for name in counts} | {
        "edge_projection": T_GRID_OOC * g * tiles, "cad_scores": (T_GRID_OOC - 1) * g * tiles,
        "stream_gemm": T_GRID_OOC * (CHAIN_GEMMS * g * g + g + REFINE_STEPS * g) * tiles,
        "stream_gemm_tc": T_GRID_OOC * CHAIN_GEMMS * g * g * tiles}
    if counts != want:
        fail(f"grid out-of-core launch counts {counts} != {want}")
    r = res.transitions[0]
    s, s5 = r.scores.cpu().numpy(), np.asarray(s5_t0)
    if s.shape != (N_MAIN,) or not np.isfinite(s).all():
        fail(f"grid out-of-core: scores not finite of shape ({N_MAIN},)")
    scale = float(np.abs(s5).max())
    err = float(np.abs(s - s5).max())
    if err > 1e-3 * scale:
        fail(f"grid out-of-core: max |diff| to phase 5's transition 0 {err:.3e} > 1e-3 x max "
             f"score {scale:.3e}")
    ids, ids5 = r.top_idx.tolist(), np.argsort(-s5, kind="stable")[:TOP_K].tolist()
    if ids != ids5 and _ranking_flips(ids, ids5, s5, 1e-3 * scale):
        fail(f"grid out-of-core: top-{TOP_K} ids {ids} differ from phase 5's {ids5} beyond ties "
             f"within 1e-3 of the largest score")
    split = {"run_wall_s": wall,
             **{f"phase_{p}_s": met.get(f"phase.{p}.seconds", 0.0)
                for p in ("chain", "ingest", "solve", "score")},
             "d2h_and_sync_wait_s": met.get("oochain.d2h_seconds", 0.0),
             "store_write_s": met.get("oochain.store_write_seconds", 0.0),
             "pinned_staging_copy_s": met.get("pipeline.pin_copy_seconds", 0.0),
             "producer_fetch_s": met.get("pipeline.producer_fetch_seconds", 0.0),
             "consumer_wait_s": met.get("pipeline.consumer_wait_seconds", 0.0)}
    p5 = oocore["split"]
    log(f"[grid oocore] 2x2 (one card, 4 tiles) n={N_MAIN} T={T_GRID_OOC} d={cfg.d} q={cfg.q}, "
        f"store grid {STORE_GRID_12}, scratch panels {PH_OOC} rows (host RAM, raw): run wall "
        f"{wall:.3f} s (phase 5, T={T_OOC}: {oocore['wall']:.3f} s); transition 0 "
        f"{res.transition_seconds[0]:.3f} s; launches {counts}; peak device memory {peak:.3f} GB "
        f"(phase 5 {oocore['peak_gb']:.3f} GB); stream.peak_live_bytes "
        f"{st['peak_live_bytes'] / 1e6:.1f} MB (phase 5 "
        f"{oocore['stream']['peak_live_bytes'] / 1e6:.1f} MB; the grid's gathered K-step operands "
        f"count too)")
    log(f"[grid oocore] transition 0: max |diff| to phase 5's {err:.3e} ({err / scale:.3e} of its "
        f"largest score, tol 1e-3); top-{TOP_K} ids "
        f"{'equal' if ids == ids5 else 'equal but for ties'}")
    log(f"[grid oocore] stream bytes: read {st['bytes_read'] / 1e9:.2f} GB, decoded "
        f"{st['bytes_decoded'] / 1e9:.2f} GB, H2D {st['bytes_h2d'] / 1e9:.2f} GB in "
        f"{st['panels']} panels (phase 5, T={T_OOC}: read {oocore['stream']['bytes_read'] / 1e9:.2f}"
        f", H2D {oocore['stream']['bytes_h2d'] / 1e9:.2f} GB in {oocore['stream']['panels']} "
        f"panels)")
    log("[grid oocore] time split (s, host clock): " + ", ".join(
        f"{k[:-2]} {v:.3f} (phase 5 {p5.get(k, float('nan')):.3f})" for k, v in split.items()))
    return {"counts": counts, "wall": wall, "transition_s": res.transition_seconds,
            "peak_gb": peak, "stream": st, "split": split,
            "max_rel_diff_vs_phase5_t0": err / scale, "top_ids_equal": ids == ids5,
            "streamed_vs_resident": bitwise}


def _grid_streamed_vs_resident(torch, ctx, handles) -> dict:
    """(b) On the 2x2 grid of the card: the handles streamed (the resident
    chain, every pass over A streamed) against the same snapshots resident,
    for the degrees, Y and the transition's scores: bitwise, or the gap.
    Gates: degrees 1e-6 and Y 2e-5 of their largest entry (phase 11's tile
    tolerance), scores 1e-3 of the largest."""
    import numpy as np

    from repro_torch.core import CommuteConfig, detect_anomalies, edge_projection
    from repro_torch.core import laplacian as lap

    cfg = CommuteConfig(eps_rp=1e-3, d=6, q=10)
    res_in = [ctx.put_matrix(h.to_numpy()) for h in handles]
    out = {}
    pairs = {"degrees": (lap.degrees(handles[0], ctx=ctx), lap.degrees(res_in[0]), 1e-6),
             "Y": (edge_projection(handles[0], cfg.seed, K_MAIN, ctx=ctx),
                   edge_projection(res_in[0], cfg.seed, K_MAIN), 2e-5)}
    t0 = time.perf_counter()
    streamed = detect_anomalies(*handles, cfg, top_k=TOP_K, ctx=ctx).scores
    t_streamed = time.perf_counter() - t0
    t0 = time.perf_counter()
    resident = detect_anomalies(*res_in, cfg, top_k=TOP_K, ctx=ctx).scores
    t_resident = time.perf_counter() - t0
    pairs["scores"] = (streamed, resident, 1e-3)
    del res_in
    for name, (a, b, tol) in pairs.items():
        gap = float((a - b).abs().max())
        scale = float(b.abs().max())
        if not bool(torch.isfinite(a).all()) or gap > tol * scale:
            fail(f"grid streamed vs resident {name}: max |diff| {gap:.3e} > {tol:g} x {scale:.3e}")
        out[name] = {"bitwise": gap == 0.0, "max_abs_diff": gap, "of_largest": gap / scale}
    torch.cuda.empty_cache()
    def said(v: dict) -> str:
        if v["bitwise"]:
            return "bitwise"
        return f"max |diff| {v['max_abs_diff']:.3e} ({v['of_largest']:.2e} of the largest)"

    log("[grid oocore] (b) 2x2 grid, handles streamed against the same snapshots resident: "
        + "; ".join(f"{k} {said(v)}" for k, v in out.items())
        + f"; transition {t_streamed:.3f} s streamed, {t_resident:.3f} s resident")
    out["transition_s"] = {"streamed": t_streamed, "resident": t_resident}
    return out


def _grid_small_card_vs_cpu(torch) -> dict:
    """(c) n=1536 on the card's grids against the CPU's: the bf16 out-of-core
    path on a 2x1 grid (fused_panel_matvec per row tile); the incremental
    chain on a 2x2 grid, resident and out of core, with phase 7's gates; an
    embedding store published from a 2x2 run, queried raw at top-20 against
    a float64 brute force."""
    from dataclasses import replace

    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import CommuteConfig, SequenceDetector, query
    from repro_torch.graphs import climate_snapshot_sequence
    from repro_torch.store import EmbeddingStore, TileStore

    out = {}
    n = 1536
    cfg = CommuteConfig(eps_rp=1e-3, d=6, q=10, oocore=True, tile_codec="bf16",
                        use_gemm_kernel=True)
    store = TileStore.create(None, n=n, grid=STORE_GRID, codec="bf16")
    seq = climate_snapshot_sequence(32, 48, t_steps=T_MAIN, device="cpu")
    snaps = [a for _, a in zip(range(T_GRID_SMALL), seq.snapshots())]
    ids = [store.put_snapshot(f"t{t}", a.numpy()).snap_id for t, a in enumerate(snaps)]
    t0 = time.perf_counter()
    runs = {}
    for dev in ("cuda", "cpu"):
        kernels.reset_launch_counts()
        runs[dev] = SequenceDetector(cfg, top_k=TOP_K, ctx=_ctx(torch, dev, 2, 1)).run(
            store.snapshot(i) for i in ids)
        if dev == "cuda":
            counts = kernels.launch_counts()
    # scratch grid 8 at n=1536: 192-row panels, 96-row tiles; one fused launch per row tile
    g = n // 192
    if counts["fused_panel_matvec"] != T_GRID_SMALL * REFINE_STEPS * g * 2:
        fail(f"bf16 out-of-core 2x1 grid: fused_panel_matvec launched "
             f"{counts['fused_panel_matvec']} times, want {T_GRID_SMALL * REFINE_STEPS * g * 2}")
    out["bf16 oocore 2x1"] = {"counts": counts, "rel": check_card_vs_cpu(
        "out-of-core bf16 n=1536 2x1 grid", runs["cuda"], runs["cpu"])}
    log(f"[grid oocore] (c) bf16 out-of-core n={n} T={T_GRID_SMALL} on a 2x1 grid, card and CPU "
        f"in {time.perf_counter() - t0:.1f} s: launches {counts}")

    inc_cfg = CommuteConfig(eps_rp=1e-3, d=6, q=10, incremental_chain=True, delta_rank=4,
                            delta_budget=0.1)
    quiet = [a.cpu() for a in _drifting_gmm(n, T_GRID_INC, "cpu").snapshots()]
    want_d = [(1, 0, 0)] + [(0, 1, 0)] * (T_GRID_INC - 1)
    for storage in ("resident", "out-of-core"):
        t0 = time.perf_counter()
        oo = storage == "out-of-core"
        icfg = replace(inc_cfg, oocore=oo, use_gemm_kernel=oo)
        runs, full = {}, {}
        for dev in ("cuda", "cpu"):
            if oo:
                st = TileStore.create(None, n=n, grid=STORE_GRID, codec="raw")
                src = [st.put_snapshot(f"t{t:03d}", a.numpy()) for t, a in enumerate(quiet)]
            else:
                src = [a.to(dev) for a in quiet]
            ctx = _ctx(torch, dev)
            runs[dev] = SequenceDetector(icfg, top_k=TOP_K, ctx=ctx).run(src)
            if dev == "cuda":
                full = SequenceDetector(replace(icfg, incremental_chain=False), top_k=TOP_K,
                                        ctx=ctx).run(src)
                one = SequenceDetector(icfg, top_k=TOP_K, device="cuda").run(src)
        tag = f"incremental n={n} {storage} 2x2 grid"
        dec = {dev: _inc_decisions(r) for dev, r in runs.items()}
        if dec["cuda"] != dec["cpu"] or dec["cuda"] != want_d:
            fail(f"{tag}: (rebuilds, delta updates, fallbacks) per push card {dec['cuda']}, CPU "
                 f"{dec['cpu']}, want {want_d}")
        # The delta run against the full rebuild on the card: INC_ERR_LIMIT of V_G E|z|^2.
        # Its top-20 overlap with the rebuild is the delta algorithm's at this size, the
        # same on one device (quiet transitions rank near-ties: ROADMAP Queue 3), so
        # INC_OVERLAP_MIN holds the grid's delta run against the one-device delta run.
        errs, overlaps, vs_full, one_vs_full = [], [], [], []
        for ri, rf, r1 in zip(runs["cuda"].transitions, full.transitions, one.transitions):
            si, sf = ri.scores.cpu().numpy(), rf.scores.cpu().numpy()
            errs.append(float(np.abs(si - sf).max()))
            ids, ids_f, ids_1 = (set(r.top_idx.tolist()) for r in (ri, rf, r1))
            overlaps.append(len(ids & ids_1))
            vs_full.append(len(ids & ids_f))
            one_vs_full.append(len(ids_1 & ids_f))
        from repro_torch.core import commute_time_embedding

        emb = commute_time_embedding(quiet[0].cuda(), replace(inc_cfg, incremental_chain=False),
                                     device="cuda")
        z0 = emb.z.double()
        scale = float(emb.vol) * float((z0 * z0).sum(1).mean())
        errs = [e / scale for e in errs]
        if max(errs) > INC_ERR_LIMIT or min(overlaps) < INC_OVERLAP_MIN:
            fail(f"{tag}: against the full rebuild max error {errs} of V_G E|z|^2 (limit "
                 f"{INC_ERR_LIMIT:g}); top-{TOP_K} overlap with the one-device delta run "
                 f"{overlaps} (min {INC_OVERLAP_MIN})")
        rel = check_card_vs_cpu(tag, runs["cuda"], runs["cpu"], rtol=INC_CARD_CPU_RTOL, ties=True)
        out[tag] = {"decisions": dec["cuda"], "err_vs_full_of_scale": errs,
                    "overlap_vs_one_device_delta": overlaps, "overlap_vs_full": vs_full,
                    "one_device_overlap_vs_full": one_vs_full, "card_vs_cpu_rel": rel}
        log(f"[grid oocore] (c) {tag} T={T_GRID_INC} ({time.perf_counter() - t0:.1f} s): decisions "
            f"{dec['cuda']} on card and CPU; against the full "
            f"rebuild {', '.join(f'{e:.3e}' for e in errs)} of V_G E|z|^2 (limit "
            f"{INC_ERR_LIMIT:g}); top-{TOP_K} overlap with the one-device delta run {overlaps} "
            f"(min {INC_OVERLAP_MIN}), with the full rebuild {vs_full} (one device "
            f"{one_vs_full}); card against CPU {', '.join(f'{e:.3e}' for e in rel)} of the "
            f"largest score (limit {INC_CARD_CPU_RTOL:g})")

    pub_cfg = CommuteConfig(eps_rp=1e-3, d=6, q=10)
    k = pub_cfg.k_rp(n)
    es = EmbeddingStore.create(None, n=n, k=k, seed=pub_cfg.seed)
    SequenceDetector(pub_cfg, top_k=TOP_K, ctx=_ctx(torch, "cuda"), emb_store=es).run(
        [a.cuda() for a in snaps])
    if es.embedding_ids != [f"t{t:04d}" for t in range(T_GRID_SMALL)]:
        fail(f"2x2 grid publish: artifacts {es.embedding_ids}")
    h = es.latest()
    res = query.top_anomalies_from_store(es, TOP_K, device="cuda")
    z = h.to_numpy().astype(np.float64)
    brute = h.vol * ((z - z.mean(0)) ** 2).sum(1)
    order = np.argsort(-brute, kind="stable")[:TOP_K]
    if res.idx.tolist() != order.tolist():
        fail(f"2x2 grid publish: raw top-{TOP_K} query ids {res.idx.tolist()} != brute force "
             f"{order.tolist()}")
    verr = float(np.abs(res.val - brute[order]).max() / np.abs(brute[order]).max())
    if verr > 1e-4:
        fail(f"2x2 grid publish: query values off the brute force by {verr:.3e} of the largest")
    out["publish 2x2"] = {"ids": es.embedding_ids, "query_ids_equal_bruteforce": True,
                          "max_rel_value_err": verr}
    log(f"[grid oocore] (c) embedding store published from a 2x2 grid at n={n}: "
        f"{es.embedding_ids}; raw top-{TOP_K} query ids equal to the float64 brute force, values "
        f"within {verr:.2e} of the largest")
    return out


def _grid_cli() -> dict:
    """(d) caddelag-run-torch --device cpu --data 2 --model 2 with each of
    --store, --oocore-chain, --incremental-chain and --emb-store: the
    sequence-wide top-k equal to the 1x1 run's."""
    import contextlib
    import io
    import shutil
    import tempfile

    from repro_torch.launch import caddelag_run

    out = {}
    tmp = Path(tempfile.mkdtemp(prefix="smoke_grid_cli_", dir=ROOT / "build"))
    try:
        for flag in (["--store", "S"], ["--oocore-chain"],
                     ["--incremental-chain", "--drift-nodes", "3"], ["--emb-store", "E"]):
            tops = []
            for grid in ("1", "2"):
                args = [str(tmp / f"{f}{grid}") if f in ("S", "E") else f for f in flag]
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    caddelag_run.main(["--device", "cpu", "--n", "64", "--t-steps", "3", "--d",
                                       "3", "--q", "4", "--data", grid, "--model", grid, *args])
                tops.append([ln for ln in buf.getvalue().splitlines()
                             if "sequence-wide top-" in ln][0].split(":", 1)[1].strip())
            if tops[0] != tops[1]:
                fail(f"caddelag-run-torch {flag[0]} --data 2 --model 2: top-k {tops[1]} != the "
                     f"1x1 run's {tops[0]}")
            out[flag[0]] = tops[1]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[grid oocore] (d) caddelag-run-torch --device cpu --data 2 --model 2 with "
        f"{', '.join(out)}: sequence-wide top-k equal to the 1x1 run's")
    return out


def phase_grid_oocore(torch, rows: list, oocore: dict, s5_t0) -> dict:
    """Phase 12: the out-of-core, store-streamed and incremental paths on a
    2x2 grid of the one card (a 2x1 grid for the fused solve)."""
    t_phase = time.perf_counter()
    out, parts = {}, {}
    for key, fn in (("h2d", lambda: _grid_h2d(torch)),
                    ("kernel tiles", lambda: _grid_oocore_tiles(torch, rows)),
                    ("main_path", lambda: _grid_oocore(torch, oocore, s5_t0)),
                    ("n=1536", lambda: _grid_small_card_vs_cpu(torch)),
                    ("cli", _grid_cli)):
        t0 = time.perf_counter()
        out[key] = fn()
        parts[key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["counts"] = out["main_path"]["counts"]
    out["seconds"] = time.perf_counter() - t_phase
    out["part_seconds"] = parts
    log(f"[grid oocore] phase 12 in {out['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
        + f"); main-path launches {out['counts']}")
    return out


# ---------------------------------------------------------------------------
# phase 17: the LM substrate on a 2x2 grid of the card
# ---------------------------------------------------------------------------

LMGRID_SERVE = "qwen2-1.5b"  # phase 9's attention model, its requests and weights (seed 0)
LMGRID_TRAIN = "granite-3-2b"  # phase 15's model
LMGRID_TRAIN_BATCH, LMGRID_TRAIN_SEQ, LMGRID_TRAIN_STEPS = 8, 512, 2
LMGRID_PEAK_GB = 76.0
LMGRID_CHECK_DEPTH = 2  # layers of the fp32 grid-against-1x1 checks
# fp32 on the card, the grid step against the 1x1 step: the loss and grad
# norm within 1e-5 relative, tests/test_sharding.py::test_loss_invariant_to_mesh's
LMGRID_RTOL = 1e-5
LMGRID_BUDGET_S = 90.0  # the phase's aim (printed; not a gate)


def _moved(torch, before: dict, path: str) -> dict:
    from repro_torch.core.collectives import lm_moves

    after = lm_moves()[path]
    return {k: after[k] - before[path][k] for k in after}


def _fmt_moved(m: dict, per: float = 1.0) -> str:
    kinds = ("gather", "reduce", "reduce_scatter", "permute")
    return ", ".join(f"{k} {m[f'{k}_bytes'] / per / 1e6:.3f} MB ({m[f'{k}s'] / per:g})"
                     for k in kinds if m[f"{k}s"])


def _lmgrid_serve(torch, grid, serve: dict) -> dict:
    """qwen2-1.5b at full width and depth on the 2x2 grid with phase 9's
    requests and weights: exact launches (four tiles, once per attention
    block in prefill, none in decode), time to first token, decode ms a step,
    peak memory, moved bytes of the prefill and of one decode step, and the
    bf16 greedy tokens equal to phase 9's, and one more decode step's device
    split (torch.profiler); then fp32 at depth 2, the grid
    against 1x1 on the card: tokens equal, prefill logits within 1e-3 of the
    largest (phase 13's gate)."""
    import gc

    import numpy as np

    from repro_torch import configs, kernels
    from repro_torch.core.collectives import lm_moves
    from repro_torch.models import common as cm
    from repro_torch.models import lm
    from repro_torch.serving import ServeConfig, ServeEngine

    cfg = configs.get_config(LMGRID_SERVE)
    spec = lm.build_spec(cfg)
    s_max = SERVE_PROMPT + SERVE_NEW
    t0 = time.perf_counter()
    params = lm.init_params(spec, seed=0, device="cuda")
    eng = ServeEngine(spec, params, s_max=s_max, batch=SERVE_BATCH, device="cuda", grid=grid,
                      cfg=ServeConfig(max_new_tokens=SERVE_NEW))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    run = cm.GridRun(eng.rules)
    with torch.inference_mode():  # warm-up: a short prefill and one decode step
        lg, cache = lm.prefill(spec, eng.params, run.place(
            torch.from_numpy(prompts[:, :64]).long().cuda(), ("batch", "seq")), s_max,
            rules=eng.rules)
        lm.decode_step(spec, eng.params, run.place(eng._whole(lg).argmax(-1), ("batch",)),
                       cache, rules=eng.rules)
        del lg, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    m0 = lm_moves()
    toks = eng.generate(prompts)
    counts = kernels.launch_counts()
    moved = _moved(torch, m0, "lm.serve")
    peak = torch.cuda.max_memory_allocated() / 1e9
    st = eng.stats
    want = {name: 0 for name in counts} | {"flash_attention": 4 * cfg.n_layers,
                                           "flash_attention_wgmma": 4 * cfg.n_layers}
    if counts != want:
        fail(f"lmgrid serve {LMGRID_SERVE}: launch counts {counts} != {want}")
    if toks.shape != (SERVE_BATCH, SERVE_NEW) or toks.min() < 0 or toks.max() >= cfg.vocab:
        fail(f"lmgrid serve: tokens of shape {toks.shape} in [{toks.min()}, {toks.max()}]")
    ref = np.asarray(serve[LMGRID_SERVE]["tokens"])
    equal = int((toks == ref).sum())
    first_diff = next((j for j in range(SERVE_NEW) if not np.array_equal(toks[:, j], ref[:, j])),
                      None)
    with torch.inference_mode():
        tiles = run.place(torch.from_numpy(prompts).long().cuda(), ("batch", "seq"))
        m0 = lm_moves()
        logits, cache = lm.prefill(spec, eng.params, tiles, s_max, rules=eng.rules)
        pre_moved = _moved(torch, m0, "lm.serve")
        tok = eng._whole(logits).float().argmax(-1)
        m0 = lm_moves()
        lg, cache = lm.decode_step(spec, eng.params, run.place(tok, ("batch",)), cache,
                                   rules=eng.rules)
        dec_moved = _moved(torch, m0, "lm.serve")
        if not bool(torch.isfinite(eng._whole(lg)[:, :cfg.vocab].float()).all()):
            fail("lmgrid serve: decode logits not finite")
        step_tok = run.place(eng._whole(lg).float().argmax(-1), ("batch",))
        sp_dec = device_split(torch, lambda: lm.decode_step(spec, eng.params, step_tok, cache,
                                                            rules=eng.rules))
    del logits, cache, lg, tiles, step_tok
    anchors = {
        "prefill": meta_anchor(f"[lmgrid] serve {LMGRID_SERVE} prefill", pre_moved, spec,
                               "prefill", SERVE_BATCH, SERVE_PROMPT, grid, eng.rules, "lm.serve",
                               s_max=s_max),
        "decode": meta_anchor(f"[lmgrid] serve {LMGRID_SERVE} decode step", dec_moved, spec,
                              "decode", SERVE_BATCH, s_max, grid, eng.rules, "lm.serve",
                              pos=SERVE_PROMPT)}
    step_ms = st.decode_s / st.decode_steps * 1e3
    one = serve[LMGRID_SERVE]
    log(f"[lmgrid] serve {LMGRID_SERVE} ({cfg.n_layers} layers, bf16 compute) on a 2x2 grid of "
        f"the card (init {init_s:.1f} s): batch {SERVE_BATCH} x prompt {SERVE_PROMPT}, "
        f"{SERVE_NEW} greedy tokens: time to first token {st.ttft_s * 1e3:.1f} ms (1x1, phase 9: "
        f"{one['ttft_ms']:.1f}); decode {step_ms:.2f} ms/step (1x1: "
        f"{one['decode_ms_per_step']:.2f}); peak {peak:.2f} GB (1x1: {one['peak_gb']:.2f}); "
        f"flash_attention {counts['flash_attention']} launches (4 tiles x {cfg.n_layers} blocks, "
        f"all wgmma); tokens equal to phase 9's {equal} of {toks.size}"
        + (f" (first differing step {first_diff})" if first_diff is not None else ""))
    log(f"[lmgrid] serve moved between grid positions: prefill {_fmt_moved(pre_moved)}; one "
        f"decode step {_fmt_moved(dec_moved)}; the whole generate {_fmt_moved(moved)}")
    log(f"[lmgrid] serve {LMGRID_SERVE} one decode step on the 2x2 grid under torch.profiler: "
        f"{fmt_split(sp_dec)}")
    out = {"counts": counts, "init_s": init_s, "ttft_ms": st.ttft_s * 1e3,
           "decode_ms_per_step": step_ms, "peak_gb": peak, "tokens_equal_1x1": equal,
           "tokens": toks.size, "first_differing_step": first_diff,
           "moved_prefill": pre_moved, "moved_decode_step": dec_moved, "moved_generate": moved,
           "meta_anchors": anchors,
           "decode_device_split": sp_dec}
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # fp32 at depth 2: the grid against 1x1 on the card
    spec2 = lm.build_spec(cfg.replace(n_layers=LMGRID_CHECK_DEPTH, compute_dtype="float32"))
    params = lm.init_params(spec2, seed=0, device="cuda")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 100)).astype(np.int32)
    res = {}
    for name, g in (("1x1", None), ("2x2", grid)):
        eng = ServeEngine(spec2, params, s_max=108, cfg=ServeConfig(max_new_tokens=8),
                          device="cuda", grid=g)
        toks = eng.generate(prompts)
        tokens = torch.from_numpy(prompts).long().cuda()
        with torch.inference_mode():
            if g is None:
                lg, _ = lm.prefill(spec2, eng.params, tokens, 108)
            else:
                lg, _ = lm.prefill(spec2, eng.params, cm.GridRun(eng.rules).place(
                    tokens, ("batch", "seq")), 108, rules=eng.rules)
                lg = eng._whole(lg)
        res[name] = (toks, lg[:, :cfg.vocab].float().cpu())
        del eng
    if not np.array_equal(res["1x1"][0], res["2x2"][0]):
        fail(f"lmgrid serve depth {LMGRID_CHECK_DEPTH} fp32: greedy tokens differ between the "
             f"2x2 grid and 1x1: {res['2x2'][0].tolist()} vs {res['1x1'][0].tolist()}")
    err, scale = check_close("lmgrid serve fp32 prefill logits", res["2x2"][1], res["1x1"][1],
                             1e-3)
    log(f"[lmgrid] serve {LMGRID_SERVE} depth {LMGRID_CHECK_DEPTH}, fp32, batch 2 x prompt 100, 8 "
        f"new tokens: greedy tokens equal on the 2x2 grid and 1x1; prefill logits max |diff| "
        f"{err:.3e} (tol 1e-3 x max|logit| {scale:.3e})")
    out["fp32_check"] = {"tokens_equal": True, "logits_err": err, "max_logit": scale}
    del params, res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _lmgrid_train(torch, grid) -> dict:
    """granite-3-2b at full width on the 2x2 grid (AdamW, bf16 compute,
    remat) through ``train_loop(grid=)``: loss, grad norm, ms a step, peak
    memory (<= LMGRID_PEAK_GB), moved bytes a step, exact launches (four
    tiles, twice a layer a step under remat); each tile's parameter and
    optimizer bytes against the dry run's ``argument_bytes`` on a 2x2 grid;
    one more step's device split (torch.profiler)."""
    import gc

    from repro_torch import configs, kernels
    from repro_torch.core.collectives import lm_moves
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import as_grid
    from repro_torch.data import DataConfig
    from repro_torch.data.pipeline import global_batch_for
    from repro_torch.launch.train import train_loop
    from repro_torch.models import common as cm
    from repro_torch.models import lm
    from repro_torch.training import OptConfig, make_train_step
    from repro_torch.training import train_step as ts
    from repro_torch.tree import tree_leaves

    cfg = configs.get_config(LMGRID_TRAIN)  # all 40 layers: the peak stays under LMGRID_PEAK_GB
    spec = lm.build_spec(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    m0 = lm_moves()
    hist: list = []
    params, opt, losses = train_loop(cfg, steps=LMGRID_TRAIN_STEPS, batch=LMGRID_TRAIN_BATCH,
                                     seq=LMGRID_TRAIN_SEQ, device="cuda", grid=grid,
                                     history=hist, log_every=100)
    counts = kernels.launch_counts()
    moved = _moved(torch, m0, "lm.train")
    anchor = meta_anchor(f"[lmgrid] train {cfg.name}", moved, spec, "train",
                         LMGRID_TRAIN_BATCH, LMGRID_TRAIN_SEQ, grid, None, "lm.train",
                         steps=LMGRID_TRAIN_STEPS, opt_name=cfg.optimizer)
    peak = torch.cuda.max_memory_allocated() / 1e9
    calls = 4 * 2 * cfg.n_layers * LMGRID_TRAIN_STEPS
    want = {name: 0 for name in counts} | {"flash_attention": calls,
                                           "flash_attention_wgmma": calls}
    if counts != want:
        fail(f"lmgrid train {LMGRID_TRAIN}: launch counts {counts} != {want}")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist):
        fail(f"lmgrid train: non-finite loss or grad norm {hist}")
    if peak > LMGRID_PEAK_GB:
        fail(f"lmgrid train: peak {peak:.2f} GB > {LMGRID_PEAK_GB} GB at {cfg.n_layers} layers")
    # each tile's state against the dry run's per-tile bytes on the same 2x2 grid
    g = as_grid(grid)
    cell = dryrun.argument_bytes(spec, configs.SHAPES_BY_NAME["train_4k"], g,
                                 dict(cm.DEFAULT_RULES), cfg.optimizer)
    pb = [sum(x.numel() * x.element_size() for x in tree_leaves(p)) for p in params]
    ob = [sum(x.numel() * x.element_size() for x in tree_leaves(o)) for o in opt]
    if set(pb) != {cell["param_bytes_per_tile"]} or set(ob) != {cell["opt_state_bytes_per_tile"]}:
        fail(f"lmgrid train: per-tile bytes {pb} / {ob} != the dry run's "
             f"{cell['param_bytes_per_tile']} / {cell['opt_state_bytes_per_tile']}")
    ms = hist[-1]["seconds"] * 1e3
    tokens = LMGRID_TRAIN_BATCH * LMGRID_TRAIN_SEQ
    log(f"[lmgrid] train {LMGRID_TRAIN} at full width, {cfg.n_layers} layers, on a 2x2 grid of "
        f"the card (AdamW, bf16 compute, remat; batch {LMGRID_TRAIN_BATCH} x {LMGRID_TRAIN_SEQ}): "
        + "; ".join(f"step {i} loss {h['loss']:.4f} grad norm {h['grad_norm']:.4f} "
                    f"{h['seconds'] * 1e3:.1f} ms" for i, h in enumerate(hist))
        + f"; {tokens / ms * 1e3:.0f} tokens/s after the first; peak {peak:.2f} GB; "
        f"flash_attention {counts['flash_attention']} launches (4 tiles x 2 x {cfg.n_layers} x "
        f"{LMGRID_TRAIN_STEPS}); moved a step: {_fmt_moved(moved, LMGRID_TRAIN_STEPS)}")
    log(f"[lmgrid] train per-tile state: parameters {pb[0]} B, AdamW {ob[0]} B on each of the "
        f"4 tiles, equal to the dry run's argument_bytes for the cell on a 2x2 grid")
    # one more step, on the trained state, under torch.profiler
    gg = cm.device_grid(grid)
    step = make_train_step(spec, OptConfig(name=cfg.optimizer, lr=1e-3, warmup_steps=5,
                                           total_steps=LMGRID_TRAIN_STEPS + 1),
                           device=gg.home, grid=gg)
    b = global_batch_for(DataConfig(vocab=cfg.vocab, seq_len=LMGRID_TRAIN_SEQ,
                                    global_batch=LMGRID_TRAIN_BATCH, seed=0),
                         LMGRID_TRAIN_STEPS, gg,
                         cm.logical_to_spec(("batch", "seq"), ts.train_rules(spec, gg)))
    sp = device_split(torch, lambda: step(params, opt, b))
    log(f"[lmgrid] train {LMGRID_TRAIN} one more step on the 2x2 grid under torch.profiler: "
        f"{fmt_split(sp)}")
    out = {"counts": counts, "depth": cfg.n_layers, "history": hist, "peak_gb": peak,
           "ms_per_step": ms, "moved": moved, "meta_anchor": anchor,
           "param_bytes_per_tile": pb[0],
           "opt_bytes_per_tile": ob[0], "device_split": sp}
    del params, opt, step, b
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _lmgrid_fp32_presets(torch, grid) -> dict:
    """granite-3-2b at full width, depth 2, fp32, batch 4 x 256: one train
    step on the 2x2 grid under the baseline, fsdp and seqshard rules against
    the 1x1 step on the card (loss and grad norm within LMGRID_RTOL); the
    seqshard step launches flash_attention with q_offset > 0."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, host_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import as_grid
    from repro_torch.models import lm
    from repro_torch.training import OptConfig, init_state, make_train_step

    cfg = configs.get_config(LMGRID_TRAIN).replace(n_layers=LMGRID_CHECK_DEPTH,
                                                    compute_dtype="float32")
    spec = lm.build_spec(cfg)
    ocfg = OptConfig(lr=1e-3, warmup_steps=5, total_steps=10)
    batch = host_batch(DataConfig(vocab=cfg.vocab, seq_len=256, global_batch=4, seed=0), 0)
    p1, o1 = init_state(spec, ocfg, seed=0, device="cuda")
    _, _, m1 = make_train_step(spec, ocfg, device="cuda")(p1, o1, batch)
    ref = {k: float(m1[k]) for k in ("loss", "grad_norm")}
    del p1, o1
    out = {"1x1": ref}
    for preset in ("baseline", "fsdp", "seqshard"):
        rules = None if preset == "baseline" else dryrun.RULE_PRESETS[preset](as_grid(grid))
        pg, og = init_state(spec, ocfg, seed=0, grid=grid, rules=rules)
        fa.offset_launches = 0
        _, _, mg = make_train_step(spec, ocfg, grid=grid, rules=rules)(pg, og, batch)
        got = {k: float(mg[k]) for k in ("loss", "grad_norm")}
        rel = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in got}
        out[preset] = {**got, **{f"{k}_rel": v for k, v in rel.items()},
                       "offset_launches": fa.offset_launches}
        if not all(v <= LMGRID_RTOL for v in rel.values()):
            fail(f"lmgrid train {preset} fp32: {got} against 1x1 {ref}: relative {rel} > "
                 f"{LMGRID_RTOL:g}")
        if preset == "seqshard" and not fa.offset_launches:
            fail("lmgrid train seqshard: no flash_attention launch with q_offset > 0")
        del pg, og
    log(f"[lmgrid] train {LMGRID_TRAIN} depth {LMGRID_CHECK_DEPTH}, fp32, batch 4 x 256, one step "
        f"on the card: 1x1 loss {ref['loss']:.6f} grad norm {ref['grad_norm']:.6f}; 2x2 "
        + "; ".join(f"{p} loss rel {out[p]['loss_rel']:.2e}, grad norm rel "
                    f"{out[p]['grad_norm_rel']:.2e}" for p in ("baseline", "fsdp", "seqshard"))
        + f" (tol {LMGRID_RTOL:g}); seqshard launched flash_attention with q_offset > 0 "
        f"{out['seqshard']['offset_launches']} times")
    return out


def _lmgrid_pod(torch) -> dict:
    """One compressed step on a 2x2x2 grid of the card (granite-3-2b, full
    width, depth 2, fp32): the loss finite, the synced gradient within int8
    error of the pods' uncompressed mean (each pod's dequantized tile within
    half its step, scale = the leaf's amax over the pod / 127, plus 1e-4 of
    it: the codec's edge, one ulp of a value up to 127 steps, is 3.0e-5 of
    half a step)."""
    from repro_torch import configs
    from repro_torch.core.collectives import lm_moves
    from repro_torch.data import DataConfig, host_batch
    from repro_torch.launch.mesh import make_cpu_mesh
    from repro_torch.models import lm
    from repro_torch.training import OptConfig
    from repro_torch.training import train_step as ts
    from repro_torch.tree import tree_leaves

    cfg = configs.get_config(LMGRID_TRAIN).replace(n_layers=LMGRID_CHECK_DEPTH,
                                                    compute_dtype="float32")
    spec = lm.build_spec(cfg)
    ocfg = OptConfig(lr=1e-3, warmup_steps=5, total_steps=10)
    grid = make_cpu_mesh(2, 2, pod=2, device="cuda")
    step, ef_init, _ = ts.make_compressed_train_step(spec, grid, ocfg)
    params, opt = ts.init_pod_state(spec, ocfg, grid, seed=0)
    batch = host_batch(DataConfig(vocab=cfg.vocab, seq_len=256, global_batch=8, seed=0), 0)
    _, _, raw = step.pod_grads(params, batch)
    synced, _ = ts.compressed_pod_allreduce(raw, ef_init(params), grid)
    worst = 0.0  # the largest error as a share of its int8 bound
    per = grid.n_tiles // 2
    n_leaves = len(tree_leaves(raw[0]))
    for i in range(n_leaves):
        scales = [max(float(tree_leaves(raw[t])[i].abs().max()) for t in range(p * per,
                                                                                (p + 1) * per))
                  / 127.0 for p in range(2)]
        bound = (scales[0] + scales[1]) / 4 * (1 + 1e-4) + 1e-30
        for t in range(per):
            a, b, c = (tree_leaves(x)[i] for x in (synced[t], raw[t], raw[t + per]))
            worst = max(worst, float((a - (b + c) / 2).abs().max()) / bound)
    if not worst <= 1.0:
        fail(f"lmgrid pod: a synced gradient is {worst:.3f} x its int8 bound from the mean")
    m0 = lm_moves()
    _, _, m, ef = step(params, opt, batch, ef_init(params))
    moved = _moved(torch, m0, "lm.pod")
    loss, gn = float(m["loss"]), float(m["grad_norm"])
    if not (math.isfinite(loss) and math.isfinite(gn)):
        fail(f"lmgrid pod: loss {loss}, grad norm {gn}")
    log(f"[lmgrid] pod: {LMGRID_TRAIN} depth {LMGRID_CHECK_DEPTH} fp32 on a 2x2x2 grid of the "
        f"card, one compressed step: loss {loss:.6f}, grad norm {gn:.6f}; synced gradients "
        f"within {worst:.3f} x the int8 bound of the pods' uncompressed mean; the pod sync "
        f"moved {_fmt_moved(moved)}")
    return {"loss": loss, "grad_norm": gn, "worst_share_of_int8_bound": worst, "moved": moved}


def _lmgrid_remesh(torch, grid) -> dict:
    """Under deterministic algorithms: granite-3-2b at full width, depth 2,
    fp32, 4 steps on the 2x2 grid with a checkpoint at step 2 (the step-4 one
    removed); a 1x1 ``train_loop`` restores it and runs steps 2 and 3, whose
    losses must equal the grid run's within LMGRID_RTOL relative."""
    import os
    import shutil

    from repro_torch import configs
    from repro_torch.launch.train import train_loop

    cfg = configs.get_config(LMGRID_TRAIN).replace(n_layers=LMGRID_CHECK_DEPTH,
                                                    compute_dtype="float32")
    root = ROOT / "build" / "lmgrid_remesh"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(batch=4, seq=256, device="cuda", log_every=100)
    prev_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _, _, la = train_loop(cfg, steps=4, ckpt_dir=str(root), ckpt_every=2, grid=grid, **kw)
        shutil.rmtree(root / "step_00000004")
        _, _, lb = train_loop(cfg, steps=4, ckpt_dir=str(root), **kw)
    finally:
        torch.use_deterministic_algorithms(False)
        if prev_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev_env
        shutil.rmtree(root, ignore_errors=True)
    rel = [abs(b - a) / abs(a) for a, b in zip(la[2:], lb)]
    if len(lb) != 2 or not max(rel) <= LMGRID_RTOL:
        fail(f"lmgrid remesh: 1x1 losses {lb} after the 2x2 checkpoint against the grid's "
             f"{la[2:]} (relative {rel} > {LMGRID_RTOL:g})")
    log(f"[lmgrid] remesh: {LMGRID_TRAIN} depth {LMGRID_CHECK_DEPTH} fp32, deterministic "
        f"algorithms: 2x2 grid losses {la}; its step-2 checkpoint resumed on 1x1: {lb} "
        f"(relative {max(rel):.2e}, tol {LMGRID_RTOL:g})")
    return {"grid_losses": la, "resumed_1x1": lb, "max_rel": max(rel)}


def phase_lmgrid(torch, serve: dict) -> dict:
    """Phase 17: the LM substrate on a 2x2 grid of the one card
    (``make_context([cuda:0] * 4, 2)``) -- serving, training, the presets,
    the int8 pod sync on a 2x2x2 grid of the card, and the remesh restore."""
    import gc

    from repro_torch.core.distmatrix import make_context

    t_phase = time.perf_counter()
    grid = make_context([torch.device("cuda", 0)] * 4, 2)
    log(f"[lmgrid] phase 17 starts with {torch.cuda.memory_allocated() / 1e9:.2f} GB in use")
    out = {"serve": _lmgrid_serve(torch, grid, serve)}
    out["train"] = _lmgrid_train(torch, grid)
    gc.collect()
    torch.cuda.empty_cache()
    out["fp32_presets"] = _lmgrid_fp32_presets(torch, grid)
    out["pod"] = _lmgrid_pod(torch)
    gc.collect()
    torch.cuda.empty_cache()
    out["remesh"] = _lmgrid_remesh(torch, grid)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[lmgrid] phase 17 in {out['seconds']:.1f} s (aim: under {LMGRID_BUDGET_S:g} s)")
    return out


# ---------------------------------------------------------------------------
# phase 18: MoE and chameleon on a device grid of the card
# ---------------------------------------------------------------------------

# (arch, depth served at full width (None: the config's own), grid rows x
# cols).  The engine cuts its tiles from the weights drawn on the card, so
# both are held at once before the weights are dropped: llama4's 37.36 GB
# and its 37.49 GB of tiles, 74.85 GB.  Its one MoE layer is 32.2 GB of bf16
# experts: on 2x2 the prefill's branch would gather each tile's 64 experts
# whole over data (16.1 GB a tile), so it is served on 1x4, where data is 1
# and nothing is gathered.  chameleon's serve layout holds its dense weights
# once a data row (2.76 GB a layer on 2x2, 4.29 GB of embedding and head):
# 16 of its 48 layers are 48.5 GB of tiles beside 24.2 GB of weights.
MOEGRID_SERVE = (("granite-moe-3b-a800m", None, (2, 2)),
                 ("llama4-maverick-400b-a17b", 2, (1, 4)),
                 ("chameleon-34b", 16, (2, 2)))
MOEGRID_NEW = 8  # greedy tokens a request on the grid (phase 13 serves 32 on one card)
MOEGRID_TRAIN = "granite-moe-3b-a800m"
MOEGRID_TRAIN_BATCH, MOEGRID_TRAIN_SEQ, MOEGRID_TRAIN_STEPS = 8, 512, 2
MOEGRID_PEAK_GB = 76.0
MOEGRID_CHECK_DEPTH = 2  # granite-moe's card-grid-against-CPU-grid depth at full width
MOEGRID_RTOL = 1e-5  # card grid against CPU grid, fp32: train loss and grad norm, relative
MOEGRID_BUDGET_S = 150.0  # the phase's aim (printed; not a gate)


def _grid_of(torch, rows: int, cols: int, device: str = "cuda"):
    from repro_torch.core.distmatrix import make_context

    return make_context([torch.device(device, 0) if device == "cuda" else torch.device("cpu")]
                        * (rows * cols), rows)


def _dropped(routes: list, grid) -> list:
    """Dropped (token, choice) slots per MoE layer: over the whole batch at
    1x1 (one Routing a layer), over the batch shards on a grid (one Routing
    a tile; the tiles of a shard route alike, so the first model column)."""
    out = []
    for rs in routes:
        if not isinstance(rs, list):
            out.append(int((~rs.keep).sum()))
            continue
        out.append(sum(int((~r.keep).sum()) for t, r in enumerate(rs)
                       if grid.coords(t)["model"] == 0))
    return out


def _moegrid_serve(torch, arch: str, depth, shape: tuple) -> dict:
    """One model at full width on a grid of the card, phase 13's requests
    (MOEGRID_NEW greedy tokens): time to first token, decode ms a step,
    peak memory while the engine is made and while it serves (each <=
    MOEGRID_PEAK_GB), exact flash_attention launches (every tile once a
    block in prefill), moved bytes of a prefill and of one decode step by
    kind, the tiles' bytes against the dry run's decode cell in the dtypes
    the engine stores, the dropped slots of each MoE layer (granite-moe:
    against the same weights on 1x1), and the kernel at each form a
    prefill tile gave it, against its plain version (_flash_form)."""
    import gc

    import numpy as np

    from repro_torch import configs, kernels
    from repro_torch.core.collectives import lm_moves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import as_grid
    from repro_torch.models import common as cm
    from repro_torch.models import lm, moe
    from repro_torch.serving import ServeConfig, ServeEngine
    from repro_torch.tree import tree_leaves

    t_model = time.perf_counter()
    full = configs.get_config(arch)
    cfg = full if depth is None else full.replace(n_layers=depth)
    spec = lm.build_spec(cfg)
    grid = _grid_of(torch, *shape)
    g = as_grid(grid)
    route_name, hd = _flash_route(spec, fa)
    n_attn = _attention_blocks(spec)
    s_max = SERVE_PROMPT + MOEGRID_NEW
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(spec, seed=0, device="cuda")
    eng = ServeEngine(spec, params, s_max=s_max, batch=SERVE_BATCH, device="cuda", grid=grid,
                      cfg=ServeConfig(max_new_tokens=MOEGRID_NEW))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    if init_peak > MOEGRID_PEAK_GB:
        fail(f"moegrid serve {arch}: peak {init_peak:.2f} GB > {MOEGRID_PEAK_GB:g} GB while the "
             f"engine cuts its tiles")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    dropped_1x1 = None
    if arch == MOEGRID_TRAIN:  # granite-moe: the same weights on one device, its routing
        one = ServeEngine(spec, params, s_max=s_max, device="cuda")
        with torch.inference_mode(), moe.record_routing() as r1:
            lm.prefill(spec, one.params, torch.from_numpy(prompts).long().cuda(), s_max)
        dropped_1x1 = _dropped(r1, g)
        del one, r1
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # the engine holds the matrices in the compute dtype (granite-moe's
    # parameters are fp32, its matrices served in bf16): the dry run counts so
    tile_bytes = [sum(x.numel() * x.element_size() for x in tree_leaves(t)) for t in eng.tiles]
    cell = dryrun.argument_bytes(spec, configs.SHAPES_BY_NAME["decode_32k"], g,
                                 dict(cm.DEFAULT_RULES), "adamw",
                                 compute_cast=True)["param_bytes_per_tile"]
    if set(tile_bytes) != {cell}:
        fail(f"moegrid serve {arch}: per-tile parameter bytes {tile_bytes} != the dry run's "
             f"decode_32k argument bytes {cell} ({cfg.compute_dtype} matrices)")
    run = cm.GridRun(eng.rules)
    with torch.inference_mode():  # the one warm-up: a short prefill and one decode step
        lg, cache = lm.prefill(spec, eng.params, run.place(
            torch.from_numpy(prompts[:, :64]).long().cuda(), ("batch", "seq")), s_max,
            rules=eng.prefill_rules)
        lm.decode_step(spec, eng.params, run.place(eng._whole(lg).argmax(-1), ("batch",)),
                       cache, rules=eng.rules)
        del lg, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    m0 = lm_moves()
    toks = eng.generate(prompts)
    counts = kernels.launch_counts()
    moved = _moved(torch, m0, "lm.serve")
    peak = torch.cuda.max_memory_allocated() / 1e9
    st = eng.stats
    want = {name: 0 for name in counts} | {"flash_attention": g.n_tiles * n_attn}
    if route_name == "wgmma":
        want["flash_attention_wgmma"] = g.n_tiles * n_attn
    if counts != want:
        fail(f"moegrid serve {arch}: launch counts {counts} != {want} ({g.n_tiles} tiles x "
             f"{n_attn} attention blocks, the {route_name} route at D={hd})")
    if toks.shape != (SERVE_BATCH, MOEGRID_NEW) or toks.min() < 0 or toks.max() >= cfg.vocab:
        fail(f"moegrid serve {arch}: tokens of shape {toks.shape} in [{toks.min()}, "
             f"{toks.max()}]")
    if peak > MOEGRID_PEAK_GB:
        fail(f"moegrid serve {arch}: peak {peak:.2f} GB > {MOEGRID_PEAK_GB:g} GB")
    with torch.inference_mode(), moe.record_routing() as routes, _FlashShapes(fa) as shapes:
        tiles = run.place(torch.from_numpy(prompts).long().cuda(), ("batch", "seq"))
        m0 = lm_moves()
        logits, cache = lm.prefill(spec, eng.params, tiles, s_max, rules=eng.prefill_rules)
        pre_moved = _moved(torch, m0, "lm.serve")
        n_pre = len(routes)
        tok = run.place(eng._whole(logits).float().argmax(-1), ("batch",))
        m0 = lm_moves()  # the decode step alone: its token's gather home is the engine's
        lg, cache = lm.decode_step(spec, eng.params, tok, cache, rules=eng.rules)
        dec_moved = _moved(torch, m0, "lm.serve")
        if not bool(torch.isfinite(eng._whole(lg)[:, :cfg.vocab].float()).all()):
            fail(f"moegrid serve {arch}: decode logits not finite")
    anchors = {
        "prefill": meta_anchor(f"[moegrid] serve {arch} prefill", pre_moved, spec, "prefill",
                               SERVE_BATCH, SERVE_PROMPT, grid, eng.prefill_rules, "lm.serve",
                               s_max=s_max, store_rules=eng.rules),
        "decode": meta_anchor(f"[moegrid] serve {arch} decode step", dec_moved, spec, "decode",
                              SERVE_BATCH, s_max, grid, eng.rules, "lm.serve", pos=SERVE_PROMPT)}
    n_moe = spec.layers().count("attn_moe")
    if n_pre != n_moe or len(routes) != 2 * n_moe:
        fail(f"moegrid serve {arch}: {n_pre} / {len(routes) - n_pre} MoE calls in a prefill / "
             f"decode step, want {n_moe}")
    t_pf = {r.expert_ids.shape[0] for rs in routes[:n_pre] for r in rs}
    t_dec = {r.expert_ids.shape[0] for rs in routes[n_pre:] for r in rs}
    # decode gathers the tokens where the experts divide their axis (llama4);
    # granite-moe's override falls back to its batch shards, as in the JAX package
    n_batch = g.shape["data"]
    e_ax = eng.rules.get("experts")
    t_dec_want = (SERVE_BATCH if e_ax in g.axis_names and cfg.n_experts % g.shape[e_ax] == 0
                  else SERVE_BATCH // n_batch)
    if n_moe and (t_pf != {SERVE_BATCH * SERVE_PROMPT // n_batch} or t_dec != {t_dec_want}):
        fail(f"moegrid serve {arch}: a prefill tile routed {t_pf} tokens, a decode tile {t_dec} "
             f"(want the batch shard's {SERVE_BATCH * SERVE_PROMPT // n_batch} and "
             f"{t_dec_want})")
    dropped = _dropped(routes[:n_pre], g)
    del logits, cache, lg, tiles, routes, tok
    step_ms = st.decode_s / st.decode_steps * 1e3
    one_card = f"; 1x1 dropped {dropped_1x1}" if dropped_1x1 is not None else ""
    log(f"[moegrid] serve {arch} ({cfg.n_layers} layers"
        + ("" if depth is None else f", reduced from {full.n_layers}")
        + f", bf16) on a {shape[0]}x{shape[1]} grid of the card (init {init_s:.1f} s, peak "
        f"{init_peak:.2f} GB with the weights and the tiles): batch {SERVE_BATCH} x prompt "
        f"{SERVE_PROMPT}, {MOEGRID_NEW} greedy tokens: time to first token "
        f"{st.ttft_s * 1e3:.1f} ms; decode {step_ms:.2f} ms/step; peak {peak:.2f} GB; "
        f"flash_attention {counts['flash_attention']} launches ({g.n_tiles} tiles x {n_attn} "
        f"blocks, {route_name}); tiles {tile_bytes[0]} B each"
        + f" = the dry run's decode_32k argument bytes ({cfg.compute_dtype} matrices)"
        + (f"; prefill dropped slots per MoE layer (batch shards) {dropped}{one_card}"
           if n_moe else ""))
    log(f"[moegrid] serve {arch} moved between grid positions: prefill {_fmt_moved(pre_moved)}; "
        f"one decode step {_fmt_moved(dec_moved)}; the whole generate {_fmt_moved(moved)}")
    out = {"n_layers": cfg.n_layers, "full_n_layers": full.n_layers, "grid": list(shape),
           "counts": counts, "init_s": init_s, "init_peak_gb": init_peak,
           "ttft_ms": st.ttft_s * 1e3,
           "decode_ms_per_step": step_ms, "peak_gb": peak, "tile_param_bytes": tile_bytes[0],
           "dryrun_param_bytes_per_tile": cell,
           "moved_prefill": pre_moved, "moved_decode_step": dec_moved, "moved_generate": moved,
           "meta_anchors": anchors,
           "dropped_grid": dropped, "dropped_1x1": dropped_1x1, "first_tokens": toks[0].tolist()}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # the kernel at each form a prefill tile gave it (random bf16 inputs of
    # those shapes), on the route the launch counts above saw
    gen = torch.Generator(device="cuda").manual_seed(18)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out["kernel_forms"] = {}
    for (qs, ks, grp, causal, dt), n in shapes.forms.items():
        name = (f"{arch} {shape[0]}x{shape[1]} tile q {qs} k/v {ks} "
                f"{str(dt).removeprefix('torch.')} {'causal' if causal else 'non-causal'}, "
                f"groups {grp}")
        q, k, v = (torch.randn(x, generator=gen, device="cuda").to(dt) for x in (qs, ks, ks))
        out["kernel_forms"][name] = _flash_form(
            torch, fa, ref, name, q, k, v, causal, grp,
            2.0**-7 if dt == torch.bfloat16 else 1e-4, sdpa, route=route_name) | {
                "calls_per_prefill": n}
        del q, k, v
    out["seconds"] = time.perf_counter() - t_model
    return out


def _moegrid_train(torch) -> dict:
    """granite-moe at full width and all 32 layers on the 2x2 grid (AdamW,
    bf16 compute, remat) through ``train_loop(grid=)``: loss, grad norm, ms
    a step, peak memory (<= MOEGRID_PEAK_GB), moved bytes a step, exact
    launches (four tiles, twice a layer a step), each tile's state against
    the dry run's train_4k argument bytes."""
    import gc

    from repro_torch import configs, kernels
    from repro_torch.core.collectives import lm_moves
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import as_grid
    from repro_torch.launch.train import train_loop
    from repro_torch.models import common as cm
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    cfg = configs.get_config(MOEGRID_TRAIN)
    spec = lm.build_spec(cfg)
    grid = _grid_of(torch, 2, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    m0 = lm_moves()
    hist: list = []
    params, opt, _ = train_loop(cfg, steps=MOEGRID_TRAIN_STEPS, batch=MOEGRID_TRAIN_BATCH,
                                seq=MOEGRID_TRAIN_SEQ, device="cuda", grid=grid, history=hist,
                                log_every=100)
    counts = kernels.launch_counts()
    moved = _moved(torch, m0, "lm.train")
    anchor = meta_anchor(f"[moegrid] train {cfg.name}", moved, spec, "train",
                         MOEGRID_TRAIN_BATCH, MOEGRID_TRAIN_SEQ, grid, None, "lm.train",
                         steps=MOEGRID_TRAIN_STEPS, opt_name=cfg.optimizer)
    peak = torch.cuda.max_memory_allocated() / 1e9
    calls = 4 * 2 * cfg.n_layers * MOEGRID_TRAIN_STEPS
    want = {name: 0 for name in counts} | {"flash_attention": calls,
                                           "flash_attention_wgmma": calls}
    if counts != want:
        fail(f"moegrid train {MOEGRID_TRAIN}: launch counts {counts} != {want}")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist):
        fail(f"moegrid train: non-finite loss or grad norm {hist}")
    if not all(h["lb_loss"] > 0 for h in hist):
        fail(f"moegrid train: no load-balancing loss {hist}")
    if peak > MOEGRID_PEAK_GB:
        fail(f"moegrid train: peak {peak:.2f} GB > {MOEGRID_PEAK_GB} GB at {cfg.n_layers} layers")
    cell = dryrun.argument_bytes(spec, configs.SHAPES_BY_NAME["train_4k"], as_grid(grid),
                                 dict(cm.DEFAULT_RULES), cfg.optimizer)
    pb = [sum(x.numel() * x.element_size() for x in tree_leaves(p)) for p in params]
    ob = [sum(x.numel() * x.element_size() for x in tree_leaves(o)) for o in opt]
    if set(pb) != {cell["param_bytes_per_tile"]} or set(ob) != {cell["opt_state_bytes_per_tile"]}:
        fail(f"moegrid train: per-tile bytes {pb} / {ob} != the dry run's "
             f"{cell['param_bytes_per_tile']} / {cell['opt_state_bytes_per_tile']}")
    ms = hist[-1]["seconds"] * 1e3
    tokens = MOEGRID_TRAIN_BATCH * MOEGRID_TRAIN_SEQ
    log(f"[moegrid] train {MOEGRID_TRAIN} at full width, {cfg.n_layers} layers, on a 2x2 grid of "
        f"the card (AdamW, bf16 compute, remat; batch {MOEGRID_TRAIN_BATCH} x "
        f"{MOEGRID_TRAIN_SEQ}): "
        + "; ".join(f"step {i} loss {h['loss']:.4f} (lb {h['lb_loss']:.4f}, z {h['z_loss']:.3f})"
                    f" grad norm {h['grad_norm']:.4f} {h['seconds'] * 1e3:.1f} ms"
                    for i, h in enumerate(hist))
        + f"; {tokens / ms * 1e3:.0f} tokens/s after the first; peak {peak:.2f} GB; "
        f"flash_attention {counts['flash_attention']} launches (4 tiles x 2 x {cfg.n_layers} x "
        f"{MOEGRID_TRAIN_STEPS}); moved a step: {_fmt_moved(moved, MOEGRID_TRAIN_STEPS)}; "
        f"per tile {pb[0]} B of parameters and {ob[0]} B of AdamW state = the dry run's")
    out = {"counts": counts, "depth": cfg.n_layers, "history": hist, "peak_gb": peak,
           "ms_per_step": ms, "moved": moved, "meta_anchor": anchor,
           "param_bytes_per_tile": pb[0],
           "opt_bytes_per_tile": ob[0]}
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _moegrid_card_vs_cpu(torch, arch: str) -> dict:
    """The card's 2x2 grid against the CPU's, fp32, the same weights (drawn on
    the card, seed 0) and inputs: granite-moe at full width and depth
    MOEGRID_CHECK_DEPTH, llama4 at its SMOKE config.  Serving batch 2 x a
    ragged prompt of 100, 8 greedy tokens: tokens equal, last-position
    logits within 1e-3 of the largest, each tile's expert ids and kept
    masks (_routing_card_vs_cpu), flash_attention launched once a tile an
    attention block by the card's prefill and never by the CPU's; one
    train step (the config's optimizer) at batch 4 x 64: loss and grad
    norm within MOEGRID_RTOL."""
    import numpy as np

    from repro_torch import configs, kernels
    from repro_torch.data import DataConfig, host_batch
    from repro_torch.models import common as cm
    from repro_torch.models import lm, moe
    from repro_torch.serving import ServeConfig, ServeEngine
    from repro_torch.training import OptConfig, make_train_step
    from repro_torch.training import optim
    from repro_torch.training import train_step as ts
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    if arch == MOEGRID_TRAIN:
        cfg = configs.get_config(arch).replace(n_layers=MOEGRID_CHECK_DEPTH,
                                               compute_dtype="float32")
        setup = f"full width, depth {MOEGRID_CHECK_DEPTH}"
    else:
        cfg, setup = configs.get_smoke(arch), "SMOKE config"
    spec = lm.build_spec(cfg)
    params = lm.init_params(spec, seed=0, device="cuda")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 100)).astype(np.int32)
    ocfg = OptConfig(name=cfg.optimizer, lr=1e-3, warmup_steps=5, total_steps=10)
    batch = host_batch(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4, seed=0), 0)
    whole = lm.params_tree(spec, params)
    res = {}
    for dev in ("cuda", "cpu"):
        grid = _grid_of(torch, 2, 2, dev)
        eng = ServeEngine(spec, params, s_max=108, cfg=ServeConfig(max_new_tokens=8),
                          device=dev, grid=grid)
        kernels.reset_launch_counts()
        toks = eng.generate(prompts)
        launches = kernels.launch_counts()["flash_attention"]
        want = 4 * _attention_blocks(spec) if dev == "cuda" else 0
        if launches != want:
            fail(f"moegrid {arch} on the {dev} grid: {launches} flash_attention launches, "
                 f"want {want}")
        run = cm.GridRun(eng.rules)
        with torch.inference_mode(), moe.record_routing() as routes:
            lg, _ = lm.prefill(spec, eng.params, run.place(torch.from_numpy(prompts).long()
                                                           .to(dev), ("batch", "seq")), 108,
                               rules=eng.prefill_rules)
        lg = eng._whole(lg)[:, :cfg.vocab].float().cpu()
        del eng
        pspecs, _ = ts.grid_specs(spec, ocfg, grid)
        tiles = cm.shard_tree(tree_map(lambda t: t.detach().requires_grad_(True), whole),
                              pspecs, grid)
        opt = [optim.make_optimizer(ocfg)[0](p) for p in tiles]
        _, _, m = make_train_step(spec, ocfg, grid=grid)(tiles, opt, batch)
        res[dev] = (toks, lg, routes, {k: float(m[k]) for k in ("loss", "grad_norm")})
        del tiles, opt
    del params, whole
    card, cpu = res["cuda"], res["cpu"]
    if not np.array_equal(card[0], cpu[0]):
        fail(f"moegrid {arch} card vs CPU grid: greedy tokens differ: {card[0].tolist()} vs "
             f"{cpu[0].tolist()}")
    err, scale = check_close(f"moegrid {arch} card vs CPU grid prefill logits", card[1], cpu[1],
                             1e-3)
    routing = _routing_card_vs_cpu(f"moegrid {arch} card vs CPU grid", card[2], cpu[2])
    rel = {k: abs(card[3][k] - cpu[3][k]) / abs(cpu[3][k]) for k in card[3]}
    if not all(v <= MOEGRID_RTOL for v in rel.values()):
        fail(f"moegrid {arch} card vs CPU grid: train step {card[3]} against {cpu[3]}: relative "
             f"{rel} > {MOEGRID_RTOL:g}")
    log(f"[moegrid] {arch} card 2x2 grid vs CPU 2x2 grid ({setup}, fp32, "
        f"{time.perf_counter() - t0:.1f} s): batch 2 x prompt 100, 8 greedy tokens equal, "
        f"flash_attention launched 4 x {_attention_blocks(spec)} times on the card; "
        f"prefill logits max |diff| {err:.3e} (tol 1e-3 x max|logit| {scale:.3e}); routing of "
        f"{len(routing)} tile-layers, flips {sum(r['flips'] for r in routing)}; one "
        f"{cfg.optimizer} step at batch 4 x 64: loss {card[3]['loss']:.6f} (rel "
        f"{rel['loss']:.2e}), grad norm {card[3]['grad_norm']:.6f} (rel {rel['grad_norm']:.2e}; "
        f"tol {MOEGRID_RTOL:g})")
    return {"setup": setup, "tokens_equal": True, "logits_err": err, "max_logit": scale,
            "routing_flips": sum(r["flips"] for r in routing), "train": card[3],
            "train_cpu": cpu[3], "train_rel": rel, "seconds": time.perf_counter() - t0}


def _moegrid_decode_vs_1x1(torch) -> dict:
    """llama4 SMOKE in fp32 on the card: from one 1x1 prefill's cache, the
    gathered decode step on a 2x2 and a 1x4 grid against the 1x1 decode
    step (one capacity over the batch on both): logits within 1e-3 of the
    largest."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import common as cm
    from repro_torch.models import lm
    from repro_torch.serving.engine import serve_rules

    cfg = configs.get_smoke("llama4-maverick-400b-a17b")
    spec = lm.build_spec(cfg)
    params = lm.init_params(spec, seed=0, device="cuda")
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(4, 24)).astype(np.int64)).cuda()
    nxt = torch.tensor([3, 17, 250, 9], device="cuda")
    out = {}
    with torch.inference_mode():
        _, cache = lm.prefill(spec, params, prompts, 32)
        want, _ = lm.decode_step(spec, params, nxt, cache)
        tree = lm.param_dict(params)
        for shape in ((2, 2), (1, 4)):
            grid = _grid_of(torch, *shape)
            rules = serve_rules(spec, grid)
            specs = cm.sanitize_specs(lm.param_specs(spec, rules), tree, grid)
            view = lm.grid_view(spec, cm.shard_tree(tree, specs, grid), specs, grid,
                                stacked=False)
            got, _ = lm.decode_step(spec, view, cm.GridRun(rules).place(nxt, ("batch",)),
                                    lm.cache_to_grid(spec, cache, rules), rules=rules)
            whole = torch.cat([got[t] for t in range(len(got))
                               if cm.device_grid(grid).coords(t)["model"] == 0])
            err, scale = check_close(f"moegrid llama4 decode {shape[0]}x{shape[1]} vs 1x1",
                                     whole[:, :cfg.vocab], want[:, :cfg.vocab], 1e-3)
            out[f"{shape[0]}x{shape[1]}"] = {"err": err, "max_logit": scale}
    log("[moegrid] llama4 SMOKE fp32 gathered decode step on the card from one 1x1 prefill's "
        "cache: " + "; ".join(f"{k} vs 1x1 logits max |diff| {v['err']:.3e} (tol 1e-3 x "
                              f"{v['max_logit']:.3e})" for k, v in out.items()))
    return out


def phase_moegrid(torch, rows: list) -> dict:
    """Phase 18: the MoE and vlm families on device grids of the one card --
    granite-moe served on 2x2 at full size and trained at full width,
    llama4 served at full width on 1x4, chameleon served at full width on
    2x2, with flash_attention at each of their tile forms; the card's grid
    against the CPU's, and llama4's gathered decode step against 1x1."""
    import gc

    t_phase = time.perf_counter()
    log(f"[moegrid] phase 18 starts with {torch.cuda.memory_allocated() / 1e9:.2f} GB in use")
    out = {"serve": {}}
    for arch, depth, shape in MOEGRID_SERVE:
        out["serve"][arch] = _moegrid_serve(torch, arch, depth, shape)
        gc.collect()
        torch.cuda.empty_cache()
    next(r for r in rows if r["name"] == "flash_attention")["moegrid_forms"] = {
        k: v for a in out["serve"].values() for k, v in a["kernel_forms"].items()}
    out["train"] = _moegrid_train(torch)
    gc.collect()
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = {arch: _moegrid_card_vs_cpu(torch, arch)
                          for arch in (MOEGRID_TRAIN, "llama4-maverick-400b-a17b")}
    out["decode_vs_1x1"] = _moegrid_decode_vs_1x1(torch)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[moegrid] phase 18 in {out['seconds']:.1f} s (aim: under {MOEGRID_BUDGET_S:g} s; "
        + ", ".join(f"{a} serve {v['seconds']:.1f}" for a, v in out["serve"].items()) + ")")
    return out


# ---------------------------------------------------------------------------
# phase 19: RWKV6, zamba2 (Mamba2 + the shared block) and seamless on a grid
# ---------------------------------------------------------------------------

# (arch, the kernel its prefill launches, the phase it is served at 1x1 in)
FAMGRID_SERVE = (("rwkv6-3b", "wkv", 9), ("zamba2-7b", "flash_attention", 13),
                 (SEAMLESS, "flash_attention", 14))
FAMGRID_NEW = 8  # greedy tokens a request on the grid (phases 9, 13 and 14 serve 32 at 1x1)
FAMGRID_TRAIN = "rwkv6-3b"  # phase 15's third model at its depth and batch
FAMGRID_TRAIN_DEPTH, FAMGRID_TRAIN_BATCH, FAMGRID_TRAIN_SEQ, FAMGRID_TRAIN_STEPS = 4, 4, 512, 2
FAMGRID_PEAK_GB = 76.0
# the card's 2x2 grid against the CPU's, fp32, full width at these depths
# (zamba2 7: the shared block runs once; seamless 2 + 2)
FAMGRID_CHECK_DEPTH = {"zamba2-7b": 7, "rwkv6-3b": 2, SEAMLESS: 2}
FAMGRID_CHECK_FRAMES = 64  # seamless's encoder positions in that check
FAMGRID_RTOL = 1e-5  # card grid against CPU grid, fp32: train loss and grad norm, relative
FAMGRID_BUDGET_S = 150.0  # the phase's aim (printed; not a gate)


class _WKVShapes:
    """Records the (B*H, S, D) form of every ``wkv`` call while installed and
    how many calls each took; the wrapper still counts its launches."""

    def __init__(self, wk):
        self.wk, self.forms = wk, {}

    def __enter__(self):
        self.orig = self.wk.wkv

        def spy(r, k, v, lw, u, **kw):
            self.forms[tuple(r.shape)] = self.forms.get(tuple(r.shape), 0) + 1
            return self.orig(r, k, v, lw, u, **kw)

        self.wk.wkv = spy
        return self

    def __exit__(self, *exc):
        self.wk.wkv = self.orig
        return False


def _famgrid_want(spec, kernel: str, n_tiles: int, counts: dict) -> dict:
    """The exact launches of one grid generate: every tile once a recurrent
    or attention call in prefill (seamless: the encoder, each decoder
    block's self- and cross-attention), none in decode; flash_attention on
    the tensor-core route at D=64 (seamless) and D=224 (zamba2)."""
    from repro_torch.kernels import flash_attention as fa

    want = {name: 0 for name in counts}
    if kernel == "wkv":
        want["wkv"] = n_tiles * spec.layers().count("rwkv")
        return want
    n = (_attention_blocks(spec) if not spec.is_encdec
         else len(spec.enc_layers()) + 2 * len(spec.layers()))
    want["flash_attention"] = n_tiles * n
    if spec.is_encdec or _flash_route(spec, fa)[0] == "wgmma":
        want["flash_attention_wgmma"] = n_tiles * n
    return want


def _famgrid_serve(torch, arch: str, kernel: str, one: dict) -> dict:
    """One model at full width and depth on a 2x2 grid of the card, phase 9's
    requests (seamless over frames (4, 1024, 1024), drawn after the prompts
    as the launcher draws them), FAMGRID_NEW greedy tokens: exact launches
    (by (S, T, causal) for seamless), time to first token, decode ms a step,
    peak memory while the engine cuts its tiles and while it serves (<=
    FAMGRID_PEAK_GB), the bytes a prefill and a decode step move by kind,
    each tile's parameter bytes against the dry run's decode_32k cell, and
    the kernel at each tile form a prefill gave it against its plain
    version, twice bitwise, timed beside its bound (and SDPA)."""
    import gc

    import numpy as np

    from repro_torch import configs, kernels
    from repro_torch.core.collectives import lm_moves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv as wk
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import as_grid
    from repro_torch.models import common as cm
    from repro_torch.models import lm
    from repro_torch.serving import ServeConfig, ServeEngine
    from repro_torch.tree import tree_leaves

    t_model = time.perf_counter()
    cfg = configs.get_config(arch)
    spec = lm.build_spec(cfg)
    grid = _grid_of(torch, 2, 2)
    g = as_grid(grid)
    s_max = SERVE_PROMPT + FAMGRID_NEW
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(spec, seed=0, device="cuda")
    n_params = lm.param_count(params)
    eng = ServeEngine(spec, params, s_max=s_max, batch=SERVE_BATCH, device="cuda", grid=grid,
                      cfg=ServeConfig(max_new_tokens=FAMGRID_NEW))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if init_peak > FAMGRID_PEAK_GB:
        fail(f"famgrid serve {arch}: peak {init_peak:.2f} GB > {FAMGRID_PEAK_GB:g} GB while the "
             f"engine cuts its tiles")
    tile_bytes = [sum(x.numel() * x.element_size() for x in tree_leaves(t)) for t in eng.tiles]
    cell = dryrun.argument_bytes(spec, configs.SHAPES_BY_NAME["decode_32k"], g,
                                 dict(cm.DEFAULT_RULES), "adamw",
                                 compute_cast=True)["param_bytes_per_tile"]
    if set(tile_bytes) != {cell}:
        fail(f"famgrid serve {arch}: per-tile parameter bytes {tile_bytes} != the dry run's "
             f"decode_32k argument bytes {cell} ({cfg.compute_dtype} matrices)")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, size=(SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    frames = (rng.normal(size=(SERVE_BATCH, SEAMLESS_FRAMES, cfg.d_model)).astype(np.float32)
              if spec.is_encdec else None)
    run = cm.GridRun(eng.rules)

    def place(p, f):
        return (run.place(torch.from_numpy(p).long().cuda(), ("batch", "seq")),
                None if f is None else run.place(torch.from_numpy(f).cuda(),
                                                 ("batch", "seq", "embed")))

    with torch.inference_mode():  # the one warm-up: a short prefill and one decode step
        tok0, fr0 = place(prompts[:, :64], None if frames is None else frames[:, :64])
        lg, cache = lm.prefill(spec, eng.params, tok0, s_max, frames=fr0,
                               rules=eng.prefill_rules)
        lm.decode_step(spec, eng.params, run.place(eng._whole(lg).argmax(-1), ("batch",)),
                       cache, rules=eng.rules)
        del lg, cache, tok0, fr0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    m0 = lm_moves()
    with _FlashShapes(fa) as shapes, _WKVShapes(wk) as wshapes:
        toks = eng.generate(prompts, frames=frames)
    counts = kernels.launch_counts()
    moved = _moved(torch, m0, "lm.serve")
    peak = torch.cuda.max_memory_allocated() / 1e9
    st = eng.stats
    want = _famgrid_want(spec, kernel, g.n_tiles, counts)
    if counts != want:
        fail(f"famgrid serve {arch}: launch counts {counts} != {want}")
    if spec.is_encdec:
        per_tile = _seamless_calls(len(spec.enc_layers()), len(spec.layers()), SERVE_PROMPT,
                                   SEAMLESS_FRAMES)
        if shapes.summary() != {k: g.n_tiles * v for k, v in per_tile.items()}:
            fail(f"famgrid serve {arch}: flash_attention calls {shapes.summary()} != "
                 f"{g.n_tiles} x {per_tile}")
    if toks.shape != (SERVE_BATCH, FAMGRID_NEW) or toks.min() < 0 or toks.max() >= cfg.vocab:
        fail(f"famgrid serve {arch}: tokens of shape {toks.shape} in [{toks.min()}, "
             f"{toks.max()}]")
    if peak > FAMGRID_PEAK_GB:
        fail(f"famgrid serve {arch}: peak {peak:.2f} GB > {FAMGRID_PEAK_GB:g} GB")
    with torch.inference_mode():
        tiles, fr = place(prompts, frames)
        m0 = lm_moves()
        logits, cache = lm.prefill(spec, eng.params, tiles, s_max, frames=fr,
                                   rules=eng.prefill_rules)
        pre_moved = _moved(torch, m0, "lm.serve")
        tok = run.place(eng._whole(logits).float().argmax(-1), ("batch",))
        m0 = lm_moves()  # the decode step alone: its token's gather home is the engine's
        lg, cache = lm.decode_step(spec, eng.params, tok, cache, rules=eng.rules)
        dec_moved = _moved(torch, m0, "lm.serve")
        if not bool(torch.isfinite(eng._whole(lg)[:, :cfg.vocab].float()).all()):
            fail(f"famgrid serve {arch}: decode logits not finite")
    del logits, cache, lg, tiles, fr, tok
    enc = {"enc_len": SEAMLESS_FRAMES} if spec.is_encdec else {}
    anchors = {
        "prefill": meta_anchor(f"[famgrid] serve {arch} prefill", pre_moved, spec, "prefill",
                               SERVE_BATCH, SERVE_PROMPT, grid, eng.prefill_rules, "lm.serve",
                               s_max=s_max, store_rules=eng.rules, **enc),
        "decode": meta_anchor(f"[famgrid] serve {arch} decode step", dec_moved, spec, "decode",
                              SERVE_BATCH, s_max, grid, eng.rules, "lm.serve", pos=SERVE_PROMPT,
                              **enc)}
    step_ms = st.decode_s / st.decode_steps * 1e3
    route, hd = ("wgmma", cfg.hd) if spec.is_encdec else _flash_route(spec, fa)
    what = (f"wkv {counts['wkv']} launches ({g.n_tiles} tiles x {cfg.n_layers} layers)"
            if kernel == "wkv" else
            f"flash_attention {counts['flash_attention']} launches ({g.n_tiles} tiles, the "
            f"{route} route at D={hd})" + (f": {shapes.summary()}" if spec.is_encdec else ""))
    log(f"[famgrid] serve {arch} ({n_params / 1e9:.3f} B params, full width and depth, bf16 "
        f"compute) on a 2x2 grid of the card (init {init_s:.1f} s, peak {init_peak:.2f} GB with "
        f"the weights and the tiles): batch {SERVE_BATCH} x prompt {SERVE_PROMPT}"
        + (f" over frames ({SERVE_BATCH}, {SEAMLESS_FRAMES}, {cfg.d_model})" if frames is not None
           else "")
        + f", {FAMGRID_NEW} greedy tokens: time to first token {st.ttft_s * 1e3:.1f} ms (1x1, "
        f"this run's phase {_famgrid_phase(arch)}: {one['ttft_ms']:.1f}); decode {step_ms:.2f} "
        f"ms/step (1x1: {one['decode_ms_per_step']:.2f}); peak {peak:.2f} GB (1x1: "
        f"{one['peak_gb']:.2f}); {what}, none in decode; tiles {tile_bytes[0]} B of parameters "
        f"each = the dry run's decode_32k argument bytes")
    log(f"[famgrid] serve {arch} moved between grid positions: prefill {_fmt_moved(pre_moved)}; "
        f"one decode step {_fmt_moved(dec_moved)}; the whole generate {_fmt_moved(moved)}")
    out = {"n_layers": cfg.n_layers, "grid": [2, 2], "counts": counts, "init_s": init_s,
           "init_peak_gb": init_peak, "ttft_ms": st.ttft_s * 1e3, "decode_ms_per_step": step_ms,
           "peak_gb": peak, "tile_param_bytes": tile_bytes[0], "dryrun_param_bytes_per_tile": cell,
           "moved_prefill": pre_moved, "moved_decode_step": dec_moved, "moved_generate": moved,
           "meta_anchors": anchors,
           "first_tokens": toks[0].tolist(), "calls": shapes.summary(),
           "one_by_one": {k: one[k] for k in ("ttft_ms", "decode_ms_per_step", "peak_gb")}}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # the kernel at each tile form a prefill gave it (random inputs of those shapes)
    out["kernel_forms"] = {}
    for shape, n in wshapes.forms.items():
        name = f"{arch} 2x2 tile r/k/v {shape} bf16"
        out["kernel_forms"][name] = _wkv_form(torch, name, *shape) | {"calls_per_prefill": n}
    gen = torch.Generator(device="cuda").manual_seed(19)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for (qs, ks, grp, causal, dt), n in shapes.forms.items():
        name = (f"{arch} 2x2 tile q {qs} k/v {ks} {str(dt).removeprefix('torch.')} "
                f"{'causal' if causal else 'non-causal'}, groups {grp}")
        q, k, v = (torch.randn(x, generator=gen, device="cuda").to(dt) for x in (qs, ks, ks))
        out["kernel_forms"][name] = _flash_form(
            torch, fa, ref, name, q, k, v, causal, grp, 2.0**-7 if dt == torch.bfloat16 else 1e-4,
            sdpa, route=route) | {"calls_per_prefill": n}
        del q, k, v
    out["seconds"] = time.perf_counter() - t_model
    return out


def _famgrid_phase(arch: str) -> int:
    return next(p for a, _, p in FAMGRID_SERVE if a == arch)


def _famgrid_train(torch) -> dict:
    """rwkv6-3b at full width and FAMGRID_TRAIN_DEPTH of its 32 layers on the
    2x2 grid (AdamW, bf16 compute, remat) through ``train_loop(grid=)``, phase
    15's batch: loss, grad norm, ms a step, peak memory, moved bytes a step,
    exact launches (four tiles, wkv twice a layer a step under remat), each
    tile's state against the dry run's train_4k argument bytes."""
    import gc

    from repro_torch import configs, kernels
    from repro_torch.core.collectives import lm_moves
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import as_grid
    from repro_torch.launch.train import train_loop
    from repro_torch.models import common as cm
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    cfg = configs.get_config(FAMGRID_TRAIN).replace(n_layers=FAMGRID_TRAIN_DEPTH)
    spec = lm.build_spec(cfg)
    grid = _grid_of(torch, 2, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    m0 = lm_moves()
    hist: list = []
    params, opt, _ = train_loop(cfg, steps=FAMGRID_TRAIN_STEPS, batch=FAMGRID_TRAIN_BATCH,
                                seq=FAMGRID_TRAIN_SEQ, device="cuda", grid=grid, history=hist,
                                log_every=100)
    counts = kernels.launch_counts()
    moved = _moved(torch, m0, "lm.train")
    anchor = meta_anchor(f"[famgrid] train {cfg.name}", moved, spec, "train",
                         FAMGRID_TRAIN_BATCH, FAMGRID_TRAIN_SEQ, grid, None, "lm.train",
                         steps=FAMGRID_TRAIN_STEPS, opt_name=cfg.optimizer)
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {name: 0 for name in counts} | {"wkv": 4 * 2 * cfg.n_layers * FAMGRID_TRAIN_STEPS}
    if counts != want:
        fail(f"famgrid train {FAMGRID_TRAIN}: launch counts {counts} != {want}")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist):
        fail(f"famgrid train: non-finite loss or grad norm {hist}")
    if peak > FAMGRID_PEAK_GB:
        fail(f"famgrid train: peak {peak:.2f} GB > {FAMGRID_PEAK_GB} GB")
    cell = dryrun.argument_bytes(spec, configs.SHAPES_BY_NAME["train_4k"], as_grid(grid),
                                 dict(cm.DEFAULT_RULES), cfg.optimizer)
    pb = [sum(x.numel() * x.element_size() for x in tree_leaves(p)) for p in params]
    ob = [sum(x.numel() * x.element_size() for x in tree_leaves(o)) for o in opt]
    if set(pb) != {cell["param_bytes_per_tile"]} or set(ob) != {cell["opt_state_bytes_per_tile"]}:
        fail(f"famgrid train: per-tile bytes {pb} / {ob} != the dry run's "
             f"{cell['param_bytes_per_tile']} / {cell['opt_state_bytes_per_tile']}")
    ms = hist[-1]["seconds"] * 1e3
    tokens = FAMGRID_TRAIN_BATCH * FAMGRID_TRAIN_SEQ
    log(f"[famgrid] train {FAMGRID_TRAIN} at full width, {cfg.n_layers} of 32 layers, on a 2x2 "
        f"grid of the card (AdamW, bf16 compute, remat; batch {FAMGRID_TRAIN_BATCH} x "
        f"{FAMGRID_TRAIN_SEQ}): "
        + "; ".join(f"step {i} loss {h['loss']:.4f} grad norm {h['grad_norm']:.4f} "
                    f"{h['seconds'] * 1e3:.1f} ms" for i, h in enumerate(hist))
        + f"; {tokens / ms * 1e3:.0f} tokens/s after the first; peak {peak:.2f} GB; wkv "
        f"{counts['wkv']} launches (4 tiles x 2 x {cfg.n_layers} x {FAMGRID_TRAIN_STEPS}); moved "
        f"a step: {_fmt_moved(moved, FAMGRID_TRAIN_STEPS)}; per tile {pb[0]} B of parameters "
        f"and {ob[0]} B of AdamW state = the dry run's")
    out = {"counts": counts, "depth": cfg.n_layers, "history": hist, "peak_gb": peak,
           "ms_per_step": ms, "moved": moved, "meta_anchor": anchor,
           "param_bytes_per_tile": pb[0],
           "opt_bytes_per_tile": ob[0]}
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _famgrid_card_vs_cpu(torch, arch: str) -> dict:
    """The card's 2x2 grid against the CPU's, fp32, the same weights (drawn on
    the card, seed 0) and inputs, full width at FAMGRID_CHECK_DEPTH: serving
    batch 2 x a prompt of 100 (seamless over FAMGRID_CHECK_FRAMES frames), 8
    greedy tokens equal, last-position logits within 1e-3 of the largest,
    the card's launches exact (every tile once a call in prefill) and none
    on the CPU; one AdamW step at batch 2 x 64 on each grid and on each
    device's 1x1: each grid's loss and grad norm within FAMGRID_RTOL of its
    1x1 step's, and the card grid's within FAMGRID_RTOL of the CPU grid's
    (rwkv6's grad norm within phase 15's TRAIN_FP32_RTOL)."""
    import numpy as np

    from repro_torch import configs, kernels
    from repro_torch.data import DataConfig, host_batch
    from repro_torch.models import common as cm
    from repro_torch.models import lm
    from repro_torch.serving import ServeConfig, ServeEngine
    from repro_torch.training import OptConfig, make_train_step
    from repro_torch.training import optim
    from repro_torch.training import train_step as ts
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    full = configs.get_config(arch)
    depth = FAMGRID_CHECK_DEPTH[arch]
    over = {"n_layers": depth, "compute_dtype": "float32"}
    if full.family == "encdec":
        over |= {"enc_layers": depth, "dec_layers": depth, "n_layers": 2 * depth}
    cfg = full.replace(**over)
    spec = lm.build_spec(cfg)
    kernel = "wkv" if cfg.rwkv else "flash_attention"
    params = lm.init_params(spec, seed=0, device="cuda")
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab, size=(2, 100)).astype(np.int32)
    frames = (rng.normal(size=(2, FAMGRID_CHECK_FRAMES, cfg.d_model)).astype(np.float32)
              if spec.is_encdec else None)
    ocfg = OptConfig(name=cfg.optimizer, lr=1e-3, warmup_steps=5, total_steps=10)
    batch = host_batch(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2, seed=0,
                                  frames_dim=cfg.d_model if spec.is_encdec else 0), 0)
    whole = lm.params_tree(spec, params)
    res = {}
    for dev in ("cuda", "cpu"):
        grid = _grid_of(torch, 2, 2, dev)
        eng = ServeEngine(spec, params, s_max=108, cfg=ServeConfig(max_new_tokens=8),
                          device=dev, grid=grid)
        kernels.reset_launch_counts()
        toks = eng.generate(prompts, frames=frames)
        counts = kernels.launch_counts()
        want = (_famgrid_want(spec, kernel, 4, counts) if dev == "cuda"
                else {name: 0 for name in counts})
        if dev == "cuda":  # fp32 takes the SIMT route at every D
            want["flash_attention_wgmma"] = 0
        if counts != want:
            fail(f"famgrid {arch} on the {dev} grid: launches {counts}, want {want}")
        run = cm.GridRun(eng.rules)
        with torch.inference_mode():
            lg, _ = lm.prefill(spec, eng.params,
                               run.place(torch.from_numpy(prompts).long().to(dev),
                                         ("batch", "seq")), 108,
                               frames=None if frames is None else run.place(
                                   torch.from_numpy(frames).to(dev), ("batch", "seq", "embed")),
                               rules=eng.prefill_rules)
        lg = eng._whole(lg)[:, :cfg.vocab].float().cpu()
        del eng
        pspecs, _ = ts.grid_specs(spec, ocfg, grid)
        tiles = cm.shard_tree(tree_map(lambda t: t.detach().requires_grad_(True), whole),
                              pspecs, grid)
        opt = [optim.make_optimizer(ocfg)[0](p) for p in tiles]
        _, _, m = make_train_step(spec, ocfg, grid=grid)(tiles, opt, batch)
        del tiles, opt
        # the 1x1 step's loss and grad norm (its update changes neither)
        one = tree_map(lambda t: t.detach().to(dev, copy=True).requires_grad_(True), whole)
        loss1, _, g1 = ts.make_loss_and_grad(spec)(one, ts.batch_to_device(batch, dev))
        gn1 = optim.global_norm(g1)
        del one, g1
        res[dev] = (toks, lg, {k: float(m[k]) for k in ("loss", "grad_norm")}, counts,
                    {"loss": float(loss1), "grad_norm": float(gn1)})
    del params, whole
    card, cpu = res["cuda"], res["cpu"]
    if not np.array_equal(card[0], cpu[0]):
        fail(f"famgrid {arch} card vs CPU grid: greedy tokens differ: {card[0].tolist()} vs "
             f"{cpu[0].tolist()}")
    err, scale = check_close(f"famgrid {arch} card vs CPU grid prefill logits", card[1], cpu[1],
                             1e-3)

    def rel_of(a, b):
        return {k: abs(a[k] - b[k]) / abs(b[k]) for k in a}

    # the grid against its own device's 1x1 step, then the two devices' grids
    own = {d: rel_of(res[d][2], res[d][4]) for d in res}
    for d, r in own.items():
        if not all(v <= FAMGRID_RTOL for v in r.values()):
            fail(f"famgrid {arch} {d} 2x2 grid vs {d} 1x1: train step {res[d][2]} against "
                 f"{res[d][4]}: relative {r} > {FAMGRID_RTOL:g}")
    rel = rel_of(card[2], cpu[2])
    # rwkv6's gradient at init amplifies the last bits of its position-0 group
    # norm (TRAIN_GNORM_UNGATED, ROADMAP Queue 3): its grad norm, card against
    # CPU, is gated as phase 15 gates it, and printed beside the 1x1 steps'
    tol = {"loss": FAMGRID_RTOL,
           "grad_norm": TRAIN_FP32_RTOL if arch in TRAIN_GNORM_UNGATED else FAMGRID_RTOL}
    rel_one = rel_of(card[4], cpu[4])
    if not all(rel[k] <= tol[k] for k in rel):
        fail(f"famgrid {arch} card vs CPU grid: train step {card[2]} against {cpu[2]}: relative "
             f"{rel} > {tol} (1x1 card vs CPU: {rel_one})")
    setup = (f"full width, {depth} + {depth} layers over {FAMGRID_CHECK_FRAMES} frames"
             if spec.is_encdec else f"full width, depth {depth}")
    log(f"[famgrid] {arch} card 2x2 grid vs CPU 2x2 grid ({setup}, fp32, "
        f"{time.perf_counter() - t0:.1f} s): batch 2 x prompt 100, 8 greedy tokens equal, "
        f"{kernel} launched {card[3][kernel]} times on the card; prefill logits max |diff| "
        f"{err:.3e} (tol 1e-3 x max|logit| {scale:.3e}); one {cfg.optimizer} step at batch 2 x 64: "
        f"loss {card[2]['loss']:.6f} (rel {rel['loss']:.2e}), grad norm "
        f"{card[2]['grad_norm']:.6f} (rel {rel['grad_norm']:.2e}; tol {tol['grad_norm']:g}); "
        f"1x1 card vs CPU rel loss {rel_one['loss']:.2e}, grad norm {rel_one['grad_norm']:.2e}; "
        f"2x2 vs 1x1 on the card {own['cuda']['loss']:.2e} / {own['cuda']['grad_norm']:.2e}, "
        f"on the CPU {own['cpu']['loss']:.2e} / {own['cpu']['grad_norm']:.2e} (tol "
        f"{FAMGRID_RTOL:g})")
    return {"setup": setup, "tokens_equal": True, "logits_err": err, "max_logit": scale,
            "train": card[2], "train_cpu": cpu[2], "train_rel": rel, "train_tol": tol,
            "train_1x1": card[4], "train_1x1_cpu": cpu[4], "train_rel_1x1": rel_one,
            "grid_vs_1x1": own, "card_counts": card[3], "seconds": time.perf_counter() - t0}


def phase_famgrid(torch, rows: list, one: dict) -> dict:
    """Phase 19: the last LM families on a 2x2 grid of the one card --
    rwkv6-3b, zamba2-7b and seamless-m4t-medium served at full width and
    depth, rwkv6-3b trained at 4 of its 32 layers, each tile form of their
    kernels against its plain version, and the card's grid against the
    CPU's in fp32.  ``one``: each model's 1x1 serve figures (phases 9, 13, 14)."""
    import gc

    t_phase = time.perf_counter()
    log(f"[famgrid] phase 19 starts with {torch.cuda.memory_allocated() / 1e9:.2f} GB in use")
    out = {"serve": {}}
    for arch, kernel, _ in FAMGRID_SERVE:
        out["serve"][arch] = _famgrid_serve(torch, arch, kernel, one[arch])
        gc.collect()
        torch.cuda.empty_cache()
    for name in ("wkv", "flash_attention"):
        next(r for r in rows if r["name"] == name)["famgrid_forms"] = {
            k: v for a in out["serve"].values() for k, v in a["kernel_forms"].items()
            if k.split(" ")[3] == ("r/k/v" if name == "wkv" else "q")}
    out["train"] = _famgrid_train(torch)
    gc.collect()
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = {arch: _famgrid_card_vs_cpu(torch, arch) for arch, *_ in FAMGRID_SERVE}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[famgrid] phase 19 in {out['seconds']:.1f} s (aim: under {FAMGRID_BUDGET_S:g} s; "
        + ", ".join(f"{a} serve {v['seconds']:.1f}" for a, v in out["serve"].items())
        + ", card vs CPU " + ", ".join(f"{a} {v['seconds']:.1f}"
                                       for a, v in out["card_vs_cpu"].items()) + ")")
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

    t_start = time.perf_counter()
    resolve_device("cuda")  # TF32 off for every fp32 product below
    OUT.mkdir(exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    dry_cells = DryrunCells().start()  # phase 16 (a), on meta, beside the build
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
    cells = dry_cells.join()

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
    s64 = yardstick["float64"][1]  # phase 11's float64 reference for transition 0
    s5_t0 = yardstick["out-of-core stream_gemm"][1].numpy()  # phase 12's reference
    del yardstick
    phase_oocore_end_to_end(torch)
    torch.cuda.empty_cache()
    incremental = phase_incremental(torch)
    torch.cuda.empty_cache()
    query = phase_query(torch, resident, per_query)
    torch.cuda.empty_cache()
    serve = phase_serve(torch, per_lm)
    torch.cuda.empty_cache()
    paper = phase_paper(torch, smi)
    torch.cuda.empty_cache()
    grid = phase_grid(torch, rows, resident, s64)
    torch.cuda.empty_cache()
    grid_oocore = phase_grid_oocore(torch, rows, oocore, s5_t0)
    torch.cuda.empty_cache()
    serve2 = phase_serve_families(torch)
    torch.cuda.empty_cache()
    seamless = phase_seamless(torch, rows)
    torch.cuda.empty_cache()
    train = phase_train(torch, rows)
    torch.cuda.empty_cache()
    dry = phase_dryrun(torch, train, grid, cells)
    torch.cuda.empty_cache()
    lmgrid = phase_lmgrid(torch, serve)
    torch.cuda.empty_cache()
    moegrid = phase_moegrid(torch, rows)
    torch.cuda.empty_cache()
    famgrid = phase_famgrid(torch, rows, {"rwkv6-3b": serve["rwkv6-3b"],
                                          "zamba2-7b": serve2["zamba2-7b"], SEAMLESS: seamless})
    for row in rows:
        by_path = {"resident": resident["counts"][row["name"]],
                   "oocore": oocore["counts"][row["name"]],
                   "incremental": incremental["resident"]["counts"][row["name"]],
                   "incremental oocore": incremental["oocore"]["counts"][row["name"]],
                   "query": query["n=10512"]["counts"][row["name"]],
                   f"query n={N_LARGE}": query[f"n={N_LARGE}"]["counts"][row["name"]]}
        by_path |= {f"serve {arch}": serve[arch]["counts"][row["name"]] for arch, _ in SERVE_MODELS}
        by_path["paper"] = paper["counts"][row["name"]]
        by_path["grid"] = grid["counts"][row["name"]]
        by_path["grid oocore"] = grid_oocore["counts"][row["name"]]
        by_path |= {f"serve {arch}": serve2[arch]["counts"][row["name"]]
                    for arch, *_ in SERVE2_MODELS}
        by_path[f"serve {SEAMLESS}"] = seamless["counts"][row["name"]]
        by_path |= {f"train {arch}": train[arch]["counts"][row["name"]]
                    for arch, *_ in TRAIN_MODELS}
        by_path[f"lmgrid serve {LMGRID_SERVE}"] = lmgrid["serve"]["counts"][row["name"]]
        by_path[f"lmgrid train {LMGRID_TRAIN}"] = lmgrid["train"]["counts"][row["name"]]
        by_path |= {f"moegrid serve {arch}": moegrid["serve"][arch]["counts"][row["name"]]
                    for arch, *_ in MOEGRID_SERVE}
        by_path[f"moegrid train {MOEGRID_TRAIN}"] = moegrid["train"]["counts"][row["name"]]
        by_path |= {f"famgrid serve {arch}": famgrid["serve"][arch]["counts"][row["name"]]
                    for arch, *_ in FAMGRID_SERVE}
        by_path[f"famgrid train {FAMGRID_TRAIN}"] = famgrid["train"]["counts"][row["name"]]
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        if row["name"] == "flash_attention":
            row["launches_wgmma"] = (
                sum(serve[arch]["counts"]["flash_attention_wgmma"] for arch, _ in SERVE_MODELS)
                + sum(serve2[arch]["counts"]["flash_attention_wgmma"] for arch, *_ in SERVE2_MODELS)
                + seamless["counts"]["flash_attention_wgmma"]
                + sum(train[arch]["counts"]["flash_attention_wgmma"] for arch, *_ in TRAIN_MODELS)
                + lmgrid["serve"]["counts"]["flash_attention_wgmma"]
                + lmgrid["train"]["counts"]["flash_attention_wgmma"]
                + sum(moegrid["serve"][arch]["counts"]["flash_attention_wgmma"]
                      for arch, *_ in MOEGRID_SERVE)
                + moegrid["train"]["counts"]["flash_attention_wgmma"]
                + sum(famgrid["serve"][arch]["counts"]["flash_attention_wgmma"]
                      for arch, *_ in FAMGRID_SERVE))
        if row["name"] == "stream_gemm":
            row["launches_tc"] = (oocore["counts"]["stream_gemm_tc"]
                                  + incremental["oocore"]["counts"]["stream_gemm_tc"]
                                  + paper["counts"]["stream_gemm_tc"]
                                  + grid_oocore["counts"]["stream_gemm_tc"])
    (OUT / "chip_smoke_oocore.json").write_text(json.dumps(
        {"card": smi, "per_launch": per_launch, **oocore, "chain_float64_yardstick": chain64},
        indent=1))
    (OUT / "chip_smoke_incremental.json").write_text(json.dumps({"card": smi, **incremental},
                                                                indent=1))
    (OUT / "chip_smoke_query.json").write_text(json.dumps({"card": smi, **query}, indent=1))
    (OUT / "chip_smoke_serve.json").write_text(json.dumps(
        {"card": smi, **serve, "phase 13 (the other decoder families)": serve2,
         "phase 14 (seamless-m4t-medium)": seamless}, indent=1))
    (OUT / "chip_smoke_train.json").write_text(json.dumps({"card": smi, **train}, indent=1))
    (OUT / "chip_smoke_dryrun.json").write_text(json.dumps({"card": smi, **dry}, indent=1,
                                                           default=str))
    (OUT / "chip_smoke_paper.json").write_text(json.dumps({"card": smi, **paper}, indent=1))
    (OUT / "chip_smoke_lmgrid.json").write_text(json.dumps({"card": smi, **lmgrid}, indent=1,
                                                           default=str))
    (OUT / "chip_smoke_moegrid.json").write_text(json.dumps({"card": smi, **moegrid}, indent=1,
                                                            default=str))
    (OUT / "chip_smoke_famgrid.json").write_text(json.dumps({"card": smi, **famgrid}, indent=1,
                                                            default=str))
    (OUT / "chip_smoke_grid.json").write_text(json.dumps(
        {"card": smi, **grid, "phase 12 (out of core on the grid)": grid_oocore}, indent=1,
        default=str))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    table = {"kernels": [{**{k: r[k] for k in keys},
                          **{k: v for k, v in r.items() if k not in keys}} for r in rows]}
    (OUT / "chip_smoke_kernels.json").write_text(json.dumps(table, indent=1))
    log(f"[smoke] all phases in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(table))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
