"""Run one cell of ``BENCHMARK.json`` once: set up, measure, check, report.

Everything a cell is made of is found by name: its workload entry in
``BENCHMARK.json``, its configuration's file, ``traffic/<traffic>.json``,
``cells/<cell>.json`` (the correctness check's sample and limits) and, for
each per-layer metric, ``metrics/<metric>.py``.  A new cell or metric is new
files and new entries; this module does not change.

A run: the program's kernels are loaded (built on a checkout's first run),
the first snapshot's chain is built and one transition scored, and that is
the set-up.  Then one writer pushes snapshot after snapshot into
``repro_torch.core.sequence.SequenceDetector.push`` in a closed loop for
``seconds``; the benchmark makes each snapshot on the device from the seed
between pushes.  With ``trace`` the window's first part runs with the
program's phase counters fenced, and its last few seconds unfenced under
``torch.profiler``.  Once the window has closed, the peak memory is read,
the program's state is freed, and a sample of the window's transitions,
drawn from the seed, is scored again by ``reference.py`` from the same
snapshots, rebuilt from the seed; the embedding of the newest snapshot,
which the detector still holds when the window closes, is read against
the reference's embedding of that snapshot.  A cell's limits say which of
the numbers read its check holds.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import random
import statistics
import sys
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path

from caddelag_bench import devtrace, generate, reference

BENCH_DIR = "caddelag_bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROFILE_SECONDS = 3.0  # the traced run's unfenced, profiled tail of the window
PHASES = ("chain", "ingest", "solve", "score")
UNUSABLE = 1e30  # what a check reads for outputs it cannot compare (JSON has no infinity)


def forbidden_loaded() -> list[str]:
    """Top-level names of loaded modules that a run may not load, compared whole."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def find_cell(name: str, root: Path) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files read."""
    spec = _load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = root / BENCH_DIR
    e2e = [m for m in spec["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_load_json(root / conf["file"]),
        traffic=_load_json(bench / "traffic" / f"{w['traffic']}.json"),
        check=_load_json(bench / "cells" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=[m for m in spec["per_layer"] if _reports(m, name, names)],
    )


def load_reader(root: Path, metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = root / BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "caddelag_bench_metric_" + "".join(c if c.isalnum() else "_" for c in metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Readings:
    """What the per-layer readers read: the fenced part's counters and the profiled slice."""

    n: int
    k: int
    d: int
    on_card: bool
    transitions: int = 0  # transitions scored in the fenced part
    push_seconds: float = 0.0  # their ``push`` walls alone (no snapshot build), summed
    phase_seconds: dict = field(default_factory=dict)  # phase.<name>.seconds over them
    phase_calls: dict = field(default_factory=dict)
    profile: dict | None = None  # devtrace.summarize of the profiled slice


def commute_config(settings: dict):
    """The program's ``CommuteConfig`` from a configuration's ``commute`` group."""
    import torch
    from repro_torch.core.embedding import CommuteConfig

    kw = dict(settings)
    kw["dtype"] = getattr(torch, kw.get("dtype", "float32"))
    return CommuteConfig(**kw)


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------


def compare(scores, top_idx, ref, top_k: int) -> dict:
    """The numbers compared for one transition, read against the reference's scores.

    ``score_gap``: the widest gap between a score and the reference's, over
    the largest reference score; ``score_rms``: the root mean square of the
    gaps over that of the reference's scores.  ``top_gap``: how far the
    program's top-k, ranked by the reference's scores, lies below the
    reference's own top-k at any rank, over the largest reference score (0
    when the sets agree).  Scores that are not finite or of the wrong shape,
    and a top-k that is not ``top_k`` distinct node ids, read ``UNUSABLE``.
    A cell's limits say which of them its check holds.
    """
    import torch

    n = ref.shape[0]
    scale = float(ref.abs().max()) or 1.0
    out = {"score_gap": UNUSABLE, "score_rms": UNUSABLE, "top_gap": UNUSABLE}
    if tuple(scores.shape) == (n,) and bool(torch.isfinite(scores).all()):
        gap = scores.double() - ref
        out["score_gap"] = float(gap.abs().max()) / scale
        out["score_rms"] = float(gap.norm() / (ref.norm() or 1.0))
    ids = top_idx.to(torch.int64)
    if (ids.numel() == top_k and int(ids.min()) >= 0 and int(ids.max()) < n
            and int(torch.unique(ids).numel()) == top_k):
        picked = torch.sort(ref[ids], descending=True).values
        best = torch.sort(ref, descending=True).values[:top_k]
        out["top_gap"] = float((best - picked).max()) / scale
    return out


def compare_embedding(z, z_ref) -> dict:
    """The numbers compared for one snapshot's embedding Z (n, k), against the reference's.

    Z is defined up to a shift of each column (the Laplacian's null space;
    the scores read only differences z_i - z_j), so both sides' columns are
    centred in float64 first.  ``z_gap``: the widest gap between an entry
    and the reference's, over the reference's largest entry; ``z_rms``: the
    Frobenius norm of the gaps over the reference's.  A Z that is not finite
    or of the wrong shape reads ``UNUSABLE``.
    """
    import torch

    if tuple(z.shape) != tuple(z_ref.shape) or not bool(torch.isfinite(z).all()):
        return {"z_gap": UNUSABLE, "z_rms": UNUSABLE}
    z, z_ref = (x.double() - x.double().mean(dim=0, keepdim=True) for x in (z, z_ref))
    gap = z - z_ref
    return {"z_gap": float(gap.abs().max() / (z_ref.abs().max() or 1.0)),
            "z_rms": float(gap.norm() / (z_ref.norm() or 1.0))}


def worst(readings: list[dict]) -> dict:
    """Each number's largest reading over the answers that read it."""
    keys = {key for r in readings for key in r}
    return {key: max(r[key] for r in readings if key in r) for key in sorted(keys)}


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(cell: Cell, root: Path, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None) -> dict:
    """One run of ``cell``; returns the result object (its ``checks`` last)."""
    import torch
    from repro_torch.core.sequence import SequenceDetector

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = dev.type == "cuda"
    if on_card:
        from repro_torch.kernels import _build

        _build.library()
    detector = cell.config["detector"]
    cfg = commute_config(cell.config["commute"])
    n = generate.n_nodes(cell.config)
    top_k = int(detector["top_k"])
    det = SequenceDetector(cfg, top_k=top_k, donate=bool(detector["donate"]), device=dev)
    stream = generate.SnapshotStream(cell.config, cell.traffic, seed, dev)
    prints = []  # the fingerprint of every snapshot handed over, by snapshot index

    def hand_over():
        """Make the next snapshot and push it; returns the ``push`` wall alone."""
        a, fp = stream.next()
        prints.append(fp)
        t0 = time.perf_counter()
        det.push(a)
        return time.perf_counter() - t0

    for _ in range(2):  # the first chain build and one scored transition
        hand_over()
    _sync(dev)
    setup_s = time.perf_counter() - t_start

    rd = Readings(n=n, k=cfg.k_rp(n), d=cfg.d, on_card=on_card)
    walls = []
    w0 = time.perf_counter()
    if not trace:
        while True:
            t0 = time.perf_counter()
            hand_over()
            walls.append(time.perf_counter() - t0)
            if time.perf_counter() - w0 >= seconds:
                break
    else:
        _traced_window(hand_over, walls, rd, dev, w0, seconds)
    _sync(dev)
    window = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    # The newest snapshot's embedding: the detector keeps it for the next push.
    newest = det._prev[1]
    z_newest = newest.z.detach().cpu()
    res = det.finalize()
    window_steps = len(res.transitions) - 1  # transition 0 was the set-up's
    rnd = random.Random(seed)
    chosen = sorted(rnd.sample(range(1, window_steps + 1),
                               min(int(cell.check["check_transitions"]), window_steps)))
    outputs = {j: (res.transitions[j].scores.detach().cpu(), res.transitions[j].top_idx.cpu())
               for j in chosen}
    prints = [int(p) for p in prints]
    del det, res, newest, stream, hand_over
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    checks, notes = _check(cell, seed, dev, chosen, outputs, z_newest, prints, top_k)
    limits = cell.check["limits"]
    failed = sum(any(r[k] > limits[k] for k in limits if k in r) for r in checks)
    found = worst(checks) if checks else {k: UNUSABLE for k in limits}
    if any(k not in found for k in limits):
        raise KeyError(f"limits {sorted(limits)} name a number that no comparison reads")
    correct = len(checks) == len(chosen) + 1 and not notes and failed == 0

    metrics = {}
    if trace:
        values = {m["name"]: load_reader(root, m["name"])(rd) for m in cell.per_layer}
        for m in cell.per_layer:
            if values[m["name"]] is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        values = {
            "setup_s": setup_s,
            "transition_ms": window / len(walls) * 1e3,
            "transition_p90_ms": _p90(walls) * 1e3,
            "peak_device_gb": peak / 1e9,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(walls), "failed": failed, "metrics": metrics,
           "device": device_info}
    if trace and rd.profile is not None:
        device_info["busy_s"] = rd.profile["busy_s"]
        device_info["window_s"] = rd.profile["window_s"]
        out["breakdown"] = {"device_ops": rd.profile["device_ops"],
                            "idle_gaps": rd.profile["idle_gaps"]}
    if notes:
        out["notes"] = notes
    out["readings"] = found  # every number the comparisons read, the worst over the sample
    out["checks"] = {k: {"value": found[k], "limit": limits[k]} for k in limits}
    return out


def _p90(walls: list[float]) -> float:
    if len(walls) < 2:
        return walls[0]
    return statistics.quantiles(walls, n=10, method="inclusive")[8]


def _traced_window(hand_over, walls, rd: Readings, dev, w0: float, seconds: float) -> None:
    """The fenced part (phase counters are device walls), then the profiled, unfenced tail.

    The tail's length is counted from the profiler's start, so the window
    runs past ``seconds`` by the profiler's own start-up.
    """
    import torch
    from repro_torch.obs import REGISTRY, disable_tracing, enable_tracing
    from torch.profiler import ProfilerActivity, profile, record_function

    fenced_until = max(seconds - PROFILE_SECONDS, 0.5 * seconds)
    enable_tracing(fence=True)
    snap = REGISTRY.snapshot()
    try:
        while True:
            t0 = time.perf_counter()
            rd.push_seconds += hand_over()
            walls.append(time.perf_counter() - t0)
            if time.perf_counter() - w0 >= fenced_until:
                break
    finally:
        disable_tracing()
    delta = REGISTRY.delta(snap)
    rd.transitions = len(walls)
    for p in PHASES:
        rd.phase_seconds[p] = delta.get(f"phase.{p}.seconds", 0.0)
        rd.phase_calls[p] = int(delta.get(f"phase.{p}.calls", 0))

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*Profiler clears events")
        with profile(activities=acts) as prof:
            with record_function(devtrace.WINDOW):
                p0 = time.perf_counter()  # the profiler's own start-up lies before this
                while True:
                    t0 = time.perf_counter()
                    with record_function("bench.push"):
                        hand_over()
                    walls.append(time.perf_counter() - t0)
                    if time.perf_counter() - p0 >= seconds - fenced_until:
                        break
            _sync(dev)
    rd.profile = devtrace.summarize(devtrace.export_events(prof)) if dev.type == "cuda" else None


def _check(cell: Cell, seed: int, dev, chosen: list[int], outputs: dict, z_newest,
           prints: list[int], top_k: int):
    """The reference's readings of each chosen transition and of the newest embedding.

    The snapshots are rebuilt from the seed (their features' fingerprints
    checked against those handed over), and each snapshot's reference
    embedding is worked out once.  Transition j scores snapshot j -> j + 1;
    the newest snapshot is the last one handed over.
    """
    import torch

    commute = cell.config["commute"]
    newest = len(prints) - 1
    wanted = sorted({t for j in chosen for t in (j, j + 1)} | {newest})
    replay = generate.SnapshotStream(cell.config, cell.traffic, seed, dev)
    readings, notes = [], []
    adj, emb = {}, {}  # snapshot index -> adjacency, reference (Z, vol): the last one only

    with torch.no_grad():
        for t in wanted:
            while replay.t < t:
                feats, inj = replay.next_features()
                if replay.t == t:
                    if int(generate.fingerprint(feats)) != prints[t]:
                        notes.append(f"snapshot {t} rebuilt from the seed is not the one "
                                     f"handed over")
                    adj[t] = replay.build(feats, inj)
            emb[t] = reference.embedding(adj[t], commute, "float64")
            if t == newest:
                readings.append(compare_embedding(z_newest, emb[t][0].cpu()))
            if t - 1 in chosen:
                (z1, vol1), (z2, vol2) = emb[t - 1], emb[t]
                ref = reference.cad_scores(adj[t - 1], adj[t], z1, vol1, z2, vol2).cpu()
                scores, top_idx = outputs[t - 1]
                readings.append(compare(scores, top_idx, ref, top_k))
                del ref
            for old in [s for s in adj if s != t]:
                del adj[old], emb[old]
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return readings, notes
