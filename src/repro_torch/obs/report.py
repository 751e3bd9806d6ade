"""Structured run reports: versioned JSON telemetry for a sequence run.

Port of :mod:`repro.obs.report`, the same document (kind
``caddelag_run_report``, schema 2) and the same validators, kept here so the
port imports nothing of the JAX package.  ``build_run_report`` turns a
finished :class:`~repro_torch.core.sequence.SequenceResult` plus the metrics
registry into the per-transition phase breakdown (ingest/chain/solve/score),
bytes read/decoded/H2D/saved, the chain's build and incremental-update
counters, solver iterations/residual series/convergence flags, prefetch
efficiency and the streamed-solve roofline share
(``caddelag-run-torch --run-report out.json``).  The port keeps no compiled
program cache, so the ``cache`` section reads zero.

``validate_run_report`` / ``validate_chrome_trace`` are dependency-free
structural validators:

    python -m repro_torch.obs.report report.json trace.json

validates any mix of run reports and Chrome traces, exiting nonzero with a
list of problems on failure.

Totals are read from the same registry counters ``stream_stats()`` serves,
so the report's byte totals equal those counters on the same run by
construction.  As in the reference, the ``totals``, ``chain`` and ``solver``
sections are the process's counters at report time: in a process that ran
other sequences first they include those runs too.  The per-transition
records and ``warmup`` hold this run's own deltas, and
``caddelag-run-torch``'s incremental summary line counts this run alone; in
the CLI's own process (one run) the two readings agree.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Mapping

import numpy as np

from repro_torch.obs.metrics import REGISTRY, MetricsRegistry
from repro_torch.obs.roofline import streamed_solve_flops, streamed_solve_roofline

RUN_REPORT_KIND = "caddelag_run_report"
# Schema history:
#   1 -- initial: transitions/totals/cache/pipeline/solver/roofline.
#   2 -- adds the top-level "chain" section (build vs incremental-update
#        counters and logical GEMM flops/bytes/scratch) and per-transition
#        "chain" counter deltas (additive; all new fields default to zero
#        counters, so a schema-1 consumer reading schema 2 loses nothing).
RUN_REPORT_SCHEMA = 2

# Chain-phase registry counters surfaced in the report, totals and
# per-transition (see repro_torch.core.chain / repro_torch.core.delta_chain).
CHAIN_FIELDS = (
    "builds", "full_rebuilds", "incremental_updates", "drift_fallbacks",
    "gemm_flops", "gemm_bytes", "scratch_bytes",
    "delta_gemm_flops", "delta_gemm_bytes",
)


def _chain_from_delta(delta: Mapping[str, float]) -> dict[str, float]:
    return {f: float(delta.get(f"chain.{f}", 0.0)) for f in CHAIN_FIELDS}

# The per-transition phase vocabulary, in pipeline order.  `phase()` spans and
# registry counters use exactly these names (phase.<name>.seconds).
PHASES = ("ingest", "chain", "solve", "score")

_BYTE_FIELDS = ("bytes_read", "bytes_decoded", "bytes_h2d", "bytes_h2d_saved")


def _phases_from_delta(delta: Mapping[str, float]) -> dict[str, float]:
    return {p: float(delta.get(f"phase.{p}.seconds", 0.0)) for p in PHASES}


def _bytes_from_delta(delta: Mapping[str, float]) -> dict[str, int]:
    return {f: int(delta.get(f"stream.{f}", 0)) for f in _BYTE_FIELDS}


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _solve_record(rep: Any) -> dict[str, Any]:
    return {
        "method": rep.method,
        "iterations": int(rep.iterations),
        "residual": float(rep.residual),
        "converged": bool(rep.converged),
        "tolerance": None if rep.tolerance is None else float(rep.tolerance),
        "max_iters": int(rep.max_iters),
        "streamed": bool(rep.streamed),
        "rho": None if rep.rho is None else float(rep.rho),
        "rho_final": None
        if getattr(rep, "rho_final", None) is None
        else float(rep.rho_final),
        "warm_start": bool(getattr(rep, "warm_start", False)),
        "bytes_read": int(rep.bytes_read),
        "bytes_h2d": int(getattr(rep, "bytes_h2d", 0)),
        "panels": int(rep.panels),
        "residuals": [float(r) for r in getattr(rep, "residuals", ())],
    }


def build_run_report(
    *,
    config: Mapping[str, Any],
    result: Any,
    n: int | None = None,
    k_rp: int | None = None,
    reg: MetricsRegistry | None = None,
) -> dict[str, Any]:
    """Assemble the versioned run-report document for a finished sequence run.

    ``result`` is a :class:`~repro_torch.core.sequence.SequenceResult`;
    ``config`` is whatever JSON-serializable run configuration the caller
    wants embedded (the CLI passes its resolved argument dict).  ``n`` and
    ``k_rp`` enable the streamed-solve roofline attribution when given.
    Registry totals are read at call time, so build the report at end of run,
    after the last transition; they are process-wide (see the module doc).
    """
    reg = reg or REGISTRY
    snap = reg.snapshot()
    c = snap.counters

    per_push = list(getattr(result, "transition_metrics", ()) or ())
    transitions: list[dict[str, Any]] = []
    warnings: list[dict[str, Any]] = []
    for t, r in enumerate(result.transitions):
        delta = per_push[t] if t < len(per_push) else {}
        solves = [_solve_record(rep) for rep in r.solve_reports if rep is not None]
        rec = {
            "index": t,
            "seconds": float(result.transition_seconds[t])
            if t < len(result.transition_seconds)
            else None,
            "phases": _phases_from_delta(delta),
            "bytes": _bytes_from_delta(delta),
            "chain": _chain_from_delta(delta),
            "panels": int(delta.get("stream.panels", 0)),
            "solves": solves,
            "top_idx": _host(r.top_idx).tolist(),
            "top_val": _host(r.top_val).astype(np.float64).tolist(),
        }
        transitions.append(rec)
        for s in solves:
            if not s["converged"]:
                warnings.append(
                    {
                        "level": "warning",
                        "event": "solver_not_converged",
                        "transition": t,
                        "method": s["method"],
                        "iterations": s["iterations"],
                        "residual": s["residual"],
                        "tolerance": s["tolerance"],
                    }
                )

    warmup = getattr(result, "warmup_metrics", None)
    warmup_rec = None
    if warmup:
        warmup_rec = {
            "phases": _phases_from_delta(warmup),
            "bytes": _bytes_from_delta(warmup),
        }

    hits = int(c.get("program_cache.hits", 0))
    misses = int(c.get("program_cache.misses", 0))
    fetch_s = float(c.get("pipeline.producer_fetch_seconds", 0.0))
    wait_s = float(c.get("pipeline.consumer_wait_seconds", 0.0))
    # Fraction of producer fetch time hidden behind compute: 1 when the
    # consumer never blocked on the ring, 0 when it waited out every fetch.
    prefetch_eff = max(0.0, min(1.0, 1.0 - wait_s / fetch_s)) if fetch_s > 0 else None

    totals = {
        "seconds": float(sum(result.transition_seconds)),
        "phases": _phases_from_delta(c),
        "bytes": _bytes_from_delta(c),
        "panels": int(c.get("stream.panels", 0)),
        "peak_live_bytes": int(snap.gauges.get("stream.peak_live_bytes", 0)),
    }

    solver_totals = {
        "solves": int(c.get("solver.solves", 0)),
        "iterations": int(c.get("solver.iterations", 0)),
        "not_converged": int(c.get("solver.not_converged", 0)),
    }

    roofline = None
    streamed = [
        s for rec in transitions for s in rec["solves"] if s["streamed"]
    ]
    if streamed and n and k_rp:
        solve_seconds = totals["phases"]["solve"]
        roofline = streamed_solve_roofline(
            bytes_read=float(sum(s["bytes_read"] for s in streamed)),
            bytes_h2d=float(sum(s["bytes_h2d"] for s in streamed)),
            flops=float(
                sum(streamed_solve_flops(n, k_rp, s["iterations"]) for s in streamed)
            ),
            seconds=solve_seconds,
        )

    return {
        "kind": RUN_REPORT_KIND,
        "schema": RUN_REPORT_SCHEMA,
        "config": dict(config),
        "n_snapshots": int(result.n_snapshots),
        "chain_builds": int(result.chain_builds),
        "transitions": transitions,
        "warmup": warmup_rec,
        "totals": totals,
        "chain": {
            **_chain_from_delta(c),
            "drift_last": snap.gauges.get("chain.drift_last"),
            "drift_series": [float(v) for v in reg.series("chain.drift")],
        },
        "cache": {
            "hits": hits,
            "misses": misses,
            "traces": int(c.get("program_cache.traces", 0)),
            "hit_rate": hits / (hits + misses) if (hits + misses) else None,
        },
        "pipeline": {
            "producer_fetch_seconds": fetch_s,
            "consumer_wait_seconds": wait_s,
            "panels_fetched": int(c.get("pipeline.panels_fetched", 0)),
            "prefetch_efficiency": prefetch_eff,
        },
        "solver": solver_totals,
        "roofline": roofline,
        "warnings": warnings,
    }


def save_run_report(doc: Mapping[str, Any], path: str) -> None:
    """Write ``doc`` to ``path`` as JSON (atomically, via a temporary)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# structural validators (dependency-free; used by tests and the CI smoke)
# ---------------------------------------------------------------------------


def _expect(problems: list[str], cond: bool, msg: str) -> bool:
    if not cond:
        problems.append(msg)
    return cond


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_run_report(doc: Any) -> None:
    """Raise ``ValueError`` listing every structural problem in ``doc``."""
    p: list[str] = []
    if not _expect(p, isinstance(doc, dict), "run report must be a JSON object"):
        raise ValueError("; ".join(p))
    _expect(p, doc.get("kind") == RUN_REPORT_KIND,
            f"kind must be {RUN_REPORT_KIND!r}, got {doc.get('kind')!r}")
    _expect(p, isinstance(doc.get("schema"), int) and doc.get("schema", 0) >= 1,
            "schema must be an int >= 1")
    _expect(p, isinstance(doc.get("config"), dict), "config must be an object")
    _expect(p, isinstance(doc.get("n_snapshots"), int), "n_snapshots must be int")
    for key in ("totals", "cache", "pipeline", "solver"):
        _expect(p, isinstance(doc.get(key), dict), f"{key} must be an object")
    if doc.get("schema", 0) >= 2:
        ch = doc.get("chain")
        if _expect(p, isinstance(ch, dict), "chain must be an object (schema >= 2)"):
            for f_ in CHAIN_FIELDS:
                _expect(p, _is_num(ch.get(f_, None)) and ch[f_] >= 0,
                        f"chain.{f_} must be a number >= 0")
            _expect(p, ch.get("drift_last") is None or _is_num(ch["drift_last"]),
                    "chain.drift_last must be a number or null")
            _expect(p, isinstance(ch.get("drift_series"), list),
                    "chain.drift_series must be a list")
    _expect(p, isinstance(doc.get("warnings"), list), "warnings must be a list")
    trs = doc.get("transitions")
    if _expect(p, isinstance(trs, list) and len(trs) > 0,
               "transitions must be a non-empty list"):
        for i, tr in enumerate(trs):
            where = f"transitions[{i}]"
            if not _expect(p, isinstance(tr, dict), f"{where} must be an object"):
                continue
            _expect(p, tr.get("index") == i, f"{where}.index must equal {i}")
            _expect(p, tr.get("seconds") is None or _is_num(tr["seconds"]),
                    f"{where}.seconds must be a number or null")
            phases = tr.get("phases")
            if _expect(p, isinstance(phases, dict), f"{where}.phases must be an object"):
                for ph in PHASES:
                    _expect(p, _is_num(phases.get(ph, None)) and phases[ph] >= 0,
                            f"{where}.phases.{ph} must be a number >= 0")
            by = tr.get("bytes")
            if _expect(p, isinstance(by, dict), f"{where}.bytes must be an object"):
                for f_ in _BYTE_FIELDS:
                    _expect(p, isinstance(by.get(f_, None), int) and by[f_] >= 0,
                            f"{where}.bytes.{f_} must be an int >= 0")
            if doc.get("schema", 0) >= 2:
                tch = tr.get("chain")
                if _expect(p, isinstance(tch, dict),
                           f"{where}.chain must be an object (schema >= 2)"):
                    for f_ in CHAIN_FIELDS:
                        _expect(p, _is_num(tch.get(f_, None)) and tch[f_] >= 0,
                                f"{where}.chain.{f_} must be a number >= 0")
            solves = tr.get("solves")
            if _expect(p, isinstance(solves, list), f"{where}.solves must be a list"):
                for j, s in enumerate(solves):
                    sw = f"{where}.solves[{j}]"
                    if not _expect(p, isinstance(s, dict), f"{sw} must be an object"):
                        continue
                    _expect(p, isinstance(s.get("method"), str), f"{sw}.method must be str")
                    _expect(p, isinstance(s.get("iterations"), int) and s["iterations"] >= 0,
                            f"{sw}.iterations must be int >= 0")
                    _expect(p, _is_num(s.get("residual", None)),
                            f"{sw}.residual must be a number")
                    _expect(p, isinstance(s.get("converged"), bool),
                            f"{sw}.converged must be bool")
                    _expect(p, isinstance(s.get("residuals"), list),
                            f"{sw}.residuals must be a list")
    if isinstance(doc.get("totals"), dict):
        tb = doc["totals"].get("bytes")
        if _expect(p, isinstance(tb, dict), "totals.bytes must be an object"):
            for f_ in _BYTE_FIELDS:
                _expect(p, isinstance(tb.get(f_, None), int) and tb[f_] >= 0,
                        f"totals.bytes.{f_} must be an int >= 0")
    for i, w in enumerate(doc.get("warnings") or []):
        _expect(p, isinstance(w, dict) and isinstance(w.get("level"), str)
                and isinstance(w.get("event"), str),
                f"warnings[{i}] must be an object with level and event")
    if p:
        raise ValueError("invalid run report: " + "; ".join(p))


def validate_chrome_trace(doc: Any) -> None:
    """Structural check of a Chrome trace-event JSON object."""
    p: list[str] = []
    if not _expect(p, isinstance(doc, dict), "trace must be a JSON object"):
        raise ValueError("; ".join(p))
    evs = doc.get("traceEvents")
    if not _expect(p, isinstance(evs, list), "traceEvents must be a list"):
        raise ValueError("invalid chrome trace: " + "; ".join(p))
    n_complete = 0
    for i, e in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not _expect(p, isinstance(e, dict), f"{where} must be an object"):
            continue
        _expect(p, isinstance(e.get("name"), str), f"{where}.name must be str")
        ph = e.get("ph")
        _expect(p, isinstance(ph, str) and len(ph) == 1, f"{where}.ph must be a 1-char str")
        if ph == "X":
            n_complete += 1
            _expect(p, _is_num(e.get("ts", None)) and e["ts"] >= 0,
                    f"{where}.ts must be a number >= 0")
            _expect(p, _is_num(e.get("dur", None)) and e["dur"] >= 0,
                    f"{where}.dur must be a number >= 0")
            _expect(p, isinstance(e.get("pid"), int), f"{where}.pid must be int")
            _expect(p, isinstance(e.get("tid"), int), f"{where}.tid must be int")
            _expect(p, isinstance(e.get("args", {}), dict), f"{where}.args must be an object")
    _expect(p, n_complete > 0, "trace has no complete ('X') events")
    if p:
        raise ValueError("invalid chrome trace: " + "; ".join(p))


def validate_file(path: str) -> str:
    """Validate one JSON file, auto-detecting run report vs Chrome trace.

    Returns the detected kind; raises ``ValueError`` on failure.
    """
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and "traceEvents" in doc:
        validate_chrome_trace(doc)
        return "chrome_trace"
    validate_run_report(doc)
    return RUN_REPORT_KIND


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Validate run-report / Chrome-trace JSON files."
    )
    ap.add_argument("files", nargs="+", help="JSON files to validate")
    ap.add_argument("--validate", action="store_true",
                    help="(default action; flag accepted for clarity)")
    args = ap.parse_args(argv)
    rc = 0
    for path in args.files:
        try:
            kind = validate_file(path)
        except (ValueError, OSError, json.JSONDecodeError) as e:
            print(f"[obs.report] FAIL {path}: {e}", file=sys.stderr)
            rc = 1
        else:
            print(f"[obs.report] OK {path} ({kind})")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
