"""Solve driver for a resident chain operator: richardson, chebyshev, cg.

Port of the resident branch of :mod:`repro.core.solvers.driver`.  JAX's
``lax.while_loop`` becomes a Python loop with the same
``k < max_steps and res > tol`` condition; the residual comes to the host
once per step (one small sync), and the scalar recurrences (Chebyshev
weights, the Manteuffel interval adaptation) run in numpy float32 so they
round like the JAX program's float32 scalars and the iteration counts match.

All methods stop on the relative preconditioned residual
``||Z^(b - L y)||_F / ||Z^ b||_F`` measured on the deflated subspace; the
denominator stays ``||Z^ b||`` under a warm start.  See the JAX module for
the derivation of each method.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.distmatrix import matmul_rowblock
from repro_torch.core.solvers.base import SolveReport, SolverSpec
from repro_torch.obs import REGISTRY, trace

RHO_MAX = 0.999
# Manteuffel-style interval adaptation (chebyshev): the geometric-mean
# contraction since the last (re)start is compared with the predicted rate
# after RHO_ADAPT_MIN_STEPS steps; a miss by more than RHO_ADAPT_SLACK grows
# the interval and restarts, unless the residual is near the fp32 floor.
RHO_ADAPT_SLACK = 1.2
RHO_ADAPT_MIN_STEPS = 4
RHO_ADAPT_RES_FLOOR = 1e-5
# Residual-history ring, as carried through the JAX while_loop.
RES_HIST_CAP = 512

_F32 = np.float32


def deflate_constant(y: torch.Tensor) -> torch.Tensor:
    """Remove the all-ones (Laplacian nullspace) component from each column."""
    yf = y.to(torch.float32)
    return (yf - yf.mean(dim=0, keepdim=True)).to(y.dtype)


def _frob(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x.to(torch.float32) ** 2))


def _cheb_weight(kr: int, p_prev, sigma2):
    """p_{k+1} of the Chebyshev three-term recurrence (kr: steps since restart)."""
    if kr == 0:
        return _F32(1.0)
    if kr == 1:
        return _F32(1.0 / (1.0 - 0.5 * sigma2))
    return _F32(1.0 / (1.0 - 0.25 * sigma2 * p_prev))


def _cheb_rate(sigma2):
    """Predicted asymptotic per-step contraction: sigma / (1 + sqrt(1 - sigma^2))."""
    return _F32(np.sqrt(sigma2) / (1.0 + np.sqrt(max(1.0 - sigma2, _F32(0.0)))))


def _rho_from_rate(c):
    """The interval bound whose predicted contraction equals ``c``."""
    sigma = _F32(2.0 * c / (1.0 + c * c))
    return _F32(2.0 * sigma / (1.0 + sigma))


def _unrotate_hist(hist: np.ndarray, iters: int) -> list[float]:
    """Chronological residual series from the ring buffer (step k at k mod cap)."""
    cap = hist.shape[0]
    if iters <= cap:
        out = hist[:iters]
    else:
        s = iters % cap
        out = np.concatenate([hist[s:], hist[:s]])
    return [float(r) for r in out]


def _metric_deflate(delta: torch.Tensor, deflate: bool) -> torch.Tensor:
    # The nullspace component of the residual never decays: measure without it.
    if deflate:
        delta = delta - delta.to(torch.float32).mean(dim=0, keepdim=True)
    return delta


def _run_stationary(p2, chi, y0, method, deflate, tol, max_steps, rho):
    """Richardson / Chebyshev; returns (y, iterations, residual, ring, rho_final)."""
    den = torch.clamp(_frob(chi), min=1e-30)
    hist = np.zeros((RES_HIST_CAP,), np.float32)
    y, y_prev = y0, y0
    k, kr = 0, 0
    res_anchor, p_prev, rho_c, res = _F32(np.inf), _F32(1.0), _F32(rho), _F32(np.inf)
    tol = _F32(tol)
    while k < max_steps and res > tol:
        gamma = _F32(2.0 / (2.0 - rho_c))
        sigma2 = _F32((rho_c / (2.0 - rho_c)) ** 2)
        gy = y - matmul_rowblock(p2, y) + chi  # G y + chi; gy - y is the residual
        if method == "richardson":
            y_new, p_new = gy, p_prev
        else:
            p_new = _cheb_weight(kr, p_prev, sigma2)
            y_new = (float(p_new) * (float(gamma) * gy + float(1.0 - gamma) * y)
                     + float(1.0 - p_new) * y_prev).to(chi.dtype)
        if deflate:
            y_new = deflate_constant(y_new)
        res = _F32((_frob(_metric_deflate(gy - y, deflate)) / den).item())
        hist[k % RES_HIST_CAP] = res
        if kr == 0:
            res_anchor = res  # the contraction anchor: residual at the last (re)start
        kr_new = kr + 1
        if method == "chebyshev":
            c_avg = _F32(np.power(res / max(res_anchor, _F32(1e-30)),
                                  _F32(1.0) / _F32(max(kr, 1))))
            pred = _cheb_rate(sigma2)
            miss = (kr >= RHO_ADAPT_MIN_STEPS
                    and c_avg > min(_F32(pred * RHO_ADAPT_SLACK), _F32(0.999))
                    and res > _F32(RHO_ADAPT_RES_FLOOR))
            implied = _rho_from_rate(min(c_avg, _F32(0.9995)))
            gap_half = _F32(1.0 - 0.5 * (1.0 - rho_c))
            rho_new = min(min(implied, gap_half), _F32(RHO_MAX))
            if miss and rho_new > rho_c:
                rho_c = rho_new
                kr_new = 0  # restart: p_1 = 1 drops the y_prev term
        y_prev, y = y, y_new
        p_prev = p_new
        k += 1
        kr = kr_new
    return y, k, float(res), hist, float(rho_c)


def _run_cg(p2, chi, y0, w, deflate, tol, max_steps):
    """CG on the deflated SPD form with degree-weighted inner products."""
    den = torch.clamp(_frob(chi), min=1e-30)
    wcol = torch.clamp(w.to(torch.float32), min=0.0).reshape(-1, 1)
    wsum = torch.clamp(torch.sum(wcol), min=1e-30)

    def wdot(u, v):
        return torch.sum(wcol * u * v, dim=0, keepdim=True)

    def dproj(x):
        # project onto range(P2): remove the deg-weighted mean
        return x - torch.sum(wcol * x, dim=0, keepdim=True) / wsum

    r = chi.to(torch.float32) - matmul_rowblock(p2, y0.to(torch.float32)).to(torch.float32)
    if deflate:
        r = dproj(r)
    y, p, rz = y0, r, wdot(r, r)
    hist = np.zeros((RES_HIST_CAP,), np.float32)
    k, res, tol = 0, _F32(np.inf), _F32(tol)
    while k < max_steps and res > tol:
        q = matmul_rowblock(p2, p)
        if deflate:
            q = dproj(q)
        pq = wdot(p, q)
        alpha = torch.where(pq > 0, rz / torch.clamp(pq, min=1e-30), 0.0)
        y = (y.to(torch.float32) + alpha * p).to(chi.dtype)
        if deflate:
            y = deflate_constant(y)
        r = r - alpha * q
        if deflate:
            r = dproj(r)
        rz_new = wdot(r, r)
        beta = torch.where(rz > 0, rz_new / torch.clamp(rz, min=1e-30), 0.0)
        p = r + beta * p
        rz = rz_new
        res = _F32((_frob(_metric_deflate(r, deflate)) / den).item())
        hist[k % RES_HIST_CAP] = res
        k += 1
    return y, k, float(res), hist


def solve(
    op,
    b: torch.Tensor,
    spec: SolverSpec | None = None,
    *,
    fixed_q: int | None = None,
    deflate: bool = True,
    y0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, SolveReport]:
    """x* ~= L^+ b for each column of the (n, k) ``b``; returns (solution, report).

    ``op`` is a chain operator (``p1``, ``p2``, ``deg``, ``rho``).  With no
    tolerance, cap or delta on the spec the driver runs exactly ``fixed_q - 1``
    refinement steps.  ``y0`` warm-starts the iteration (deflated on entry)
    instead of the cold ``y0 = chi = Z^ b``.
    """
    spec = spec or SolverSpec()
    max_steps = spec.max_steps(fixed_q)
    tol = 0.0 if spec.tolerance is None else float(spec.tolerance)

    rho = None
    if spec.method == "chebyshev":
        if op.rho is None:
            from repro_torch.core.solvers.power import estimate_rho

            op.rho = estimate_rho(op.p2)  # cached: later solves on this operator reuse it
        rho = min(RHO_MAX, max(0.0, float(op.rho)))

    warm = y0 is not None
    with trace.span("solve", method=spec.method, warm=warm) as sp:
        chi = matmul_rowblock(op.p1, b)
        if deflate:
            chi = deflate_constant(chi)
        if warm:
            if tuple(y0.shape) != tuple(chi.shape):
                raise ValueError(
                    f"warm start y0 shape {tuple(y0.shape)} does not match "
                    f"the solution shape {tuple(chi.shape)}"
                )
            y_start = y0.to(chi.dtype)
            if deflate:
                y_start = deflate_constant(y_start)
        else:
            y_start = chi  # cold start: y0 = chi = Z^ b

        rho_final = rho
        if spec.method == "cg":
            y, iters, res, hist = _run_cg(op.p2, chi, y_start, op.deg, deflate, tol, max_steps)
        else:
            y, iters, res, hist, rho_c = _run_stationary(
                op.p2, chi, y_start, spec.method, deflate, tol, max_steps, rho or 0.0
            )
            if spec.method == "chebyshev":
                rho_final = rho_c
        res_hist = _unrotate_hist(hist, iters)
        if iters == 0:
            res = float("nan")  # the loop never ran: no residual was measured
        sp.annotate(iterations=iters, residual=res)
        sp.fence(y)

    report = SolveReport(
        method=spec.method,
        iterations=iters,
        residual=res,
        converged=(not math.isnan(res)) and (spec.tolerance is None or res <= spec.tolerance),
        tolerance=spec.tolerance,
        max_iters=max_steps,
        rho=rho,
        residuals=tuple(res_hist),
        rho_final=rho_final,
        warm_start=warm,
    )
    REGISTRY.add_named({
        "solver.solves": 1.0,
        "solver.iterations": float(iters),
        "solver.not_converged": 0.0 if report.converged else 1.0,
        "solver.warm_starts": 1.0 if warm else 0.0,
    })
    REGISTRY.extend("solver.residuals", res_hist)
    return y, report
