"""Solve driver for a chain operator: richardson, chebyshev, cg.

Port of :mod:`repro.core.solvers.driver`.  Resident operators: JAX's
``lax.while_loop`` becomes a Python loop with the same
``k < max_steps and res > tol`` condition; the residual comes to the host
once per step (one small sync), and the scalar recurrences (Chebyshev
weights, the Manteuffel interval adaptation) run in numpy float32 so they
round like the JAX program's float32 scalars and the iteration counts match.

Store-backed operators (an out-of-core chain) take the streamed branch
(:func:`_solve_streamed`): every P2 mat-vec is a pass over the panel stream.
With the kernel path (``use_gemm_kernel``) the chi build is one
``stream_gemm`` pass over P1, each richardson / chebyshev iteration is one
``fused_panel_matvec`` pass over P2, and CG's direction product is a
``stream_gemm`` pass.  Every streamed iteration measures its residual from
``gy - y`` (the JAX kernel path reduces it from the kernel's fp32 moments,
which cancel near convergence; see :func:`_kernel_stream_pass`).  ``solver_batch`` > 1 replays
P2's panels from host RAM between store reads (``CachingHandle.refresh`` at
every batch boundary).

An operator corrected by an incremental delta update
(:mod:`repro_torch.core.delta_chain`) carries ``p1_scale, u1, v1, u2, v2``:
the chi build becomes ``s * (P1 (s * b)) + u1 (v1^T b)`` and every P2
product gains ``u2 (v2^T x)``, plain (n, r) products beside the unchanged
base pass, on every route (on the fused one, ``gy' = gy - u2 (v2^T y)``).

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
from repro_torch.core.tiles import is_streamable, stream_stats
from repro_torch.kernels import stream_gemm as _sg
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


def _low_rank(u: torch.Tensor, v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """u (v^T x) in fp32: a rank-r correction term, never an n^2 product."""
    return u @ (v.T @ x.to(torch.float32))


def _p2_matvec(p2, y: torch.Tensor, u2, v2) -> torch.Tensor:
    """P2' y = P2 y (+ u2 (v2^T y) on a corrected operator)."""
    out = matmul_rowblock(p2, y)
    if u2 is not None:
        out = (out.to(torch.float32) + _low_rank(u2, v2, y)).to(y.dtype)
    return out


def _metric_deflate(delta: torch.Tensor, deflate: bool) -> torch.Tensor:
    # The nullspace component of the residual never decays: measure without it.
    if deflate:
        delta = delta - delta.to(torch.float32).mean(dim=0, keepdim=True)
    return delta


def _run_stationary(p2, chi, y0, method, deflate, tol, max_steps, rho, u2=None, v2=None):
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
        gy = y - _p2_matvec(p2, y, u2, v2) + chi  # G y + chi; gy - y is the residual
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


def _run_cg(p2, chi, y0, w, deflate, tol, max_steps, u2=None, v2=None):
    """CG on the deflated SPD form with degree-weighted inner products."""
    den = torch.clamp(_frob(chi), min=1e-30)
    wcol = torch.clamp(w.to(torch.float32), min=0.0).reshape(-1, 1)
    wsum = torch.clamp(torch.sum(wcol), min=1e-30)

    def wdot(u, v):
        return torch.sum(wcol * u * v, dim=0, keepdim=True)

    def dproj(x):
        # project onto range(P2): remove the deg-weighted mean
        return x - torch.sum(wcol * x, dim=0, keepdim=True) / wsum

    r = chi.to(torch.float32) - _p2_matvec(p2, y0.to(torch.float32), u2, v2).to(torch.float32)
    if deflate:
        r = dproj(r)
    y, p, rz = y0, r, wdot(r, r)
    hist = np.zeros((RES_HIST_CAP,), np.float32)
    k, res, tol = 0, _F32(np.inf), _F32(tol)
    while k < max_steps and res > tol:
        q = _p2_matvec(p2, p, u2, v2)
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


def _kernel_stream_pass(handle, y, chi, *, depth, fused):
    """One pass over a store-backed operator through the CUDA kernels.

    Panels stream in stored form (bf16 scratch ships uint16 bits, half the
    H2D bytes).  ``fused=True`` returns ``gy = chi + y - P2 y`` for one
    whole solve iteration, so the iteration costs exactly this one pass.
    ``fused=False`` returns the plain mat-vec (the chi build / the CG
    direction product).

    The kernel's column sums and sum of squares of ``delta = chi - P2 y``
    are not read: the residual ``ss - |cs|^2 / n`` they give cancels to
    noise (even <= 0) once the residual falls far below delta's never-decaying
    column mean, which ended fixed-q solves early.  The caller measures the
    residual from ``gy - y``, an (n, q) device op at the same cost.
    """
    from repro_torch.store import PanelPipeline  # the store is optional

    n = int(handle.shape[0])
    ph = int(handle.panel_rows)
    if n % ph:
        raise ValueError(f"panel height {ph} does not tile n={n}")
    st = stream_stats()
    st.add(calls=1)
    y32 = y.to(torch.float32).contiguous()
    chi32 = chi.to(torch.float32).contiguous() if fused else None
    parts = []
    with PanelPipeline([handle], range(0, n, ph), ph, depth=depth, device=y.device,
                       stats=st, encoded=True) as pipe:
        for r0, (panel,) in pipe:
            if fused:
                gy_p, _, _ = _sg.fused_panel_matvec(
                    panel, y32, chi32[r0 : r0 + ph], y32[r0 : r0 + ph])
            else:
                gy_p = _sg.stream_gemm(panel, y32)
            st._note_live(pipe.device_live_bytes + gy_p.numel() * 4)
            parts.append(gy_p)
    return torch.cat(parts, dim=0)


def _solve_streamed(p2_handle, chi, y0, method, deflate, tol, max_steps, rho,
                    solver_batch, prefetch_depth, use_kernel=False, w=None, u2=None, v2=None):
    """The streamed solve: a host loop with one pass over P2 per mat-vec (plus
    the rank-r correction ``u2 (v2^T x)``, which never touches the stream)."""
    p2, cached = p2_handle, None
    if solver_batch > 1:
        from repro_torch.store import CachingHandle  # the store is optional

        p2 = cached = CachingHandle(p2_handle)
    den = max(float(_frob(chi)), 1e-30)
    passes = 0

    def next_pass():
        nonlocal passes
        if cached is not None and passes and passes % solver_batch == 0:
            cached.refresh()  # batch boundary: the next pass re-streams the store
        passes += 1

    def stream_matvec(x):
        next_pass()
        if use_kernel:
            mv = _kernel_stream_pass(p2, x, None, depth=prefetch_depth, fused=False)
        else:
            mv = matmul_rowblock(p2, x.to(torch.float32), prefetch_depth=prefetch_depth)
        if u2 is not None:
            mv = mv + _low_rank(u2, v2, x)
        return mv

    def metric(delta):
        if deflate:
            delta = delta - delta.to(torch.float32).mean(dim=0, keepdim=True)
        return float(_frob(delta)) / den

    res_hist: list[float] = []

    if method == "cg":
        wcol = torch.clamp(w.to(torch.float32).reshape(-1, 1), min=0.0)
        wsum = max(float(torch.sum(wcol)), 1e-30)

        def wdot(u, v):
            return torch.sum(wcol * u * v, dim=0, keepdim=True)

        def dproj(x):
            return x - torch.sum(wcol * x, dim=0, keepdim=True) / wsum

        y = y0
        r = chi.to(torch.float32) - stream_matvec(y0.to(torch.float32))
        if deflate:
            r = dproj(r)
        p_dir = r
        rz = wdot(r, r)
        k, res = 0, math.inf
        while k < max_steps and res > tol:
            q = stream_matvec(p_dir)
            if deflate:
                q = dproj(q)
            pq = wdot(p_dir, q)
            alpha = torch.where(pq > 0, rz / torch.clamp(pq, min=1e-30), 0.0)
            y = (y.to(torch.float32) + alpha * p_dir).to(chi.dtype)
            if deflate:
                y = deflate_constant(y)
            r = r - alpha * q
            if deflate:
                r = dproj(r)
            rz_new = wdot(r, r)
            beta = torch.where(rz > 0, rz_new / torch.clamp(rz, min=1e-30), 0.0)
            p_dir = r + beta * p_dir
            rz = rz_new
            res = metric(r)
            k += 1
            res_hist.append(res)
        return y, k, res, res_hist, None

    rho_c = float(rho)
    gamma = 2.0 / (2.0 - rho_c)
    sigma2 = (rho_c / (2.0 - rho_c)) ** 2

    y, y_prev, p_prev = y0, y0, 1.0
    k, kr, res, res_anchor = 0, 0, math.inf, math.inf
    while k < max_steps and res > tol:
        if use_kernel:  # one fused pass over the P2 stream
            next_pass()
            gy = _kernel_stream_pass(p2, y, chi, depth=prefetch_depth, fused=True)
            if u2 is not None:
                # the fused pass applied the base P2: fold in the rank-r term;
                # the residual below is still measured from gy' - y
                gy = gy - _low_rank(u2, v2, y)
            gy = gy.to(chi.dtype)
        else:
            gy = y - stream_matvec(y).to(chi.dtype) + chi
        if method == "richardson":
            y_new = gy
        else:
            p_new = float(_cheb_weight(kr, p_prev, _F32(sigma2)))
            y_new = (p_new * (gamma * gy + (1.0 - gamma) * y)
                     + (1.0 - p_new) * y_prev).to(chi.dtype)
            p_prev = p_new
        if deflate:
            y_new = deflate_constant(y_new)
        res = metric(gy - y)
        if kr == 0:
            res_anchor = res  # contraction anchor: residual at the (re)start
        kr += 1
        if method == "chebyshev" and kr - 1 >= RHO_ADAPT_MIN_STEPS and res > RHO_ADAPT_RES_FLOOR:
            pred = float(_cheb_rate(_F32(sigma2)))
            c_avg = (res / max(res_anchor, 1e-30)) ** (1.0 / max(kr - 1, 1))
            if c_avg > min(pred * RHO_ADAPT_SLACK, 0.999):
                c = min(c_avg, 0.9995)
                sigma = 2.0 * c / (1.0 + c * c)
                rho_new = min(2.0 * sigma / (1.0 + sigma), 1.0 - 0.5 * (1.0 - rho_c), RHO_MAX)
                if rho_new > rho_c:
                    rho_c = rho_new
                    gamma = 2.0 / (2.0 - rho_c)
                    sigma2 = (rho_c / (2.0 - rho_c)) ** 2
                    kr = 0  # restart: the next step uses p_1 = 1
        y_prev, y = y, y_new
        k += 1
        res_hist.append(float(res))
    return y, k, res, res_hist, rho_c


def solve(
    op,
    b: torch.Tensor,
    spec: SolverSpec | None = None,
    *,
    fixed_q: int | None = None,
    deflate: bool = True,
    solver_batch: int = 1,
    prefetch_depth: int | None = None,
    use_gemm_kernel: bool | None = None,
    y0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, SolveReport]:
    """x* ~= L^+ b for each column of the (n, k) ``b``; returns (solution, report).

    ``op`` is a chain operator (``p1``, ``p2``, ``deg``, ``rho``); store-backed
    P1 / P2 stream onto ``b``'s device.  With no tolerance, cap or delta on
    the spec the solve runs exactly ``fixed_q - 1`` refinement steps.  ``y0``
    warm-starts the iteration (deflated on entry) instead of the cold
    ``y0 = chi = Z^ b``.  ``solver_batch`` / ``prefetch_depth`` are the
    streamed path's I/O knobs; ``use_gemm_kernel`` (None: the operator's
    flag) routes the streamed passes through the CUDA kernels.
    """
    spec = spec or SolverSpec()
    if solver_batch < 1:
        raise ValueError("solver_batch must be >= 1")
    depth = prefetch_depth if prefetch_depth is not None else op.prefetch_depth
    max_steps = spec.max_steps(fixed_q)
    tol = 0.0 if spec.tolerance is None else float(spec.tolerance)

    rho = None
    if spec.method == "chebyshev":
        if op.rho is None:
            from repro_torch.core.solvers.power import estimate_rho

            # cached: later solves on this operator reuse it
            op.rho = estimate_rho(op.p2, device=b.device, prefetch_depth=depth)
        rho = min(RHO_MAX, max(0.0, float(op.rho)))

    streamed = is_streamable(op.p1) or is_streamable(op.p2)
    use_k = bool(op.use_gemm_kernel if use_gemm_kernel is None else use_gemm_kernel)
    st = stream_stats()
    read0, panels0, h2d0 = st.bytes_read, st.panels, st.bytes_h2d
    warm = y0 is not None
    with trace.span("solve", method=spec.method, streamed=streamed, warm=warm) as sp:
        b_in = b
        if op.p1_scale is not None:  # corrected: P1' b = s (P1 (s b)) + u1 (v1^T b)
            scale_col = op.p1_scale.to(torch.float32).reshape(-1, 1)
            b_in = (b.to(torch.float32) * scale_col).to(b.dtype)
        if use_k and is_streamable(op.p1):
            chi = _kernel_stream_pass(op.p1, b_in, None, depth=depth, fused=False).to(b.dtype)
        else:
            chi = matmul_rowblock(op.p1, b_in, prefetch_depth=depth)
        if op.p1_scale is not None:
            chi = (chi.to(torch.float32) * scale_col + _low_rank(op.u1, op.v1, b)).to(b.dtype)
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
        if streamed:
            y, iters, res, res_hist, rho_c = _solve_streamed(
                op.p2, chi, y_start, spec.method, deflate, tol, max_steps, rho or 0.0,
                solver_batch, depth, use_kernel=use_k and is_streamable(op.p2), w=op.deg,
                u2=op.u2, v2=op.v2,
            )
            if spec.method == "chebyshev":
                rho_final = rho_c
        elif spec.method == "cg":
            y, iters, res, hist = _run_cg(op.p2, chi, y_start, op.deg, deflate, tol, max_steps,
                                          op.u2, op.v2)
            res_hist = _unrotate_hist(hist, iters)
        else:
            y, iters, res, hist, rho_c = _run_stationary(
                op.p2, chi, y_start, spec.method, deflate, tol, max_steps, rho or 0.0,
                op.u2, op.v2,
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
        streamed=streamed,
        bytes_read=st.bytes_read - read0,
        panels=st.panels - panels0,
        bytes_h2d=st.bytes_h2d - h2d0,
    )
    REGISTRY.add_named({
        "solver.solves": 1.0,
        "solver.iterations": float(iters),
        "solver.not_converged": 0.0 if report.converged else 1.0,
        "solver.warm_starts": 1.0 if warm else 0.0,
    })
    REGISTRY.extend("solver.residuals", res_hist)
    return y, report
