"""Richardson-preconditioned SDD solve (paper Algorithm 2, EstimateSolution).

Port of :mod:`repro.core.solver`.  Given the chain operator Z^ ~= L^+,
refine x ~ L^+ b with

    chi      = Z^ b
    y_{k+1}  = y_k - (Z^ L) y_k + chi        (q iterations)

for all k right-hand sides at once.  ``estimate_solution`` maps this fixed-q
call onto the unified driver (:func:`repro_torch.core.solvers.solve`), which
owns the resident and streamed branches; callers that want a tolerance, the
Chebyshev or CG methods, or the :class:`~repro_torch.core.solvers.SolveReport`
call the driver with a :class:`~repro_torch.core.solvers.SolverSpec`.
"""

from __future__ import annotations

import torch

from repro_torch.core.chain import ChainOperator
from repro_torch.core.distmatrix import matmul_rowblock
from repro_torch.core.solvers import SolverSpec, deflate_constant, solve

__all__ = ["deflate_constant", "estimate_solution", "residual_norm"]


def estimate_solution(
    op: ChainOperator,
    b: torch.Tensor,
    q_iters: int,
    *,
    deflate: bool = True,
    solver_batch: int = 1,
    prefetch_depth: int | None = None,
) -> torch.Tensor:
    """x* ~= L^+ b for each column of the (n, k) ``b``: ``y0 = chi``, then
    ``q_iters - 1`` Richardson steps.

    A store-backed operator streams its panels onto ``b``'s device
    (``prefetch_depth`` staged ahead, default the operator's).
    ``solver_batch=B`` reads P2 from the scratch store once per B steps and
    replays the decoded panels from host RAM for the others, so the scratch
    reads drop about B-fold and the solution stays bitwise the same.
    """
    if q_iters < 1:
        raise ValueError("q must be >= 1")
    if solver_batch < 1:
        raise ValueError("solver_batch must be >= 1")
    y, _ = solve(op, b, SolverSpec(method="richardson"), fixed_q=q_iters, deflate=deflate,
                 solver_batch=solver_batch, prefetch_depth=prefetch_depth)
    return y


def residual_norm(
    l_mat, x: torch.Tensor, b: torch.Tensor, *, prefetch_depth: int | None = None
) -> torch.Tensor:
    """||L x - b||_F / ||b||_F, the solver's acceptance metric (a 0-d tensor).

    ``l_mat`` is a resident Laplacian or a store-backed snapshot handle; the
    product goes through :func:`matmul_rowblock`, which streams a handle's
    row panels onto ``x``'s device.
    """
    r = matmul_rowblock(l_mat, x, prefetch_depth=prefetch_depth) - b
    num = torch.sqrt(torch.sum(r.to(torch.float32) ** 2))
    den = torch.sqrt(torch.sum(b.to(torch.float32) ** 2))
    return num / torch.clamp(den, min=1e-30)
