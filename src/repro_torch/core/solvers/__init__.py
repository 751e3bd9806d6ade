"""Iterative solvers for the chain-preconditioned Laplacian system (resident)."""

from repro_torch.core.solvers.base import (
    METHODS,
    TOLERANCE_ITER_CAP,
    SolveReport,
    SolverSpec,
    iters_from_delta,
)
from repro_torch.core.solvers.driver import RES_HIST_CAP, deflate_constant, solve
from repro_torch.core.solvers.power import estimate_rho

__all__ = [
    "METHODS",
    "RES_HIST_CAP",
    "TOLERANCE_ITER_CAP",
    "SolveReport",
    "SolverSpec",
    "deflate_constant",
    "estimate_rho",
    "iters_from_delta",
    "solve",
]
