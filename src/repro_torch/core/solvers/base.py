"""Solver contract: :class:`SolverSpec` (what to run) / :class:`SolveReport` (what happened).

Port of :mod:`repro.core.solvers.base`.  ``tolerance`` stops on the relative
preconditioned residual ``||Z^(b - L y)|| / ||Z^ b||``; ``max_iters`` caps
refinement steps (one P2 mat-vec each); ``delta`` derives the paper's cap
``q = ceil(log 1/delta)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

METHODS = ("richardson", "chebyshev", "cg")

# Paper default: delta = 1e-4 gives q = ceil(ln 1e4) = 10.
DEFAULT_DELTA = 1e-4

# Safety cap when only a tolerance is given.
TOLERANCE_ITER_CAP = 300


def iters_from_delta(delta: float) -> int:
    """The paper's iteration count q = ceil(log 1/delta)."""
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    return max(1, math.ceil(math.log(1.0 / delta)))


@dataclass(frozen=True)
class SolverSpec:
    """Which iterative method to run, and when to stop.

    Step-bound precedence: explicit ``max_iters`` > ``delta``-derived
    ``q(delta) - 1`` > ``TOLERANCE_ITER_CAP`` (tolerance-only specs) > the
    caller's fixed q.
    """

    method: str = "richardson"
    tolerance: float | None = None
    max_iters: int | None = None
    delta: float | None = None

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown solver {self.method!r}; want one of {METHODS}")
        if self.tolerance is not None and self.tolerance <= 0:
            raise ValueError(f"tolerance must be > 0, got {self.tolerance}")
        if self.max_iters is not None and self.max_iters < 0:
            raise ValueError(f"max_iters must be >= 0, got {self.max_iters}")
        if self.delta is not None and not 0.0 < self.delta < 1.0:
            raise ValueError(f"delta must be in (0, 1), got {self.delta}")

    def max_steps(self, fixed_q: int | None = None) -> int:
        """Resolved refinement-step bound for this spec."""
        if self.max_iters is not None:
            return self.max_iters
        if self.delta is not None:
            return max(1, iters_from_delta(self.delta) - 1)
        if self.tolerance is not None:
            return TOLERANCE_ITER_CAP
        if fixed_q is not None:
            if fixed_q < 1:
                raise ValueError("q must be >= 1")
            return fixed_q - 1
        return max(1, iters_from_delta(DEFAULT_DELTA) - 1)


@dataclass
class SolveReport:
    """Telemetry from one solve (one batch of k_RP right-hand sides)."""

    method: str
    iterations: int  # refinement steps taken (P2 mat-vecs)
    residual: float  # NaN when no residual was measured (zero iterations)
    converged: bool
    tolerance: float | None
    max_iters: int
    rho: float | None = None  # Chebyshev interval bound the run started from
    residuals: tuple = ()  # per-iteration residual series
    rho_final: float | None = None  # Chebyshev interval after adaptation
    warm_start: bool = False
    streamed: bool = False  # P1 / P2 were store-backed (out-of-core solve)
    bytes_read: int = 0  # scratch bytes served during the solve
    panels: int = 0  # panels staged during the solve
    bytes_h2d: int = 0  # host-to-device bytes staged during the solve
