"""Straggler watchdog and failure injection for the restart loop.

Port of :mod:`repro.training.watchdog`.  The watchdog keeps an EMA of step
time and flags steps slower than ``factor`` x EMA; the training driver logs
offenders.  ``FailureInjector`` raises at a chosen step, once, so a test can
show that checkpoint and restart reproduce the uninterrupted run.

``StepTimer(device)`` on a CUDA device synchronizes the card before it
reads the clock, at both ends: PyTorch returns before the card finishes, so
without it the timer measures the launches, not the step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class StragglerWatchdog:
    factor: float = 2.5
    decay: float = 0.9
    warmup_steps: int = 3
    ema: float | None = None
    flags: list = field(default_factory=list)
    _seen: int = 0

    def observe(self, step: int, dt: float) -> bool:
        """Record one step time; returns True if this step is a straggler."""
        self._seen += 1
        if self._seen <= self.warmup_steps:
            # warmup: seed the EMA, never flag (first steps include one-time work)
            self.ema = dt if self.ema is None else self.decay * self.ema + (1 - self.decay) * dt
            return False
        is_slow = self.ema is not None and dt > self.factor * self.ema
        if is_slow:
            self.flags.append((step, dt, self.ema))
        else:
            self.ema = self.decay * self.ema + (1 - self.decay) * dt
        return is_slow


class StepTimer:
    """``with StepTimer(device) as t: ...`` -> ``t.dt`` seconds of host clock."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.dt = time.perf_counter() - self.t0
        return False


class InjectedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Raises InjectedFailure when training reaches ``fail_at_step`` (once)."""

    fail_at_step: int | None = None
    fired: bool = False

    def check(self, step: int) -> None:
        if self.fail_at_step is not None and step == self.fail_at_step and not self.fired:
            self.fired = True
            raise InjectedFailure(f"injected node failure at step {step}")
