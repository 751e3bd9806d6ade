"""Process-wide metrics registry: counters, series, atomic snapshots.

Port of :mod:`repro.obs.metrics` (the counters, gauges and series the
port's core modules record).  Counters are floats mutated under one lock;
gauges hold a current value, with :meth:`MetricsRegistry.max_gauge` for
high-water marks (``stream.peak_live_bytes``).
:meth:`MetricsRegistry.snapshot` copies the registry atomically and
:meth:`MetricsRegistry.delta` yields the counter increments since a snapshot
-- the primitive the per-transition breakdowns are cut from.  Names are
dot-scoped (``chain.builds``, ``phase.solve.seconds``); :meth:`reset` takes a
prefix so one subsystem's counters can be zeroed without touching the rest
(no prefix clears everything).  :func:`scoped` wraps a snapshot in a
:class:`Scope` whose ``delta()`` reads the increments since it was entered.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Iterable, Mapping

DEFAULT_SERIES_CAP = 4096


@dataclass(frozen=True)
class MetricsSnapshot:
    """Immutable, internally consistent copy of a registry at one instant."""

    counters: Mapping[str, float]
    gauges: Mapping[str, float]
    series_len: Mapping[str, int]

    def counter(self, name: str, default: float = 0.0) -> float:
        return self.counters.get(name, default)


class MetricsRegistry:
    """Thread-safe counters, gauges and bounded series with atomic snapshots."""

    def __init__(self, series_cap: int = DEFAULT_SERIES_CAP):
        self._lock = threading.RLock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._series: dict[str, list[float]] = {}
        self._series_cap = int(series_cap)

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def add(self, **counters: float) -> None:
        """Increment several counters in one critical section."""
        self.add_named(counters)

    def add_named(self, counters: Mapping[str, float]) -> None:
        """``add`` for names that are not Python identifiers (``phase.solve.seconds``)."""
        with self._lock:
            for name, value in counters.items():
                self._counters[name] = self._counters.get(name, 0.0) + value

    def value(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._counters.get(name, default)

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def max_gauge(self, name: str, value: float) -> None:
        """High-water-mark gauge: keep the maximum ever set."""
        with self._lock:
            cur = self._gauges.get(name)
            if cur is None or value > cur:
                self._gauges[name] = value

    def gauge(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def append(self, name: str, value: float) -> None:
        """Append one entry to a bounded series (dropped past the cap)."""
        self.extend(name, (value,))

    def extend(self, name: str, values: Iterable[float]) -> None:
        """Append to a bounded series; entries past the cap are dropped."""
        with self._lock:
            s = self._series.setdefault(name, [])
            for v in values:
                if len(s) >= self._series_cap:
                    break
                s.append(float(v))

    def series(self, name: str) -> tuple[float, ...]:
        with self._lock:
            return tuple(self._series.get(name, ()))

    def snapshot(self) -> MetricsSnapshot:
        with self._lock:
            return MetricsSnapshot(
                counters=dict(self._counters),
                gauges=dict(self._gauges),
                series_len={k: len(v) for k, v in self._series.items()},
            )

    def delta(self, since: MetricsSnapshot) -> dict[str, float]:
        """Exact counter increments since ``since`` (zero deltas omitted)."""
        with self._lock:
            out = {}
            for name, cur in self._counters.items():
                d = cur - since.counters.get(name, 0.0)
                if d:
                    out[name] = d
            return out

    def series_delta(self, name: str, since: MetricsSnapshot) -> tuple[float, ...]:
        """Series entries appended since ``since``."""
        with self._lock:
            return tuple(self._series.get(name, [])[since.series_len.get(name, 0):])

    def reset(self, prefix: str | None = None) -> None:
        """Remove every counter, gauge and series whose name starts with
        ``prefix`` (all of them when ``prefix`` is None): a snapshot after the
        reset reads as a fresh registry for that prefix."""
        with self._lock:
            for store in (self._counters, self._gauges, self._series):
                for name in [k for k in store if prefix is None or k.startswith(prefix)]:
                    del store[name]

    def names(self) -> tuple[str, ...]:
        """Every counter, gauge and series name, sorted."""
        with self._lock:
            return tuple(sorted(set(self._counters) | set(self._gauges) | set(self._series)))


@dataclass
class Scope:
    """Scoped measurement: a snapshot on entry, exact deltas on demand.

        with metrics.scoped() as sc:
            ... work ...
        solve_s = sc.delta().get("phase.solve.seconds", 0.0)
    """

    registry: MetricsRegistry
    start: MetricsSnapshot | None = field(default=None)

    def __enter__(self) -> "Scope":
        self.start = self.registry.snapshot()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None

    def _since(self) -> MetricsSnapshot:
        if self.start is None:
            raise RuntimeError("Scope used outside its with-block")
        return self.start

    def delta(self) -> dict[str, float]:
        return self.registry.delta(self._since())

    def series_delta(self, name: str) -> tuple[float, ...]:
        return self.registry.series_delta(name, self._since())


REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-default registry."""
    return REGISTRY


def scoped(reg: MetricsRegistry | None = None) -> Scope:
    """A :class:`Scope` over ``reg`` (default: the process registry)."""
    return Scope(reg or REGISTRY)
