"""The port's metrics registry and tracer API against the JAX package's (CPU).

The same sequence of registry operations runs on a ``repro.obs`` and a
``repro_torch.obs`` registry; counters, gauges, series, deltas and names
must come out equal (they are exact float sums: no tolerance).  Also the
scoped measurement, ``reset(None)``, ``tracing_enabled`` and the module's
exported names, as ``tests/test_obs.py`` checks them in the JAX package.
"""

import sys
import threading

import pytest

from repro import obs as j_obs
from repro.obs import metrics as j_metrics
from repro.obs import trace as j_trace
from repro_torch import obs
from repro_torch.obs import metrics, trace


@pytest.fixture(autouse=True)
def _quiet_tracers():
    for t in (trace, j_trace):
        t.disable_tracing()
        t.tracer().clear()
    yield
    for t in (trace, j_trace):
        t.disable_tracing()
        t.tracer().clear()


def test_obs_exports_match_jax():
    assert obs.__all__ == j_obs.__all__
    assert all(hasattr(obs, name) for name in obs.__all__)


def _script(reg, mod, case: str):
    """One sequence of registry operations; returns everything observable."""
    reg.add(**{"x": 2.0, "y": 3.0})
    reg.add_named({"s.n": 1.0, "t.n": 4.0})
    reg.max_gauge("s.peak", 10)
    reg.max_gauge("s.peak", 4)
    reg.extend("s.res", [1.0, 2.0])
    snap = reg.snapshot()
    reg.add(x=5.0)
    reg.inc("z")
    reg.append("s.res", 3.0)
    out = {"delta": reg.delta(snap), "series_delta": reg.series_delta("s.res", snap)}
    if case == "scoped":
        with mod.scoped(reg) as sc:
            reg.inc("x", 3.0)
            reg.append("s.res", 4.0)
        reg.inc("x", 1.0)  # after the scope: delta() still reads live
        out |= {"scope_delta": sc.delta(), "scope_series": sc.series_delta("s.res")}
    elif case == "reset prefix":
        reg.reset("s.")
    elif case == "reset all":
        reg.reset(None)
        reg.reset()
    out |= {
        "names": reg.names(),
        "counters": {k: reg.value(k) for k in ("x", "y", "z", "s.n", "t.n")},
        "gauge": reg.gauge("s.peak"),
        "series": reg.series("s.res"),
        "snapshot": reg.snapshot(),
    }
    return out


@pytest.mark.parametrize("case", ["plain", "scoped", "reset prefix", "reset all"])
def test_registry_matches_jax(case):
    got = _script(metrics.MetricsRegistry(), metrics, case)
    want = _script(j_metrics.MetricsRegistry(), j_metrics, case)
    snap, j_snap = got.pop("snapshot"), want.pop("snapshot")
    assert got == want
    assert (dict(snap.counters), dict(snap.gauges), dict(snap.series_len)) == (
        dict(j_snap.counters), dict(j_snap.gauges), dict(j_snap.series_len))
    if case == "reset all":
        assert got["names"] == () and got["counters"]["t.n"] == 0.0
    if case == "reset prefix":
        assert got["names"] == ("t.n", "x", "y", "z")
    if case == "scoped":
        assert got["scope_delta"] == {"x": 4.0} and got["scope_series"] == (4.0,)


def test_scope_needs_its_with_block():
    sc = metrics.Scope(metrics.MetricsRegistry())
    with pytest.raises(RuntimeError, match="with-block"):
        sc.delta()


def test_default_registry_and_scope():
    assert metrics.registry() is metrics.REGISTRY is obs.REGISTRY
    with obs.scoped() as sc:
        with obs.phase("torch_obs_test"):
            pass
    d = sc.delta()
    assert d["phase.torch_obs_test.calls"] == 1.0
    assert d["phase.torch_obs_test.seconds"] > 0.0


def test_tracing_enabled_follows_the_tracer():
    for t in (trace, j_trace):
        assert not t.tracing_enabled()
        t.enable_tracing()
        assert t.tracing_enabled()
        t.disable_tracing()
        assert not t.tracing_enabled()
    assert obs.tracing_enabled is trace.tracing_enabled
    assert obs.Tracer is trace.Tracer
    assert obs.begin("disabled") == 0  # no span while tracing is off
    obs.end(0)
    assert obs.tracer().events() == []


def test_full_reset_races_concurrent_adds():
    """A multi-counter ``add`` is one critical section: a concurrent
    ``reset(None)`` sees both counters or neither, so they stay equal."""
    reg = metrics.MetricsRegistry()
    stop = threading.Event()
    errors = []

    def hammer_reset():
        while not stop.is_set():
            reg.reset(None)

    def hammer_add():
        try:
            for _ in range(3000):
                reg.add(a=1, b=1)
        except Exception as e:  # pragma: no cover - the regression itself
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        resetter = threading.Thread(target=hammer_reset)
        adders = [threading.Thread(target=hammer_add) for _ in range(8)]
        resetter.start()
        for t in adders:
            t.start()
        for t in adders:
            t.join(timeout=60)
        stop.set()
        resetter.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not resetter.is_alive() and not any(t.is_alive() for t in adders)
    assert errors == []
    snap = reg.snapshot()
    assert snap.counter("a") == snap.counter("b")
