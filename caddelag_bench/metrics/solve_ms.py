"""``solve_ms``: the fenced ``phase.solve.seconds`` per transition, in ms (core/solvers/driver.py)."""


def read(r):
    if not r.transitions or not r.phase_calls.get("solve"):
        return None
    return r.phase_seconds["solve"] / r.transitions * 1e3
