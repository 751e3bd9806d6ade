"""``score_ms``: the fenced ``phase.score.seconds`` per transition, in ms (core/cad.py)."""


def read(r):
    if not r.transitions or not r.phase_calls.get("score"):
        return None
    return r.phase_seconds["score"] / r.transitions * 1e3
