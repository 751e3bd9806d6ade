"""``chain_ms``: the fenced ``phase.chain.seconds`` per transition, in ms (core/chain.py)."""


def read(r):
    if not r.transitions or not r.phase_calls.get("chain"):
        return None
    return r.phase_seconds["chain"] / r.transitions * 1e3
