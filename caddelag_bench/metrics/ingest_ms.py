"""``ingest_ms``: the fenced ``phase.ingest.seconds`` per transition, in ms (the edge projection)."""


def read(r):
    if not r.transitions or not r.phase_calls.get("ingest"):
        return None
    return r.phase_seconds["ingest"] / r.transitions * 1e3
