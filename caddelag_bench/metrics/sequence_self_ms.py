"""``sequence_self_ms``: a fenced ``push``'s wall per transition less its four fenced phases, in ms.

The wall is ``push``'s alone, the benchmark's snapshot build left out.
What ``core/sequence.py`` does around the phases: the host top-k merge,
the registry deltas, the release of the outgoing snapshot, the launches of
the top-k sort.
"""

PHASES = ("chain", "ingest", "solve", "score")


def read(r):
    if not r.transitions or not all(r.phase_calls.get(p) for p in PHASES):
        return None
    inner = sum(r.phase_seconds[p] for p in PHASES)
    return (r.push_seconds - inner) / r.transitions * 1e3
