"""``chain_roofline_share``: the chain's 2(d-1)+1 products of 2 n^3 at the TF32 peak, over the
fenced chain time per transition, in % (on the card only)."""

from caddelag_bench import yardstick


def read(r):
    if not r.on_card or not r.transitions or not r.phase_calls.get("chain"):
        return None
    seconds = r.phase_seconds["chain"] / r.transitions
    if seconds <= 0:
        return None
    return 100.0 * yardstick.chain_flops(r.n, r.d) / yardstick.TF32_FLOPS / seconds
