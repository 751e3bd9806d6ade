"""Paper section 5.2 on the PyTorch/CUDA port: donation-shift anomalies.

The FEC donor data is not shipped; this synthesizes the paper's setting over
a sequence of election phases: donors give to parties phase after phase, and
the graph connects donors who support the same party with weight
log(1 + min(donation)) (the paper's second setting).  In each phase a fresh
small block of donors shifts support.  The sequence engine embeds each
phase's graph once and scores every consecutive pair; it should rank the
shifting donors highest, which an analysis of the amounts alone (they
barely change) cannot.

    PYTHONPATH=src python examples/torch_election_anomaly.py [--n 192 --t-steps 3]
        [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import CommuteConfig, SequenceDetector, build_from_nodes
from repro_torch.device import resolve_device


def donation_graph(party, amount, *, log_scale=True, device="cuda"):
    """A[i, j] = min(a_i, a_j) (log-scaled) if i and j back the same party, else 0."""
    feats = torch.from_numpy(np.stack([party.astype(np.float32), amount.astype(np.float32)], 1))

    def kern(xi, xj):
        same = (xi[:, None, 0] == xj[None, :, 0]).to(torch.float32)
        m = torch.minimum(xi[:, None, 1], xj[None, :, 1])
        return same * (torch.log1p(m) if log_scale else m)

    return build_from_nodes(feats.to(resolve_device(device)), kern)


def donation_phases(n, t_steps, shift_frac, seed=0):
    """Per-phase (party, amount) plus the set of donors who shifted each phase."""
    rng = np.random.default_rng(seed)
    party = rng.integers(0, 3, n)  # D / R / other
    amount = np.exp(rng.normal(5, 1.5, n))  # log-normal donations
    phases = [(party.copy(), amount.copy())]
    shifters_per_phase = []
    n_shift = max(1, int(shift_frac * n))
    for _ in range(1, t_steps):
        shifters = rng.choice(n, n_shift, replace=False)
        party = party.copy()
        party[shifters] = (party[shifters] + 1 + rng.integers(0, 2, n_shift)) % 3
        amount = amount * np.exp(rng.normal(0, 0.1, n))
        phases.append((party, amount))
        shifters_per_phase.append(set(shifters.tolist()))
    return phases, shifters_per_phase, n_shift


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=192)
    ap.add_argument("--t-steps", type=int, default=3)
    ap.add_argument("--shift-frac", type=float, default=0.08)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)

    phases, shifters_per_phase, n_shift = donation_phases(args.n, args.t_steps, args.shift_frac)
    cfg = CommuteConfig(eps_rp=1e-3, d=8, q=10, schedule="xla")
    det = SequenceDetector(cfg, top_k=n_shift, device=args.device)
    res = det.run(donation_graph(p, a, device=args.device) for p, a in phases)

    print(f"{args.n} donors, {args.t_steps} phases, {n_shift} shift per phase; "
          f"{res.chain_builds} graph embeddings for {len(res.transitions)} transitions")
    for t, r in enumerate(res.transitions):
        found = set(r.top_idx.tolist())
        truth = shifters_per_phase[t]
        print(f"phase {t}->{t + 1}: CADDeLaG top-{n_shift} recovers "
              f"{len(found & truth)}/{n_shift} shifters")
        # the tuple-level baseline the paper calls out: amount deltas alone
        amt_delta = np.abs(phases[t + 1][1] - phases[t][1])
        baseline = set(np.argsort(-amt_delta)[:n_shift].tolist())
        print(f"phase {t}->{t + 1}: amount-only baseline recovers "
              f"{len(baseline & truth)}/{n_shift}")
    return res.transitions


if __name__ == "__main__":
    main()
