"""Quickstart on the PyTorch/CUDA port: CADDeLaG anomaly detection in ~20 lines.

Builds the paper's synthetic GMM graph pair (section 4.2.1) on the card,
runs the Algorithm-4 pipeline (commute-time embeddings through the
inverse-chain SDD solver, fused anomaly scoring), and prints the top
anomalous nodes against the injected ground truth.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

from repro_torch.core import CommuteConfig, detect_anomalies
from repro_torch.graphs import gmm_graph_sequence


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)

    # 1. the paper's synthetic benchmark: two graph snapshots, anomalies = the
    #    injected inter-cluster edges of the second snapshot
    seq = gmm_graph_sequence(n=256, seed=0, inject_p=0.02, device=args.device)

    # 2. accuracy knobs, named as in the paper: eps_RP (embedding dim),
    #    d (inverse-chain length), q (Richardson iterations)
    cfg = CommuteConfig(eps_rp=1e-3, d=8, q=10, schedule="xla")

    # 3. Algorithm 4 end to end
    res = detect_anomalies(seq.a1, seq.a2, cfg, top_k=15, device=args.device)

    truth = set(seq.anomalous_nodes.tolist())
    found = res.top_idx.tolist()
    hits = sum(1 for f in found if f in truth)
    print(f"top-15 anomalies: {found}")
    print(f"precision@15 vs injected ground truth: {hits}/15")
    return [res]


if __name__ == "__main__":
    main()
