"""Paper section 5.1 on the PyTorch/CUDA port: precipitation anomalies on a
climate-like grid.

The NCEP data (259,200 geolocations) is not shipped; this generates a
T-month sequence of smooth random precipitation fields on a lat/lon grid
with a localized event appearing mid-sequence, builds the paper's fully
connected Gaussian-kernel graph, and streams the snapshots through the
sequence engine.  The transitions where the event appears and disappears
should put the event region at the top of the anomalies.

    PYTHONPATH=src python examples/torch_climate_anomaly.py [--lat 16 --lon 16 --t-steps 4]
        [--device cpu]
"""

import argparse

from repro_torch.core import CommuteConfig, SequenceDetector
from repro_torch.graphs import climate_snapshot_sequence


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lat", type=int, default=16)
    ap.add_argument("--lon", type=int, default=16)
    ap.add_argument("--t-steps", type=int, default=4)
    ap.add_argument("--top-k", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)

    seq = climate_snapshot_sequence(
        args.lat, args.lon, args.t_steps, seed=3, sigma=1.0, event_frac=0.04,
        event_strength=8.0, device=args.device,
    )
    cfg = CommuteConfig(eps_rp=1e-3, d=8, q=10, schedule="xla")
    det = SequenceDetector(cfg, top_k=args.top_k, device=args.device)
    res = det.run(seq.snapshots())

    print(f"grid {args.lat}x{args.lon}, {args.t_steps} months; "
          f"{res.chain_builds} chain builds for {len(res.transitions)} transitions")
    for t, r in enumerate(res.transitions):
        found = r.top_idx.tolist()
        event = set(seq.truth[t].tolist())
        hits = sum(1 for f in found if f in event)
        label = f"event region ({len(event)} nodes)" if event else "quiet"
        print(f"month {t}->{t + 1} [{label}]: in-region hits {hits}/{args.top_k}")

    top = int(res.global_top_idx[0])
    step = int(res.global_top_step[0])
    r, c = divmod(top, args.lon)
    print(f"strongest anomaly across the sequence: grid ({r}, {c}) "
          f"at transition {step}->{step + 1}")
    return res.transitions


if __name__ == "__main__":
    main()
