"""Streamed-solve roofline model for one NVIDIA H100.

Port of :mod:`repro.obs.roofline` with the card's figures in place of the
reference's: the out-of-core solve is bound by whichever of scratch-store
read, host-to-device staging, or the card's arithmetic saturates first.  All
three terms come from measured traffic (the ``stream.*`` byte counters) plus
the iteration count, so run reports state measured against bound directly.
"""

from __future__ import annotations

# The streamed solve's products are fp32 (stream_gemm's skinny route and
# fused_panel_matvec run on the CUDA cores): the H100 SXM's fp32 rate outside
# the tensor cores, from NVIDIA's data sheet at the full 700 W limit.
PEAK_FLOPS = 67e12
# Sustained scratch-store read of an NVMe-class disk (a host-side figure).
DISK_BW = 2.0e9
# Host-to-device staging over the H100 SXM's host link, PCIe Gen5 x16:
# 64 GB/s per direction (data sheet, 128 GB/s both ways).
H2D_BW = 64e9

__all__ = [
    "PEAK_FLOPS",
    "DISK_BW",
    "H2D_BW",
    "streamed_solve_flops",
    "streamed_solve_roofline",
]


def streamed_solve_flops(n: int, k: int, iterations: int) -> float:
    """Dense FLOPs of a streamed solve: one (n x n) @ (n x k) mat-vec per
    iteration plus the chi build (P1 @ b), 2nk per MAC row."""
    return 2.0 * n * n * k * (iterations + 1)


def streamed_solve_roofline(
    *,
    bytes_read: float,
    bytes_h2d: float,
    flops: float,
    seconds: float,
    disk_bw: float = DISK_BW,
    h2d_bw: float = H2D_BW,
    peak_flops: float = PEAK_FLOPS,
) -> dict:
    """Three-term bound for a streamed solve, from measured traffic.

    ``bound_s = max(read/disk_bw, h2d/h2d_bw, flops/peak)`` is the fastest
    the solve could have gone on the modelled hardware; ``roofline_frac =
    bound_s / seconds`` is the share of that bound achieved.  A CPU run sits
    far below 1: the figures only mean something on the card.
    """
    t_disk = bytes_read / disk_bw
    t_h2d = bytes_h2d / h2d_bw
    t_flop = flops / peak_flops
    bound_s, bound = max((t_disk, "disk"), (t_h2d, "h2d"), (t_flop, "compute"))
    return {
        "t_disk_s": t_disk,
        "t_h2d_s": t_h2d,
        "t_compute_s": t_flop,
        "bound": bound,
        "bound_s": bound_s,
        "measured_s": seconds,
        "roofline_frac": bound_s / seconds if seconds > 0 else 0.0,
    }
