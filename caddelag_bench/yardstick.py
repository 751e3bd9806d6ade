"""Frozen peaks of one NVIDIA H100 SXM and the work a transition needs, for the roofline shares.

The peaks are NVIDIA's data sheet figures at the full 700 W (dense rates,
no sparsity).  The counts are of the work the inputs need, whatever
implements it: a later change to the program's kernels moves the time, not
these numbers.
"""

TF32_FLOPS = 495e12  # tensor-core TF32 peak: the floor for any fp32-accurate tensor-core route
HBM_BYTES_PER_S = 3.35e12  # HBM3 bandwidth
F32 = 4  # bytes


def chain_flops(n: int, d: int) -> float:
    """2(d-1) + 1 dense n x n products of the inverse chain and P2, 2 n^3 operations each."""
    return (2 * (d - 1) + 1) * 2.0 * float(n) ** 3


def score_bytes(n: int, k: int) -> float:
    """The scorer reads A1, A2 (n^2 each), Z1, Z2 (n k each) and writes n scores, fp32."""
    return F32 * (2.0 * float(n) ** 2 + 2.0 * n * k + n)
