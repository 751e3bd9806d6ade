"""Edge-space random projection through the CUDA kernel (``csrc/edge_projection.cu``).

Counterpart of :mod:`repro.kernels.edge_projection`: Y (m, k) =
B^T W^{1/2} Q / sqrt(k) with Q regenerated in the kernel from the counter
hash.  A CPU (or ``meta``) tensor takes the plain version; a CUDA tensor
launches the kernel or raises.  A call launches two kernels (per-column-tile partials,
then their fixed-order sum) and counts once.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build, ref

launches = 0  # kernel launches since the last reset (see kernels.reset_launch_counts)


def _check(a: torch.Tensor, k: int) -> None:
    if a.ndim != 2:
        raise ValueError(f"edge_projection: A must be 2-D, got {tuple(a.shape)}")
    if a.dtype != torch.float32:
        raise TypeError(f"edge_projection: A must be float32, got {a.dtype}")
    if k < 1:
        raise ValueError(f"edge_projection: k must be >= 1, got {k}")


def edge_projection(a: torch.Tensor, *, seed: int, k: int, row0: int = 0,
                    col0: int = 0) -> torch.Tensor:
    """Y[i, c] = sum_j sqrt(max(A_ij, 0)) Q_c[row0 + i, col0 + j] / sqrt(k), fp32 (m, k).

    ``row0`` / ``col0`` are the global ids of ``a``'s first row and column:
    0 for a resident adjacency, the panel origin for a streamed row panel,
    the tile origin for one tile of a device grid (whose column blocks sum
    to the whole row's value).
    """
    global launches
    _check(a, k)
    _build.refuse_grad("edge_projection", a)
    if row0 < 0 or col0 < 0:
        raise ValueError(f"edge_projection: row0={row0} and col0={col0} must be >= 0")
    if _build.plain(a):
        return ref.edge_projection(a, seed=seed, k=k, row0=row0, col0=col0)
    if a.device.type != "cuda":
        raise ValueError(f"edge_projection: unsupported device {a.device}")
    if not a.is_contiguous():
        raise ValueError("edge_projection: A must be contiguous")
    m, n = a.shape
    if m == 0 or n == 0:
        return torch.zeros((m, k), dtype=torch.float32, device=a.device)
    y = torch.empty((m, k), dtype=torch.float32, device=a.device)
    lib = _build.library()
    part = torch.empty((lib.rt_edge_projection_scratch_elems(col0, m, n, k),),
                       dtype=torch.float32, device=a.device)
    with _build.on_device(a):
        err = lib.rt_edge_projection(
            a.data_ptr(), y.data_ptr(), part.data_ptr(), row0, m, col0, n,
            int(seed) & 0xFFFFFFFF, k, 1.0 / math.sqrt(k), _build.stream_handle(a),
        )
    _build.check(err, "edge_projection")
    launches += 1
    return y


def rademacher_field(
    seed: int, rows: range, cols: range, k: int, device: torch.device | str = "cuda"
) -> torch.Tensor:
    """Q_c[i, j] for i in ``rows``, j in ``cols``, c < k, as the CUDA kernel hashes it.

    A check helper (not on the pipeline path): it writes out the field the
    projection kernel regenerates, so the in-kernel hash can be compared
    bitwise with :func:`repro_torch.core.rng.edge_rademacher`.
    """
    nr, nc = len(rows), len(cols)
    q = torch.empty((nr, nc, k), dtype=torch.float32, device=device)
    if q.numel() == 0:
        return q
    lib = _build.library()
    with _build.on_device(q):
        err = lib.rt_rademacher_field(
            q.data_ptr(), rows.start, cols.start, nr, nc, int(seed) & 0xFFFFFFFF, k,
            _build.stream_handle(q),
        )
    _build.check(err, "rademacher_field")
    return q
