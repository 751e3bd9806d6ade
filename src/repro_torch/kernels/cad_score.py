"""Fused CAD node scores through the CUDA kernel (``csrc/cad_score.cu``).

Counterpart of :mod:`repro.kernels.cad_score`.  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.  A call launches three
kernels (embedding prep, column-chunk partials, their fixed-order sum) and
counts once.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0  # kernel launches since the last reset (see kernels.reset_launch_counts)


def cad_scores_tile(a1, a2, z1i, z1j, z2i, z2j, vol1, vol2) -> torch.Tensor:
    """Partial row scores (m,) for one (m, n) adjacency tile.

    ``z*i`` are the embedding rows of the tile's rows, ``z*j`` those of its
    columns; ``vol1``/``vol2`` are the two graph volumes.
    """
    global launches
    m, n = a1.shape
    k = z1i.shape[1]
    if a2.shape != (m, n) or z1i.shape != (m, k) or z2i.shape != (m, k) \
            or z1j.shape != (n, k) or z2j.shape != (n, k):
        raise ValueError(
            f"cad_scores: shapes A1 {tuple(a1.shape)} A2 {tuple(a2.shape)} Z1i "
            f"{tuple(z1i.shape)} Z1j {tuple(z1j.shape)} Z2i {tuple(z2i.shape)} "
            f"Z2j {tuple(z2j.shape)} do not agree"
        )
    tensors = (a1, a2, z1i, z1j, z2i, z2j)
    _build.refuse_grad("cad_scores", *tensors)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("cad_scores: all operands must be float32")
    if any(t.device != a1.device for t in tensors):
        raise ValueError("cad_scores: operands on different devices")
    if a1.device.type == "cpu":
        return ref.cad_scores_tile(a1, a2, z1i, z1j, z2i, z2j, vol1, vol2)
    if a1.device.type != "cuda":
        raise ValueError(f"cad_scores: unsupported device {a1.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("cad_scores: operands must be contiguous")
    lib = _build.library()
    k_max = lib.rt_cad_scores_k_max()
    if not 1 <= k <= k_max:
        raise ValueError(f"cad_scores: embedding width k={k} outside 1..{k_max}")
    if m == 0 or n == 0:
        return torch.zeros((m,), dtype=torch.float32, device=a1.device)
    f = torch.empty((m,), dtype=torch.float32, device=a1.device)
    scratch = torch.empty((lib.rt_cad_scores_scratch_elems(m, n, k),), dtype=torch.float32,
                          device=a1.device)
    with _build.on_device(a1):
        err = lib.rt_cad_scores(
            *(t.data_ptr() for t in tensors), float(vol1), float(vol2), f.data_ptr(),
            scratch.data_ptr(), m, n, k, _build.stream_handle(a1),
        )
    _build.check(err, "cad_scores")
    launches += 1
    return f


def cad_scores(a1, a2, z1, z2, vol1, vol2) -> torch.Tensor:
    """Node anomaly scores F (n,) from two embeddings (square case)."""
    return cad_scores_tile(a1, a2, z1, z1, z2, z2, vol1, vol2)
