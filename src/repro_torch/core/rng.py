"""Counter-based (stateless) RNG for edge-space random projection.

Port of :mod:`repro.core.rng`, bit for bit.  Every Rademacher entry is a pure
integer hash of (seed, i, j, projection column), so any tile of the edge
randomness is regenerated on demand and never stored.

torch has no full uint32 arithmetic, so values live in int64 tensors holding
uint32 bit patterns.  Every multiply goes through :func:`_mul32`, which
splits the constant into 16-bit halves so no intermediate passes 2^49 -- the
result is the exact product mod 2^32 with no reliance on int64 wraparound.
The CUDA kernel (``kernels/csrc/edge_projection.cu``) computes the same hash
natively in ``uint32_t``.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_GOLD = 0x9E3779B9
_PI_BITS = 0x243F6A88  # pi fractional bits: the hash's initial state


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for h in [0, 2^32) and a 32-bit constant m."""
    lo, hi = m & 0xFFFF, m >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & MASK


def _u32(x, device=None) -> torch.Tensor:
    """An int64 tensor holding ``x`` reduced to uint32."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return torch.tensor(int(x) & MASK, dtype=torch.int64, device=device)


def splitmix32(h) -> torch.Tensor:
    """splitmix32 finalizer; uniform uint32 -> uint32 bijection."""
    h = _u32(h)
    h = _mul32(h ^ (h >> 16), _M1)
    h = _mul32(h ^ (h >> 15), _M2)
    return h ^ (h >> 16)


def _device_of(parts) -> torch.device | None:
    for p in parts:
        if isinstance(p, torch.Tensor):
            return p.device
    return None


def hash_u32(*parts) -> torch.Tensor:
    """Combine integer streams (broadcastable) into one uniform uint32 stream.

    Parts are folded in order, so a part that adds a broadcast dimension only
    widens the work from that step on.
    """
    dev = _device_of(parts)
    h = _u32(_PI_BITS, dev)
    for p in parts:
        h = splitmix32(h ^ ((_mul32(_u32(p, dev), _GOLD) + _GOLD) & MASK))
    return h


def edge_rademacher(seed, rows, cols, col_id) -> torch.Tensor:
    """Antisymmetric Rademacher field Q[i, j] in {-1, 0, +1} (0 on the diagonal).

    ``rows``/``cols`` are broadcastable global index tensors and ``col_id``
    the projection column; entries for i < j are iid +/-1 keyed on
    (seed, min, max, col_id), and Q[j, i] = -Q[i, j].
    """
    dev = _device_of((rows, cols, col_id))
    rows = torch.as_tensor(rows, device=dev).to(torch.int64)
    cols = torch.as_tensor(cols, device=dev).to(torch.int64)
    lo = torch.minimum(rows, cols)
    hi = torch.maximum(rows, cols)
    h = hash_u32(seed, lo, hi, col_id)
    base = 1.0 - 2.0 * (h >> 31).to(torch.float32)  # +/-1 from the top bit
    orient = torch.where(rows < cols, 1.0, -1.0).to(torch.float32)
    return torch.where(rows == cols, 0.0, base * orient)


def uniform01(seed, *parts) -> torch.Tensor:
    """Uniform float32 in [0, 1) keyed on integer counters."""
    return hash_u32(seed, *parts).to(torch.float32) * (2.0 ** -32)
