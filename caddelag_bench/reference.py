"""Plain reference of one CADDeLaG transition, to judge the program's scores.

Straight from the paper's Algorithms 2-4, in plain PyTorch, and written
apart from the program: it imports torch and nothing else, and reads only
the two adjacencies the benchmark handed to the program.

    deg = A 1, S = D^-1/2 A D^-1/2 - u u^T (u = sqrt(deg / vol), deflated)
    P   = (I + S)(I + S^2) ... (I + S^{2^{d-1}})      (2(d-1) products)
    P1  = D^-1/2 P D^-1/2,  P2 = P1 (D - A)          (one more product)
    Y   = sqrt(A) (.) Q summed over each row, / sqrt(k)  (Q: the edge-space
          Rademacher field, from the frozen copy of the counter hash below)
    chi = P1 Y, y = chi, then q - 1 richardson steps y <- y - P2 y + chi,
          every vector's column mean removed (the Laplacian's null space)
    F_i = sum_j |A1 - A2|_ij |vol1 |z1_i - z1_j|^2 - vol2 |z2_i - z2_j|^2|

``precision="float64"`` is the reference.  The other two are the check's
controls, in float32, each one step of precision below what the
configurations state (fp32, the chain's products as 3xTF32), with every
rounding done on the bits, so a control reads the same on the CPU and on
the card:

- ``"tf32_chain"``: the chain's 2(d-1) + 1 products as one TF32 product
  each (every operand rounded to TF32: 10 mantissa bits, to nearest, ties
  away; fp32 accumulation), everything else in plain fp32, as the program
  would run with its 3xTF32 chain cut to 1xTF32;
- ``"tf32"``: every product so, the chain's, P1 Y, the solver's P2 y, the
  edge projection's row sums and the scorer's Z Z^T, as float32 with
  ``torch.backends.cuda.matmul.allow_tf32`` on would run them.
"""

from __future__ import annotations

import math

import torch

# ---------------------------------------------------------------------------
# The counter hash behind the edge-space Rademacher field (frozen copy).
# Values live in int64 tensors holding uint32 bit patterns; every multiply is
# split into 16-bit halves, so no intermediate passes 2^49.
# ---------------------------------------------------------------------------

MASK = 0xFFFFFFFF
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_GOLD = 0x9E3779B9
_PI_BITS = 0x243F6A88  # the hash's initial state

# int64 elements of one row chunk of the (rows, n, k) hash tensor
CHUNK_ELEMS = 1 << 24


def _mul32(h, m: int):
    """(h * m) mod 2^32 for h in [0, 2^32) and a 32-bit constant m."""
    lo, hi = m & 0xFFFF, m >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & MASK


def _splitmix32(h):
    h = _mul32(h ^ (h >> 16), _M1)
    h = _mul32(h ^ (h >> 15), _M2)
    return h ^ (h >> 16)


def _word(p):
    """The word a counter part contributes to the hash state."""
    return (_mul32(p & MASK, _GOLD) + _GOLD) & MASK


def _fold(h, p):
    return _splitmix32(h ^ _word(p))


def rademacher_signs(seed: int, rows: torch.Tensor, cols: torch.Tensor, k: int) -> torch.Tensor:
    """Q_c[i, j] for i in ``rows``, j in ``cols``, c < k: an int64 (R, C, k) of -1, 0, +1.

    Entries above the diagonal are +-1 from the top bit of
    hash(seed, min(i, j), max(i, j), c); Q[j, i] = -Q[i, j], and 0 on the diagonal.
    """
    h0 = _fold(_PI_BITS, int(seed) & MASK)  # a Python int: the seed's prefix
    r = rows.to(torch.int64)[:, None]
    c = cols.to(torch.int64)[None, :]
    lo, hi = torch.minimum(r, c), torch.maximum(r, c)
    h = _fold(_fold(torch.full_like(lo, h0), lo), hi)  # (R, C)
    ks = torch.arange(k, dtype=torch.int64, device=rows.device)
    h = _fold(h[:, :, None], ks[None, None, :])  # (R, C, k)
    base = 1 - 2 * (h >> 31)
    orient = torch.sign(c - r)  # +1 above the diagonal, -1 below, 0 on it
    return base * orient[:, :, None]


def edge_projection(a: torch.Tensor, seed: int, k: int, dtype, bmm=torch.bmm) -> torch.Tensor:
    """Y (n, k) = sum_j sqrt(max(A_ij, 0)) Q_c[i, j] / sqrt(k), in row chunks."""
    n = int(a.shape[0])
    dev = a.device
    cols = torch.arange(n, dtype=torch.int64, device=dev)
    y = torch.empty((n, k), dtype=dtype, device=dev)
    step = max(1, CHUNK_ELEMS // max(n * k, 1))
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        q = rademacher_signs(seed, cols[r0:r1], cols, k).to(dtype)
        w = torch.sqrt(torch.clamp(a[r0:r1].to(dtype), min=0.0))
        y[r0:r1] = bmm(w[:, None, :], q).squeeze(1)
        del q, w
    return y.mul_(1.0 / math.sqrt(k))


# ---------------------------------------------------------------------------
# The transition.
# ---------------------------------------------------------------------------


def k_rp(n: int, eps_rp: float, k_override: int | None = None) -> int:
    """The embedding width: ceil(ln(n / eps_RP)) (paper section 3.1)."""
    if k_override is not None:
        return int(k_override)
    return max(1, math.ceil(math.log(n / eps_rp)))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 on its bits: to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


PRECISIONS = ("float64", "tf32_chain", "tf32")


def _tf32_mm(x, y):
    return torch.matmul(_tf32(x), _tf32(y))


def _product(precision: str):
    """(dtype, the chain's product, every other product) of a precision."""
    if precision == "float64":
        return torch.float64, torch.matmul, torch.matmul
    if precision == "tf32_chain":
        return torch.float32, _tf32_mm, torch.matmul
    if precision == "tf32":
        return torch.float32, _tf32_mm, _tf32_mm
    raise ValueError(f"unknown precision {precision!r}; want one of {PRECISIONS}")


def _center_(x: torch.Tensor) -> torch.Tensor:
    return x.sub_(x.mean(dim=0, keepdim=True))


def embedding(a: torch.Tensor, commute: dict, precision: str = "float64"):
    """(Z (n, k), vol) of one adjacency under the configuration's ``commute`` settings."""
    solver = commute.get("solver", "richardson")
    if solver != "richardson":
        raise NotImplementedError(f"the reference solves by richardson only, not {solver!r}")
    dt, chain_mm, mm = _product(precision)
    n = int(a.shape[0])
    d, q = int(commute["d"]), int(commute["q"])
    deflate = bool(commute.get("deflate", True))
    k = k_rp(n, float(commute["eps_rp"]), commute.get("k_override"))

    deg = a.sum(dim=1, dtype=torch.float64).to(dt)
    vol = deg.sum()
    inv = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-300)), 0.0).to(dt)
    s = a.to(dt, copy=True).mul_(inv[:, None]).mul_(inv[None, :])
    if deflate:
        u = torch.sqrt(torch.clamp(deg, min=0.0) / vol)
        s.addr_(u, u, alpha=-1.0)
    p = s.clone()
    p.diagonal().add_(1.0)
    t = s
    del s
    for _ in range(1, d):
        t = chain_mm(t, t)
        p = chain_mm(p, t).add_(p)
    del t
    p1 = p.mul_(inv[:, None]).mul_(inv[None, :])
    del p
    # P2 = P1 (D - A) = P1 D - P1 A
    p2 = chain_mm(p1, a.to(dt)).neg_().addcmul_(p1, deg[None, :])

    y = edge_projection(a, int(commute.get("seed", 0)), k, dt, bmm=mm)
    chi = mm(p1, y)
    del p1, y
    if deflate:
        _center_(chi)
    z = chi.clone()
    for _ in range(q - 1):
        z = z - mm(p2, z) + chi
        if deflate:
            _center_(z)
    return z, vol


def cad_scores(a1, a2, z1, vol1, z2, vol2, precision: str = "float64") -> torch.Tensor:
    """F (n,): sum_j |A1 - A2|_ij |c1(i, j) - c2(i, j)|, in row chunks of Z's dtype."""
    dt, _, mm = _product(precision)
    n = int(a1.shape[0])
    sq1, sq2 = (z1 * z1).sum(dim=1), (z2 * z2).sum(dim=1)
    out = torch.empty((n,), dtype=dt, device=z1.device)
    step = max(1, CHUNK_ELEMS // max(n, 1))
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        c1 = vol1 * (sq1[r0:r1, None] + sq1[None, :] - 2.0 * mm(z1[r0:r1], z1.T))
        c2 = vol2 * (sq2[r0:r1, None] + sq2[None, :] - 2.0 * mm(z2[r0:r1], z2.T))
        de = (a1[r0:r1].to(dt) - a2[r0:r1].to(dt)).abs_()
        out[r0:r1] = de.mul_(c1.sub_(c2).abs_()).sum(dim=1)
        del c1, c2, de
    return out


def transition_scores(a1, a2, commute: dict, precision: str = "float64") -> torch.Tensor:
    """The node scores of the transition a1 -> a2, one endpoint's chain at a time."""
    z1, vol1 = embedding(a1, commute, precision)
    z2, vol2 = embedding(a2, commute, precision)
    return cad_scores(a1, a2, z1, vol1, z2, vol2, precision)
