"""Plain PyTorch versions of the hand-written kernels.

Port of :mod:`repro.kernels.ref`.  The wrappers run these for CPU and
``meta`` tensors, and ``chip_smoke.py`` holds each CUDA kernel against them
on the card.  The edge projection and the CAD scorer work in row chunks so
they also fit on the card at n=10512: a whole (n, n, k) int64 hash tensor
would be 15 GB.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import rng as crng

# Elements per row chunk of the (rows, n, k) hash tensor / (rows, n) tiles.
_CHUNK_ELEMS = 1 << 24


def _row_chunks(m: int, per_row: int):
    step = max(1, _CHUNK_ELEMS // max(per_row, 1))
    for r0 in range(0, m, step):
        yield r0, min(m, r0 + step)


def block_matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """C = A @ B with fp32 accumulation."""
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(out_dtype)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 (10 explicit mantissa bits), to nearest, ties away
    from zero: add half of the 13 dropped bits to the magnitude and clear
    them, on the float's bits (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)``: hi = x rounded to TF32, lo = (x - hi) rounded to TF32.

    The split pass of ``block_matmul``'s fp32 route; ``x - hi - lo`` is at
    most 2^-22 |x| (for normal x, while lo stays normal; below that, half a
    TF32 subnormal step, 2^-137).
    """
    x = x.to(torch.float32)
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def edge_projection(a: torch.Tensor, *, seed: int, k: int, row0: int = 0,
                    col0: int = 0) -> torch.Tensor:
    """Y[i, c] = sum_j sqrt(max(A_ij, 0)) Q_c[row0 + i, col0 + j] / sqrt(k).

    ``row0`` / ``col0`` are the global ids of ``a``'s first row and column
    (a streamed row panel, a tile of a device grid).
    """
    m, n = a.shape
    dev = a.device
    cols = torch.arange(col0, col0 + n, device=dev, dtype=torch.int64)[None, :, None]
    ks = torch.arange(k, device=dev, dtype=torch.int64)[None, None, :]
    y = torch.empty((m, k), dtype=torch.float32, device=dev)
    for r0, r1 in _row_chunks(m, n * k):
        s = torch.sqrt(torch.clamp(a[r0:r1].to(torch.float32), min=0.0))
        rows = torch.arange(row0 + r0, row0 + r1, device=dev, dtype=torch.int64)[:, None, None]
        q = crng.edge_rademacher(seed, rows, cols, ks)
        y[r0:r1] = torch.sum(s[:, :, None] * q, dim=1)
    return y * (1.0 / math.sqrt(k))


def _dist(zi: torch.Tensor, zj: torch.Tensor, vol) -> torch.Tensor:
    zi = zi.to(torch.float32)
    zj = zj.to(torch.float32)
    sq_i = torch.sum(zi * zi, dim=-1)
    sq_j = torch.sum(zj * zj, dim=-1)
    return vol * (sq_i[:, None] + sq_j[None, :] - 2.0 * (zi @ zj.T))


def cad_scores_tile(a1, a2, z1i, z1j, z2i, z2j, vol1, vol2) -> torch.Tensor:
    """Partial row scores (m,) of one (m, n) adjacency tile."""
    m, n = a1.shape
    out = torch.empty((m,), dtype=torch.float32, device=a1.device)
    for r0, r1 in _row_chunks(m, n):
        de = torch.abs(a1[r0:r1].to(torch.float32) - a2[r0:r1].to(torch.float32)) * torch.abs(
            _dist(z1i[r0:r1], z1j, vol1) - _dist(z2i[r0:r1], z2j, vol2)
        )
        out[r0:r1] = torch.sum(de, dim=1)
    return out


def cad_scores(a1, a2, z1, z2, vol1, vol2) -> torch.Tensor:
    """Node anomaly scores F (n,) from two embeddings (square case)."""
    return cad_scores_tile(a1, a2, z1, z1, z2, z2, vol1, vol2)


def decode_bits(x: torch.Tensor) -> torch.Tensor:
    """fp32 values of an operand: int16-carried bf16 bit patterns widen
    exactly (the bits become the high half of a float32, as
    ``_bf16_u16_to_f32`` does); any other dtype is cast."""
    if x.dtype != torch.int16:
        return x.to(torch.float32)
    lo = torch.zeros_like(x)
    return torch.stack([lo, x], dim=-1).view(torch.float32).squeeze(-1)


def stream_gemm(a: torch.Tensor, b: torch.Tensor, init=None, *, sign: float = 1.0):
    """``init + sign * (A @ B)`` (init optional) in fp32; A, B fp32 or bits."""
    acc = decode_bits(a) @ decode_bits(b)
    if init is None:
        return -acc if sign < 0 else acc
    base = init.to(torch.float32)
    return base - acc if sign < 0 else base + acc


def fused_panel_matvec(p_panel, y, chi_panel, y_panel):
    """``(gy, colsum, sumsq)``: gy = chi + y_panel - P y, and the column sums
    (1, q) and sum of squares (1, 1) of delta = chi - P y."""
    mv = decode_bits(p_panel) @ y.to(torch.float32)
    chi = chi_panel.to(torch.float32)
    gy = chi + y_panel.to(torch.float32) - mv
    delta = chi - mv
    return gy, delta.sum(dim=0, keepdim=True), (delta * delta).sum().reshape(1, 1)


def panel_topk_update(run_vals, run_idx, zq, z_panel, inv_deg_q, inv_deg_panel, vol, row0,
                      exclude, *, topk: int, corrected: bool = False, largest: bool = True):
    """Merge one Z row panel into the running (q, topk) state.

    Scores ``vol * dist2`` (or ``dist2 - 1/deg_q - 1/deg_j`` when
    ``corrected``) with ``dist2 = max(|zq|^2 + |zj|^2 - 2 zq.zj, 0)`` in fp32,
    the excluded global id scored worst; then a stable sort of the state
    followed by the panel keeps the best ``topk``, ties to the lower position.
    """
    zq = zq.to(torch.float32)
    zb = decode_bits(z_panel)
    sq_q = torch.sum(zq * zq, dim=-1, keepdim=True)
    sq_j = torch.sum(zb * zb, dim=-1)[None, :]
    dist2 = torch.clamp(sq_q + sq_j - 2.0 * (zq @ zb.T), min=0.0)
    if corrected:
        scores = dist2 - inv_deg_q - inv_deg_panel
    else:
        scores = torch.tensor(float(vol), dtype=torch.float32, device=dist2.device) * dist2
    ph = zb.shape[0]
    cidx = row0 + torch.arange(ph, device=zq.device, dtype=torch.int32)[None, :]
    worst = float("-inf") if largest else float("inf")
    scores = torch.where(cidx == exclude, torch.full_like(scores, worst), scores)
    vals = torch.cat([run_vals, scores], dim=1)
    idx = torch.cat([run_idx, cidx.expand(zq.shape[0], ph)], dim=1)
    work = vals if largest else -vals
    order = torch.sort(work, dim=1, descending=True, stable=True).indices[:, :topk]
    return torch.gather(vals, 1, order), torch.gather(idx, 1, order)


def flash_attention(q, k, v, *, causal: bool = True, groups: int = 1,
                    q_offset: int = 0) -> torch.Tensor:
    """Materialized-softmax attention; q (BHq, S, D), k/v (BHkv, T, D), BHq = BHkv x groups.

    q head ``h`` attends with KV head ``h // groups`` (K/V repeated per group).
    fp32 inside, the output in q's dtype; q scaled by 1/sqrt(D); causal
    masks ``q_pos + q_offset < k_pos`` (both counted from 0) with -1e30:
    query row ``i`` sits at position ``q_offset + i`` of the keys.
    """
    s, d = q.shape[1], q.shape[2]
    t = k.shape[1]
    scale = 1.0 / (d**0.5)
    kf = k.to(torch.float32).repeat_interleave(groups, dim=0)
    vf = v.to(torch.float32).repeat_interleave(groups, dim=0)
    logits = torch.einsum("hsd,htd->hst", q.to(torch.float32) * scale, kf)
    if causal:
        q_pos = torch.arange(s, device=q.device)[:, None] + q_offset
        mask = q_pos >= torch.arange(t, device=q.device)[None, :]
        logits = torch.where(mask[None], logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("hst,htd->hsd", p, vf).to(q.dtype)


def wkv(r, k, v, lw, u, *, s0=None, return_state: bool = False):
    """Per-step WKV recurrence; r/k/lw (BH, S, dk), v (BH, S, dv), u (BH, dk).

    ``y_t = r_t . (S + diag(u) k_t v_t^T)``, ``S <- diag(exp(lw_t)) S + k_t v_t^T``
    in fp32 from ``s0`` (BH, dk, dv; zeros when None).  Returns y (BH, S, dv)
    in r's dtype, and the final state (BH, dk, dv) fp32 when ``return_state``.
    """
    bh, s, dk = r.shape
    dv = v.shape[-1]
    st = (torch.zeros((bh, dk, dv), dtype=torch.float32, device=r.device) if s0 is None
          else s0.to(torch.float32).clone())
    rf, kf, vf, lf = (x.to(torch.float32) for x in (r, k, v, lw))
    uf = u.to(torch.float32)
    ys = []
    for t in range(s):
        rt, kt, vt = rf[:, t], kf[:, t], vf[:, t]
        bonus = (rt * uf * kt).sum(-1, keepdim=True)
        ys.append(torch.einsum("bk,bkv->bv", rt, st) + bonus * vt)
        st = st * torch.exp(lf[:, t])[..., None] + kt[:, :, None] * vt[:, None, :]
    y = (torch.stack(ys, dim=1) if s else vf[:, :0]).to(r.dtype)
    return (y, st) if return_state else y
