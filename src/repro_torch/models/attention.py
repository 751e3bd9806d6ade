"""GQA attention: full-sequence (training, prefill, encoder, cross-attention)
and cached decode.

Port of :mod:`repro.models.attention`.  Full-sequence attention runs the
hand-written ``flash_attention`` kernel on the card -- through
``FlashAttentionFn`` when a gradient is wanted, whose backward
differentiates :func:`_chunked_flash` in fp32 -- and :func:`_chunked_flash`,
the port of the JAX package's chunked online softmax, on the CPU.  Decode
attends one token over the (B, S_max, nkv, hd) cache (or, across, over the
encoder's K/V) in plain PyTorch on either device, as the JAX package does
in plain XLA.  Cross-attention rotates q by RoPE and leaves the encoder's
keys unrotated.  Tensors keep the JAX layout (B, S, H, D).
"""

from __future__ import annotations

import math
from functools import partial

import torch

from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.models import common as cm
from repro_torch.models.common import ArchConfig, Params

_NEG_INF = -1e30


def init_attention(cfg: ArchConfig, gen: torch.Generator, *, d_in: int | None = None,
                   device=None) -> Params:
    """QKVO projections (+ optional bias and qk-norm scales)."""
    d = d_in or cfg.d_model
    hd, nh, nkv, pd = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.pdtype
    t = {
        "wq": cm.dense_init(gen, (d, nh * hd), pd, device=device),
        "wk": cm.dense_init(gen, (d, nkv * hd), pd, device=device),
        "wv": cm.dense_init(gen, (d, nkv * hd), pd, device=device),
        "wo": cm.dense_init(gen, (nh * hd, cfg.d_model), pd, device=device),
    }
    if cfg.qkv_bias:
        t["bq"] = torch.zeros((nh * hd,), dtype=pd, device=device)
        t["bk"] = torch.zeros((nkv * hd,), dtype=pd, device=device)
        t["bv"] = torch.zeros((nkv * hd,), dtype=pd, device=device)
    if cfg.qk_norm:
        t["q_norm"] = torch.ones((hd,), dtype=pd, device=device)
        t["k_norm"] = torch.ones((hd,), dtype=pd, device=device)
    return Params(t)


def attention_axes(cfg: ArchConfig) -> dict:
    """Logical axes of :func:`init_attention`'s parameters, by name."""
    ax = {
        "wq": ("embed_p", "heads"),
        "wk": ("embed_p", "kv_heads"),
        "wv": ("embed_p", "kv_heads"),
        "wo": ("heads", "embed_p"),
    }
    if cfg.qkv_bias:
        ax.update(bq=("heads",), bk=("kv_heads",), bv=("kv_heads",))
    if cfg.qk_norm:
        ax.update(q_norm=("head_dim",), k_norm=("head_dim",))
    return ax


def _rms(x, scale):
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    return (y * scale.to(torch.float32)).to(x.dtype)


def _project_q(cfg: ArchConfig, p: Params, x, cos, sin):
    """x (B, S, d_in) -> q (B,S,nh,hd), normed when qk-norm is on, RoPE applied."""
    b, s, _ = x.shape
    dt = cfg.cdtype
    q = x @ p.wq.to(dt)
    if cfg.qkv_bias:
        q = q + p.bq.to(dt)
    q = q.reshape(b, s, cfg.n_heads, cfg.hd)
    if cfg.qk_norm:
        q = _rms(q, p.q_norm)
    return cm.apply_rope(q, cos, sin)


def _project_qkv(cfg: ArchConfig, p: Params, x, positions):
    """x (B, S, d_in) -> q (B,S,nh,hd), k/v (B,S,nkv,hd) with RoPE applied."""
    b, s, _ = x.shape
    hd, nkv = cfg.hd, cfg.n_kv_heads
    dt = cfg.cdtype
    cos, sin = cm.rope_tables(positions, hd, cfg.rope_theta)
    q = _project_q(cfg, p, x, cos, sin)
    k = x @ p.wk.to(dt)
    v = x @ p.wv.to(dt)
    if cfg.qkv_bias:
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    k = k.reshape(b, s, nkv, hd)
    v = v.reshape(b, s, nkv, hd)
    if cfg.qk_norm:
        k = _rms(k, p.k_norm)
    return q, cm.apply_rope(k, cos, sin), v


def project_kv(cfg: ArchConfig, p: Params, x_enc):
    """Encoder output (B, T, d) -> the cross-attention's k/v (B, T, nkv, hd):
    no RoPE on the encoder's keys, no qk-norm (as the JAX package)."""
    b, t, _ = x_enc.shape
    nkv, hd = cfg.n_kv_heads, cfg.hd
    dt = cfg.cdtype
    k = (x_enc @ p.wk.to(dt)).reshape(b, t, nkv, hd)
    v = (x_enc @ p.wv.to(dt)).reshape(b, t, nkv, hd)
    if cfg.qkv_bias:
        k = k + p.bk.to(dt).reshape(nkv, hd)
        v = v + p.bv.to(dt).reshape(nkv, hd)
    return k, v


def _chunked_flash(cfg: ArchConfig, q, k, v, *, causal: bool) -> torch.Tensor:
    """(B,S,nh,hd) x (B,T,nkv,hd) -> (B,S,nh,hd): online softmax over KV chunks.

    The plain version.  GQA reshapes q to (B,S,nkv,g,hd) so the kv head axis
    contracts without repeating K/V; the chunk is ``min(attn_chunk, T)``
    halved until it divides T, as in the JAX package.
    """
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    ck = min(cfg.attn_chunk, t)
    while t % ck:
        ck //= 2
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    qf = q.to(f32).reshape(b, s, nkv, g, hd) * scale
    kf, vf = k.to(f32), v.to(f32)
    q_pos = torch.arange(s, device=q.device)
    m = torch.full((b, s, nkv, g), _NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, s, nkv, g), dtype=f32, device=q.device)
    acc = torch.zeros((b, s, nkv, g, hd), dtype=f32, device=q.device)
    for c0 in range(0, t, ck):
        kb, vb = kf[:, c0 : c0 + ck], vf[:, c0 : c0 + ck]
        sc = torch.einsum("bsngh,bcnh->bsngc", qf, kb)
        if causal:
            k_pos = c0 + torch.arange(ck, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            sc = torch.where(mask[None, :, None, None, :], sc, torch.full_like(sc, _NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1))
        pexp = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + pexp.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bsngc,bcnh->bsngh", pexp, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, s, nh, hd).to(cfg.cdtype)


def _chunked_flash_heads_first(cfg: ArchConfig, batch: int, q, k, v, *, causal: bool,
                               groups: int) -> torch.Tensor:
    """:func:`_chunked_flash` on the kernel's layout: (B*nh, S, hd) x (B*nkv, T, hd)
    -> (B*nh, S, hd); ``FlashAttentionFn``'s backward differentiates it."""
    bhq, s, hd = q.shape
    nh, t = bhq // batch, k.shape[1]

    def model_layout(x, heads, n):  # (B*H, n, D) -> (B, n, H, D)
        return x.reshape(batch, heads, n, hd).transpose(1, 2)

    out = _chunked_flash(cfg, model_layout(q, nh, s), model_layout(k, nh // groups, t),
                         model_layout(v, nh // groups, t), causal=causal)
    return out.transpose(1, 2).reshape(bhq, s, hd)


def _flash(cfg: ArchConfig, q, k, v, *, causal: bool = True) -> torch.Tensor:
    """(B,S,nh,hd) x (B,T,nkv,hd) -> (B,S,nh,hd): the ``flash_attention`` kernel
    on the card (through ``FlashAttentionFn`` when a gradient is wanted), else
    :func:`_chunked_flash`."""
    if q.device.type != "cuda":
        return _chunked_flash(cfg, q, k, v, causal=causal)
    b, s, nh, hd = q.shape
    groups = nh // k.shape[2]

    def heads_first(x):  # (B, S, H, D) -> (B*H, S, D)
        return x.transpose(1, 2).reshape(-1, x.shape[1], hd).contiguous()

    qh, kh, vh = heads_first(q), heads_first(k), heads_first(v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        recompute = partial(_chunked_flash_heads_first, cfg.replace(compute_dtype="float32"), b)
        out = flash_kernel.FlashAttentionFn.apply(qh, kh, vh, causal, groups, recompute)
    else:
        out = flash_kernel.flash_attention(qh, kh, vh, causal=causal, groups=groups)
    return out.reshape(b, nh, s, hd).transpose(1, 2).to(cfg.cdtype)


def attend_train(cfg: ArchConfig, p: Params, x, *, causal: bool = True, kv_override=None):
    """Full-sequence attention (training, the encoder, cross-attention).

    ``kv_override=(k, v)`` (the encoder's, :func:`project_kv`) makes it
    cross-attention: q from ``x`` with RoPE at ``arange(S)``, keys unrotated,
    any length T.  The JAX package also projects (and drops) x's own K/V
    there; the port does not compute them.
    """
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    if kv_override is None:
        q, k, v = _project_qkv(cfg, p, x, positions)
    else:
        q = _project_q(cfg, p, x, *cm.rope_tables(positions, cfg.hd, cfg.rope_theta))
        k, v = kv_override
    out = _flash(cfg, q, k, v, causal=causal).reshape(b, s, -1)
    return out @ p.wo.to(cfg.cdtype)


def attend_prefill(cfg: ArchConfig, p: Params, x):
    """Causal attention over a prompt; returns (y, (k, v)) for the decode cache."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)
    out = _flash(cfg, q, k, v).reshape(b, s, -1)
    return out @ p.wo.to(cfg.cdtype), (k, v)


def attend_decode(cfg: ArchConfig, p: Params, x, cache, pos: int):
    """One-token decode against a (k, v) cache; returns (y, cache).

    cache k/v: (B, S_max, nkv, hd).  The new token's k/v are written at
    ``pos`` in place (JAX's dynamic_update_slice returns a new buffer), then
    the token attends over positions <= pos.
    """
    b, one, _ = x.shape
    k_cache, v_cache = cache
    s_max = k_cache.shape[1]
    positions = torch.full((one,), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    k_cache[:, pos : pos + one] = k_new.to(k_cache.dtype)
    v_cache[:, pos : pos + one] = v_new.to(v_cache.dtype)

    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = nh // nkv
    qf = q.to(torch.float32).reshape(b, one, nkv, g, hd) * (1.0 / math.sqrt(hd))
    sc = torch.einsum("bsngh,btnh->bsngt", qf, k_cache.to(torch.float32))
    valid = torch.arange(s_max, device=x.device) <= pos
    sc = torch.where(valid[None, None, None, None, :], sc, torch.full_like(sc, _NEG_INF))
    w = torch.softmax(sc, dim=-1)
    out = torch.einsum("bsngt,btnh->bsngh", w, v_cache.to(torch.float32))
    out = out.reshape(b, one, nh * hd).to(cfg.cdtype)
    return out @ p.wo.to(cfg.cdtype), (k_cache, v_cache)


def cross_attend_decode(cfg: ArchConfig, p: Params, x, enc_kv, pos: int):
    """One decoder token against the encoder's (k, v) (B, T, nkv, hd): no mask,
    no cache update; q gets RoPE at ``pos`` (as cross-attention's prefill
    rotates q at its position), the encoder's keys stay unrotated."""
    b, one, _ = x.shape
    k, v = enc_kv
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.cdtype
    positions = torch.full((one,), pos, dtype=torch.int32, device=x.device)
    q = _project_q(cfg, p, x, *cm.rope_tables(positions, hd, cfg.rope_theta))
    qf = q.to(torch.float32).reshape(b, one, nkv, nh // nkv, hd) * (1.0 / math.sqrt(hd))
    sc = torch.einsum("bsngh,btnh->bsngt", qf, k.to(torch.float32))
    w = torch.softmax(sc, dim=-1)
    out = torch.einsum("bsngt,btnh->bsngh", w, v.to(torch.float32))
    return out.reshape(b, one, nh * hd).to(dt) @ p.wo.to(dt)
