"""RWKV6 ("Finch") layer: data-dependent decay, token shift, chunked WKV.

Port of :mod:`repro.models.rwkv6`.  Time-mix per head (dk = dv = head_dim),
with the per-channel decay w_t computed from the token through a LoRA
bottleneck:

    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
    y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)

Prefill and the training forward evaluate the recurrence chunk by chunk: on
the card through the hand-written ``wkv`` kernel (through ``WKVFn`` when a
gradient is wanted, whose backward differentiates :func:`wkv_chunked` in
fp32), on the CPU through :func:`wkv_chunked`, the port of the JAX
package's chunked form.  Decode is one step of
:func:`wkv_reference`, plain PyTorch on either device (plain XLA in JAX).
Tensors keep the JAX layout (B, S, H, D).
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.kernels import wkv as wkv_kernel
from repro_torch.models import common as cm
from repro_torch.models.common import ArchConfig, Params

_LORA_R = 64


def _dims(cfg: ArchConfig):
    hd = cfg.rwkv_head_dim
    return cfg.d_model // hd, hd


def init_rwkv(cfg: ArchConfig, gen: torch.Generator, device=None) -> Params:
    d, pd = cfg.d_model, cfg.pdtype
    nh, hd = _dims(cfg)
    f32 = torch.float32

    def dense(shape, dtype=pd):
        return cm.dense_init(gen, shape, dtype, device=device)

    return Params({
        # token-shift mix coefficients for r, k, v, w, g
        "mix": torch.full((5, d), 0.5, dtype=pd, device=device),
        "wr": dense((d, d)),
        "wk": dense((d, d)),
        "wv": dense((d, d)),
        "wg": dense((d, d)),
        "wo": dense((d, d)),
        # data-dependent decay LoRA: w = base + B(tanh(A x))
        "w_base": torch.full((d,), -6.0, dtype=f32, device=device),
        "w_lora_a": dense((d, _LORA_R), f32),
        "w_lora_b": cm.normal(gen, (_LORA_R, d), 0.01, device=device),
        "u_bonus": cm.normal(gen, (nh, hd), 0.1, device=device),
        "ln_x": torch.ones((d,), dtype=pd, device=device),
        # channel-mix
        "cm_mix": torch.full((2, d), 0.5, dtype=pd, device=device),
        "cm_k": dense((d, cfg.d_ff)),
        "cm_v": dense((cfg.d_ff, d)),
        "cm_r": dense((d, d)),
    })


def rwkv_axes(cfg: ArchConfig) -> dict:
    """Logical axes of :func:`init_rwkv`'s parameters, by name."""
    return {
        "mix": (None, "embed_p"),
        "wr": ("embed_p", "inner"),
        "wk": ("embed_p", "inner"),
        "wv": ("embed_p", "inner"),
        "wg": ("embed_p", "inner"),
        "wo": ("inner", "embed_p"),
        "w_base": ("inner",),
        "w_lora_a": ("embed_p", None),
        "w_lora_b": (None, "inner"),
        "u_bonus": (None, None),
        "ln_x": ("inner",),
        "cm_mix": (None, "embed_p"),
        "cm_k": ("embed_p", "ff"),
        "cm_v": ("ff", "embed_p"),
        "cm_r": ("embed_p", "inner"),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """Shift right by one along S; ``prev`` (B, 1, d) feeds position 0."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def wkv_chunked(r, k, v, lw, u, *, chunk: int, s0=None):
    """Chunked WKV, the plain version.  r/k (B,S,H,K), v (B,S,H,V), lw (B,S,H,K) <= 0.

    The chunk is ``min(chunk, S)`` halved until it divides S, as in the JAX
    package.  Returns (y (B,S,H,V) in r's dtype, s_final (B,H,K,V) fp32).
    """
    b, s, nh, dk = r.shape
    dv = v.shape[-1]
    q = min(chunk, s)
    while s % q:
        q //= 2
    nc = s // q
    f32 = torch.float32
    rc = r.reshape(b, nc, q, nh, dk).to(f32)
    kc = k.reshape(b, nc, q, nh, dk).to(f32)
    vc = v.reshape(b, nc, q, nh, dv).to(f32)
    lwc = lw.reshape(b, nc, q, nh, dk).to(f32)

    cum = torch.cumsum(lwc, dim=2)  # inclusive cumulative log decay
    cum_tm1 = cum - lwc  # exclusive
    r_dec = rc * torch.exp(cum_tm1)
    # the positive exponent is clamped as in the JAX package: valid (i < t)
    # pairs combine to <= 1, masked pairs are zeroed below
    k_dec = kc * torch.exp(torch.clamp(-cum, max=40.0))
    scores = torch.einsum("bcthk,bcihk->bcthi", r_dec, k_dec)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=r.device), diagonal=-1)
    scores = torch.where(mask[None, None, :, None, :], scores, torch.zeros_like(scores))
    bonus = torch.einsum("bcthk,hk,bcthk->bcth", rc, u.to(f32), kc)
    y_intra = torch.einsum("bcthi,bcihv->bcthv", scores, vc) + bonus[..., None] * vc

    # chunk state contribution: S_c = sum_i diag(W_Q / W_i) k_i (x) v_i
    tail = torch.exp(cum[:, :, -1:] - cum)
    s_chunk = torch.einsum("bcihk,bcihk,bcihv->bchkv", tail, kc, vc)
    chunk_decay = torch.exp(cum[:, :, -1])  # (b, nc, h, k)

    st = s0.to(f32) if s0 is not None else torch.zeros((b, nh, dk, dv), dtype=f32,
                                                       device=r.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(st)
        st = st * chunk_decay[:, c, ..., None] + s_chunk[:, c]
    s_prev = torch.stack(s_prevs, dim=1)  # (b, nc, h, k, v)
    y_inter = torch.einsum("bcthk,bchkv->bcthv", r_dec, s_prev)
    y = (y_intra + y_inter).reshape(b, s, nh, dv)
    return y.to(r.dtype), st


def wkv_reference(r, k, v, lw, u, s0=None):
    """Per-step recurrence (the oracle, and the decode step).  Returns (y, s_final)."""
    b, s, nh, dk = r.shape
    dv = v.shape[-1]
    f32 = torch.float32
    st = s0.to(f32) if s0 is not None else torch.zeros((b, nh, dk, dv), dtype=f32,
                                                       device=r.device)
    uf = u.to(f32)
    ys = []
    for t in range(s):
        rt, kt, vt, lwt = (x[:, t].to(f32) for x in (r, k, v, lw))
        y = torch.einsum("bhk,bhkv->bhv", rt, st) + (rt * uf * kt).sum(-1)[..., None] * vt
        st = st * torch.exp(lwt)[..., None] + kt[..., :, None] * vt[..., None, :]
        ys.append(y)
    return torch.stack(ys, dim=1).to(r.dtype), st


def _wkv_chunked_heads_first(batch: int, chunk: int, r, k, v, lw, u):
    """:func:`wkv_chunked`'s y on the kernel's (B*H, S, D) layout, u (H, K);
    ``WKVFn``'s backward differentiates it."""
    bh, s, _ = r.shape
    nh = bh // batch

    def model_layout(x):  # (B*H, S, D) -> (B, S, H, D)
        return x.reshape(batch, nh, s, x.shape[-1]).transpose(1, 2)

    y, _ = wkv_chunked(*(model_layout(x) for x in (r, k, v, lw)), u, chunk=chunk)
    return y.transpose(1, 2).reshape(bh, s, -1)


def _wkv_prefill(r, k, v, lw, u, *, chunk: int):
    """WKV over a whole sequence from a zero state: the ``wkv`` kernel on the
    card, else :func:`wkv_chunked`.  Returns (y (B,S,H,V), s_final (B,H,K,V));
    when a gradient is wanted the card goes through ``WKVFn`` and s_final is
    None (the training forward drops it)."""
    if r.device.type != "cuda":
        return wkv_chunked(r, k, v, lw, u, chunk=chunk)
    b, s, nh, dk = r.shape
    dv = v.shape[-1]

    def heads_first(x):  # (B, S, H, D) -> (B*H, S, D)
        return x.transpose(1, 2).reshape(b * nh, s, x.shape[-1]).contiguous()

    ins = (heads_first(r), heads_first(k), heads_first(v), heads_first(lw.to(torch.float32)))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (r, k, v, lw, u)):
        y = wkv_kernel.WKVFn.apply(*ins, u.to(torch.float32).contiguous(),
                                   partial(_wkv_chunked_heads_first, b, chunk))
        return y.reshape(b, nh, s, dv).transpose(1, 2), None
    uu = u.to(torch.float32).expand(b, nh, dk).reshape(b * nh, dk).contiguous()
    y, s_fin = wkv_kernel.wkv(*ins, uu, return_state=True)
    return y.reshape(b, nh, s, dv).transpose(1, 2), s_fin.reshape(b, nh, dk, dv)


def _time_mix_inputs(cfg: ArchConfig, p: Params, x, shifted):
    """(r, k, v, g, lw): r/k/v/lw (B,S,H,D), g (B,S,d) fp32, lw fp32."""
    nh, hd = _dims(cfg)
    dt = cfg.cdtype
    mix = p.mix.to(dt)
    xr = x * mix[0] + shifted * (1 - mix[0])
    xk = x * mix[1] + shifted * (1 - mix[1])
    xv = x * mix[2] + shifted * (1 - mix[2])
    xw = x * mix[3] + shifted * (1 - mix[3])
    xg = x * mix[4] + shifted * (1 - mix[4])
    r = xr @ p.wr.to(dt)
    k = xk @ p.wk.to(dt)
    v = xv @ p.wv.to(dt)
    g = F.silu((xg @ p.wg.to(dt)).to(torch.float32))
    # data-dependent decay (Finch): w = base + B tanh(A xw); lw = -exp(w)
    lora = torch.tanh(xw.to(torch.float32) @ p.w_lora_a) @ p.w_lora_b
    lw = -torch.exp(p.w_base + lora)
    b, s, _ = x.shape
    return (r.reshape(b, s, nh, hd), k.reshape(b, s, nh, hd), v.reshape(b, s, nh, hd), g,
            lw.reshape(b, s, nh, hd))


def _group_norm(p: Params, y):
    """Per-head group norm on the WKV output (B,S,H,V) -> (B,S,d) fp32."""
    yf = y.to(torch.float32)
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    yf = (yf - mu) * torch.rsqrt(var + 1e-5)
    b, s = y.shape[:2]
    return yf.reshape(b, s, -1) * p.ln_x.to(torch.float32)


def rwkv_timemix_prefill(cfg: ArchConfig, p: Params, x):
    """Time-mix over a prompt; x is the normed layer input (B, S, d).

    Returns (out (B,S,d), tm_prev (B,1,d), s_final (B,H,K,V)).
    """
    shifted = _token_shift(x)
    r, k, v, g, lw = _time_mix_inputs(cfg, p, x, shifted)
    y, s_fin = _wkv_prefill(r, k, v, lw, p.u_bonus, chunk=cfg.ssm_chunk)
    y = _group_norm(p, y) * g
    out = y.to(cfg.cdtype) @ p.wo.to(cfg.cdtype)
    return out, x[:, -1:, :], s_fin


def apply_rwkv_timemix(cfg: ArchConfig, p: Params, x):
    """Time-mix over a full sequence from a zero state (the training forward);
    x is the normed layer input (B, S, d)."""
    return rwkv_timemix_prefill(cfg, p, x)[0]


def apply_rwkv_channelmix(cfg: ArchConfig, p: Params, x):
    return _channelmix(cfg, p, x, _token_shift(x))


def _channelmix(cfg: ArchConfig, p: Params, x, shifted):
    dt = cfg.cdtype
    mix = p.cm_mix.to(dt)
    xk = x * mix[0] + shifted * (1 - mix[0])
    xr = x * mix[1] + shifted * (1 - mix[1])
    k = xk @ p.cm_k.to(dt)
    k = torch.square(torch.relu(k.to(torch.float32))).to(dt)
    kv = k @ p.cm_v.to(dt)
    r = torch.sigmoid((xr @ p.cm_r.to(dt)).to(torch.float32))
    return (r * kv.to(torch.float32)).to(dt)


def rwkv_cache_init(cfg: ArchConfig, batch: int, dtype, device=None) -> dict:
    nh, hd = _dims(cfg)
    return {
        "tm_prev": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
        "cm_prev": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, nh, hd, hd), dtype=torch.float32, device=device),
    }


def apply_rwkv_timemix_decode(cfg: ArchConfig, p: Params, x, cache: dict):
    """One-token time-mix; x is the normed layer input (B, 1, d)."""
    r, k, v, g, lw = _time_mix_inputs(cfg, p, x, cache["tm_prev"])
    y, s_new = wkv_reference(r, k, v, lw, p.u_bonus, s0=cache["wkv"])
    y = _group_norm(p, y) * g
    out = y.to(cfg.cdtype) @ p.wo.to(cfg.cdtype)
    return out, {**cache, "tm_prev": x, "wkv": s_new}


def apply_rwkv_channelmix_decode(cfg: ArchConfig, p: Params, x, cache: dict):
    """One-token channel-mix; x is the normed sublayer input (B, 1, d)."""
    return _channelmix(cfg, p, x, cache["cm_prev"]), {**cache, "cm_prev": x}
