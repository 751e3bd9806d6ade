"""The LM stack for serving: prefill and decode for every decoder-only family.

Port of :mod:`repro.models.lm`.  A model is a sequence of groups, each a
tuple of block types repeated ``count`` times; the JAX package stacks each
group's layers and scans over them, the port keeps one parameter container
per layer in ``params.blocks`` (in execution order) and loops.

  dense / vlm      [("attn",) x L]
  moe (granite)    [("attn_moe",) x L]
  llama4           [("attn", "attn_moe") x L/2]   (d_ff 2x on the dense layers)
  rwkv6            [("rwkv",) x L]
  zamba2 (hybrid)  [("mamba" x 6, "shared_attn") x 13] + [("mamba",) x 3]

The shared attention block's parameters are stored once, at
``params.shared_attn``, and are not in ``params.blocks``; each of its
invocations has its own KV cache.  Its input is concat(h, emb0), the hidden
state beside the token embeddings, normed at width 2 * d_model.

Entry points: :func:`init_params`, :func:`init_cache`, :func:`prefill` and
:func:`decode_step`; the MoE aux losses are dropped on this path, as the JAX
prefill and decode drop them.  The encoder-decoder family and the training
loss wait for later slices of the port (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mamba2 as mb
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.common import ArchConfig, Params


@dataclass(frozen=True)
class GroupSpec:
    block_types: tuple[str, ...]
    count: int
    # per-block-type overrides, e.g. {"attn": {"d_ff": 16384}}
    overrides: tuple[tuple[str, Any], ...] = ()

    def override(self, bt: str) -> dict:
        return dict(self.overrides).get(bt, {})


@dataclass(frozen=True)
class LMSpec:
    cfg: ArchConfig
    groups: tuple[GroupSpec, ...]

    @property
    def has_shared_attn(self) -> bool:
        return any("shared_attn" in g.block_types for g in self.groups)

    def layers(self) -> list[str]:
        """The block type of every block, in execution order."""
        return [bt for g in self.groups for _ in range(g.count) for bt in g.block_types]


def build_spec(cfg: ArchConfig) -> LMSpec:
    if cfg.family == "moe":
        if cfg.moe_layer_step == 2:
            # llama4-style: alternate dense (2x ff) and MoE layers
            return LMSpec(cfg=cfg, groups=(GroupSpec(
                ("attn", "attn_moe"), cfg.n_layers // 2,
                overrides=(("attn", {"d_ff": 2 * cfg.d_ff}),)),))
        return LMSpec(cfg=cfg, groups=(GroupSpec(("attn_moe",), cfg.n_layers),))
    if cfg.family == "ssm" and cfg.rwkv:
        return LMSpec(cfg=cfg, groups=(GroupSpec(("rwkv",), cfg.n_layers),))
    if cfg.family == "hybrid":
        k = cfg.attn_every
        full, rem = divmod(cfg.n_layers, k)
        groups = [GroupSpec(tuple(["mamba"] * k + ["shared_attn"]), full)]
        if rem:
            groups.append(GroupSpec(("mamba",), rem))
        return LMSpec(cfg=cfg, groups=tuple(groups))
    if cfg.family in ("dense", "vlm"):
        return LMSpec(cfg=cfg, groups=(GroupSpec(("attn",), cfg.n_layers),))
    raise NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported to repro_torch yet "
        f"(ROADMAP.md, Queue 1); ported: dense, vlm, moe, hybrid, ssm with rwkv")


def _shared_attn_cfg(cfg: ArchConfig) -> ArchConfig:
    """Zamba's shared block attends over concat(h, emb0): d_in = 2 * d_model."""
    return cfg.replace(head_dim=2 * cfg.d_model // cfg.n_heads, qk_norm=False, qkv_bias=False)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_block(cfg: ArchConfig, bt: str, gen: torch.Generator, ov: dict, device=None) -> Params:
    """One block's parameters; ``ov`` is its group's override (llama4's d_ff)."""
    ninit, _ = cm.make_norm(cfg, cfg.d_model)
    if bt == "attn":
        return Params(ln1=ninit(device), attn=attn.init_attention(cfg, gen, device=device),
                      ln2=ninit(device),
                      mlp=mlp_mod.init_mlp(cfg, gen, d_ff=ov.get("d_ff"), device=device))
    if bt == "attn_moe":
        return Params(ln1=ninit(device), attn=attn.init_attention(cfg, gen, device=device),
                      ln2=ninit(device), moe=moe_mod.init_moe(cfg, gen, device=device))
    if bt == "mamba":
        return Params(ln=ninit(device), mamba=mb.init_mamba(cfg, gen, device=device))
    if bt == "rwkv":
        return Params(ln1=ninit(device), ln2=ninit(device),
                      rwkv=rwkv_mod.init_rwkv(cfg, gen, device=device))
    raise ValueError(f"unknown block type {bt!r}")


def init_params(spec: LMSpec, seed: int = 0, device="cuda") -> Params:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, made on ``device``."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    cfg = spec.cfg
    gen = torch.Generator(device=dev).manual_seed(seed)
    ninit, _ = cm.make_norm(cfg, cfg.d_model)
    t = {"embed": cm.embed_init(gen, (cfg.vocab_padded, cfg.d_model), cfg.pdtype, device=dev)}
    if not cfg.tie_embeddings:
        t["lm_head"] = cm.dense_init(gen, (cfg.d_model, cfg.vocab_padded), cfg.pdtype,
                                     device=dev)
    blocks = nn.ModuleList(
        init_block(cfg, bt, gen, g.override(bt), dev)
        for g in spec.groups for _ in range(g.count) for bt in g.block_types
        if bt != "shared_attn")
    children = {"final_norm": ninit(dev), "blocks": blocks}
    if spec.has_shared_attn:
        scfg = _shared_attn_cfg(cfg)
        sn, _ = cm.make_norm(cfg, 2 * cfg.d_model)
        children["shared_attn"] = Params(
            ln=sn(dev), attn=attn.init_attention(scfg, gen, d_in=2 * cfg.d_model, device=dev),
            ln2=ninit(dev), mlp=mlp_mod.init_mlp(cfg, gen, device=dev))  # the block's FFN (d_ff)
    return Params(t, **children)


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def _walk(spec: LMSpec, params: Params):
    """(block type, its parameters) of every block in execution order; the
    shared block's are ``params.shared_attn`` at each invocation."""
    blocks = iter(params.blocks)
    for bt in spec.layers():
        yield bt, (params.shared_attn if bt == "shared_attn" else next(blocks))


# ---------------------------------------------------------------------------
# embedding and unembedding
# ---------------------------------------------------------------------------


def _embed_tokens(cfg: ArchConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params.embed[tokens].to(cfg.cdtype)


def _unembed(cfg: ArchConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    """Logits over the padded vocab; padding columns masked to -1e30."""
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = h @ w.to(cfg.cdtype)
    if cfg.vocab_padded != cfg.vocab:
        logits[..., cfg.vocab:] = -1e30
    return logits


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(spec: LMSpec, batch: int, s_max: int, device="cuda") -> dict:
    """Decode caches, one dict per block (each shared-block invocation its
    own), and the next position."""
    cfg = spec.cfg
    dt = cfg.cdtype
    layers = []
    for bt in spec.layers():
        if bt in ("attn", "attn_moe", "shared_attn"):
            acfg = _shared_attn_cfg(cfg) if bt == "shared_attn" else cfg
            shape = (batch, s_max, acfg.n_kv_heads, acfg.hd)
            layers.append({"k": torch.zeros(shape, dtype=dt, device=device),
                           "v": torch.zeros(shape, dtype=dt, device=device)})
        elif bt == "mamba":
            layers.append(mb.mamba_cache_init(cfg, batch, dt, device=device))
        elif bt == "rwkv":
            layers.append(rwkv_mod.rwkv_cache_init(cfg, batch, dt, device=device))
        else:
            raise ValueError(bt)
    return {"layers": layers, "pos": 0}


def _shared_in(cfg: ArchConfig, bp: Params, h, emb0):
    """The shared block's attention input: concat(h, emb0) normed at 2 * d_model."""
    _, napply2 = cm.make_norm(cfg, 2 * cfg.d_model)
    return napply2(bp.ln, torch.cat([h, emb0], dim=-1))


def _ffn(cfg: ArchConfig, bt: str, bp: Params, x):
    """The block's second half: the MLP, or the MoE layer (its aux dropped)."""
    if bt == "attn_moe":
        return moe_mod.moe_forward(cfg, bp.moe, x)[0]
    return mlp_mod.apply_mlp(cfg, bp.mlp, x)


def _apply_block_prefill(cfg: ArchConfig, bt: str, bp: Params, h, c: dict, emb0):
    """One block over the prompt; fills the block's decode cache ``c`` in place."""
    _, napply = cm.make_norm(cfg, cfg.d_model)
    if bt in ("attn", "attn_moe", "shared_attn"):
        if bt == "shared_attn":
            y, (k, v) = attn.attend_prefill(_shared_attn_cfg(cfg), bp.attn,
                                            _shared_in(cfg, bp, h, emb0))
        else:
            y, (k, v) = attn.attend_prefill(cfg, bp.attn, napply(bp.ln1, h))
        h = h + y
        h = h + _ffn(cfg, bt, bp, napply(bp.ln2, h))
        s = k.shape[1]
        c["k"][:, :s], c["v"][:, :s] = k, v
        return h
    if bt == "mamba":
        y, cn = mb.apply_mamba(cfg, bp.mamba, napply(bp.ln, h), return_cache=True)
        c.update(cn)
        return h + y
    if bt == "rwkv":
        x1 = napply(bp.ln1, h)
        y1, c["tm_prev"], c["wkv"] = rwkv_mod.rwkv_timemix_prefill(cfg, bp.rwkv, x1)
        h = h + y1
        x2 = napply(bp.ln2, h)
        c["cm_prev"] = x2[:, -1:, :]
        return h + rwkv_mod.apply_rwkv_channelmix(cfg, bp.rwkv, x2)
    raise ValueError(bt)


def prefill(spec: LMSpec, params: Params, tokens: torch.Tensor, s_max: int):
    """Run the prompt (B, S); return (last-position logits (B, V_padded), cache)."""
    cfg = spec.cfg
    _, napply = cm.make_norm(cfg, cfg.d_model)
    s = tokens.shape[1]
    if s > s_max:
        raise ValueError(f"prompt of {s} tokens does not fit s_max={s_max}")
    cache = init_cache(spec, tokens.shape[0], s_max, device=tokens.device)
    h = _embed_tokens(cfg, params, tokens)
    emb0 = h if spec.has_shared_attn else None
    for (bt, bp), c in zip(_walk(spec, params), cache["layers"], strict=True):
        h = _apply_block_prefill(cfg, bt, bp, h, c, emb0)
    h = napply(params.final_norm, h[:, -1:, :])
    logits = _unembed(cfg, params, h)
    cache["pos"] = s
    return logits[:, 0], cache


def _apply_block_decode(cfg: ArchConfig, bt: str, bp: Params, h, c: dict, pos: int, emb0):
    _, napply = cm.make_norm(cfg, cfg.d_model)
    if bt in ("attn", "attn_moe", "shared_attn"):
        if bt == "shared_attn":
            y, (k, v) = attn.attend_decode(_shared_attn_cfg(cfg), bp.attn,
                                           _shared_in(cfg, bp, h, emb0), (c["k"], c["v"]), pos)
        else:
            y, (k, v) = attn.attend_decode(cfg, bp.attn, napply(bp.ln1, h), (c["k"], c["v"]),
                                           pos)
        h = h + y
        h = h + _ffn(cfg, bt, bp, napply(bp.ln2, h))
        return h, {"k": k, "v": v}
    if bt == "mamba":
        y, cn = mb.apply_mamba_decode(cfg, bp.mamba, napply(bp.ln, h), c)
        return h + y, cn
    if bt == "rwkv":
        x1 = napply(bp.ln1, h)
        y1, cn = rwkv_mod.apply_rwkv_timemix_decode(cfg, bp.rwkv, x1, c)
        h = h + y1
        x2 = napply(bp.ln2, h)
        y2, cn = rwkv_mod.apply_rwkv_channelmix_decode(cfg, bp.rwkv, x2, cn)
        return h + y2, cn
    raise ValueError(bt)


def decode_step(spec: LMSpec, params: Params, token: torch.Tensor, cache: dict):
    """One decode step.  token (B,) int -> (logits (B, V_padded), cache)."""
    cfg = spec.cfg
    _, napply = cm.make_norm(cfg, cfg.d_model)
    pos = cache["pos"]
    s_max = _kv_len(cache)
    if s_max is not None and pos >= s_max:
        raise ValueError(f"decode position {pos} is past the KV cache (s_max={s_max})")
    h = _embed_tokens(cfg, params, token[:, None])
    emb0 = h if spec.has_shared_attn else None
    layers = []
    for (bt, bp), c in zip(_walk(spec, params), cache["layers"], strict=True):
        h, cn = _apply_block_decode(cfg, bt, bp, h, c, pos, emb0)
        layers.append(cn)
    h = napply(params.final_norm, h)
    logits = _unembed(cfg, params, h)[:, 0]
    return logits, {"layers": layers, "pos": pos + 1}


def _kv_len(cache: dict) -> int | None:
    """The KV caches' S_max; None for a model without KV caches."""
    for c in cache["layers"]:
        if "k" in c:
            return c["k"].shape[1]
    return None
