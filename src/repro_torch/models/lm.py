"""The LM stack for serving: prefill and decode for the dense and RWKV6 families.

Port of :mod:`repro.models.lm`.  A model is a sequence of groups, each a
tuple of block types repeated ``count`` times; the JAX package stacks each
group's layers and scans over them, the port keeps one parameter container
per layer in ``params.blocks`` (in execution order) and loops.

  dense   [("attn",) x L]
  rwkv6   [("rwkv",) x L]

Entry points: :func:`init_params`, :func:`init_cache`, :func:`prefill` and
:func:`decode_step`.  The other families (moe, llama4, mamba2, the zamba2
hybrid, encoder-decoder, vlm) and the training loss wait for later slices of
the port (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.common import ArchConfig, Params


@dataclass(frozen=True)
class GroupSpec:
    block_types: tuple[str, ...]
    count: int


@dataclass(frozen=True)
class LMSpec:
    cfg: ArchConfig
    groups: tuple[GroupSpec, ...]

    def layers(self) -> list[str]:
        """The block type of every block, in execution order."""
        return [bt for g in self.groups for _ in range(g.count) for bt in g.block_types]


def build_spec(cfg: ArchConfig) -> LMSpec:
    if cfg.family == "ssm" and cfg.rwkv:
        return LMSpec(cfg=cfg, groups=(GroupSpec(("rwkv",), cfg.n_layers),))
    if cfg.family == "dense":
        return LMSpec(cfg=cfg, groups=(GroupSpec(("attn",), cfg.n_layers),))
    raise NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported to repro_torch yet "
        f"(ROADMAP.md, Queue 1); ported: dense, ssm with rwkv")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_block(cfg: ArchConfig, bt: str, gen: torch.Generator, device=None) -> Params:
    ninit, _ = cm.make_norm(cfg, cfg.d_model)
    if bt == "attn":
        return Params(ln1=ninit(device), attn=attn.init_attention(cfg, gen, device=device),
                      ln2=ninit(device), mlp=mlp_mod.init_mlp(cfg, gen, device=device))
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
    blocks = nn.ModuleList(init_block(cfg, bt, gen, dev) for bt in spec.layers())
    return Params(t, final_norm=ninit(dev), blocks=blocks)


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


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
    """Decode caches, one dict per layer, and the next position."""
    cfg = spec.cfg
    dt = cfg.cdtype
    layers = []
    for bt in spec.layers():
        if bt == "attn":
            shape = (batch, s_max, cfg.n_kv_heads, cfg.hd)
            layers.append({"k": torch.zeros(shape, dtype=dt, device=device),
                           "v": torch.zeros(shape, dtype=dt, device=device)})
        elif bt == "rwkv":
            layers.append(rwkv_mod.rwkv_cache_init(cfg, batch, dt, device=device))
        else:
            raise ValueError(bt)
    return {"layers": layers, "pos": 0}


def _apply_block_prefill(cfg: ArchConfig, bt: str, bp: Params, h, c: dict):
    """One block over the prompt; fills the block's decode cache ``c`` in place."""
    _, napply = cm.make_norm(cfg, cfg.d_model)
    if bt == "attn":
        y, (k, v) = attn.attend_prefill(cfg, bp.attn, napply(bp.ln1, h))
        h = h + y
        h = h + mlp_mod.apply_mlp(cfg, bp.mlp, napply(bp.ln2, h))
        s = k.shape[1]
        c["k"][:, :s], c["v"][:, :s] = k, v
        return h
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
    for bt, bp, c in zip(spec.layers(), params.blocks, cache["layers"], strict=True):
        h = _apply_block_prefill(cfg, bt, bp, h, c)
    h = napply(params.final_norm, h[:, -1:, :])
    logits = _unembed(cfg, params, h)
    cache["pos"] = s
    return logits[:, 0], cache


def _apply_block_decode(cfg: ArchConfig, bt: str, bp: Params, h, c: dict, pos: int):
    _, napply = cm.make_norm(cfg, cfg.d_model)
    if bt == "attn":
        y, (k, v) = attn.attend_decode(cfg, bp.attn, napply(bp.ln1, h), (c["k"], c["v"]), pos)
        h = h + y
        h = h + mlp_mod.apply_mlp(cfg, bp.mlp, napply(bp.ln2, h))
        return h, {"k": k, "v": v}
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
    layers = []
    for bt, bp, c in zip(spec.layers(), params.blocks, cache["layers"], strict=True):
        h, cn = _apply_block_decode(cfg, bt, bp, h, c, pos)
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
