"""The LM stack: the training loss, prefill and decode for every family.

Port of :mod:`repro.models.lm`.  A model is a sequence of groups, each a
tuple of block types repeated ``count`` times; the JAX package stacks each
group's layers and scans over them, the port keeps one parameter container
per layer in ``params.blocks`` (in execution order) and loops.

  dense / vlm      [("attn",) x L]
  moe (granite)    [("attn_moe",) x L]
  llama4           [("attn", "attn_moe") x L/2]   (d_ff 2x on the dense layers)
  rwkv6            [("rwkv",) x L]
  zamba2 (hybrid)  [("mamba" x 6, "shared_attn") x 13] + [("mamba",) x 3]
  seamless (encdec) enc: [("enc",) x 12] in ``params.enc_blocks``;
                   dec: [("dec",) x 12]

The shared attention block's parameters are stored once, at
``params.shared_attn``, and are not in ``params.blocks``; each of its
invocations has its own KV cache.  Its input is concat(h, emb0), the hidden
state beside the token embeddings, normed at width 2 * d_model.  The
encoder reads frame embeddings (B, T, d_model); each decoder block attends
causally to itself, then across to the encoder's output (its K/V computed
once at prefill and kept in the cache), then runs its MLP.

Entry points: :func:`loss_fn` (train), :func:`init_params`,
:func:`init_cache`, :func:`prefill` and :func:`decode_step` (serve); the MoE
aux losses are dropped on the serve path, as the JAX prefill and decode
drop them.  Training holds the parameters as the JAX package's tree, each
group's layers stacked (:func:`params_tree`); :func:`params_view` gives the
forward per-layer views of the stacks, so one gradient reaches each stack.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from types import SimpleNamespace
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mamba2 as mb
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.common import ArchConfig, Params
from repro_torch.tree import tree_leaves, tree_map


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
    enc_groups: tuple[GroupSpec, ...] = ()

    @property
    def is_encdec(self) -> bool:
        return bool(self.enc_groups)

    @property
    def has_shared_attn(self) -> bool:
        return any("shared_attn" in g.block_types for g in self.groups)

    def layers(self) -> list[str]:
        """The block type of every (decoder) block, in execution order."""
        return _layers(self.groups)

    def enc_layers(self) -> list[str]:
        """The block type of every encoder block, in execution order."""
        return _layers(self.enc_groups)


def _layers(groups) -> list[str]:
    return [bt for g in groups for _ in range(g.count) for bt in g.block_types]


def build_spec(cfg: ArchConfig) -> LMSpec:
    if cfg.family == "encdec":
        return LMSpec(cfg=cfg, groups=(GroupSpec(("dec",), cfg.dec_layers),),
                      enc_groups=(GroupSpec(("enc",), cfg.enc_layers),))
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
        f"family {cfg.family!r} ({cfg.name}) has no block layout; known: dense, vlm, moe, "
        f"hybrid, encdec, ssm with rwkv")


def _shared_attn_cfg(cfg: ArchConfig) -> ArchConfig:
    """Zamba's shared block attends over concat(h, emb0): d_in = 2 * d_model."""
    return cfg.replace(head_dim=2 * cfg.d_model // cfg.n_heads, qk_norm=False, qkv_bias=False)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_block(cfg: ArchConfig, bt: str, gen: torch.Generator, ov: dict, device=None) -> Params:
    """One block's parameters; ``ov`` is its group's override (llama4's d_ff)."""
    ninit, _ = cm.make_norm(cfg, cfg.d_model)
    if bt in ("attn", "enc"):
        return Params(ln1=ninit(device), attn=attn.init_attention(cfg, gen, device=device),
                      ln2=ninit(device),
                      mlp=mlp_mod.init_mlp(cfg, gen, d_ff=ov.get("d_ff"), device=device))
    if bt == "dec":
        return Params(ln1=ninit(device), attn=attn.init_attention(cfg, gen, device=device),
                      lnx=ninit(device), xattn=attn.init_attention(cfg, gen, device=device),
                      ln2=ninit(device), mlp=mlp_mod.init_mlp(cfg, gen, device=device))
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
    """Random weights from a ``torch.Generator`` seeded with ``seed``, made on ``device``.

    On ``"meta"`` (the dry run) there is no generator: the same tree of the
    same shapes and dtypes is made with ``torch.empty`` and nothing is drawn.
    """
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    cfg = spec.cfg
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    ninit, _ = cm.make_norm(cfg, cfg.d_model)
    t = {"embed": cm.embed_init(gen, (cfg.vocab_padded, cfg.d_model), cfg.pdtype, device=dev)}
    if not cfg.tie_embeddings:
        t["lm_head"] = cm.dense_init(gen, (cfg.d_model, cfg.vocab_padded), cfg.pdtype,
                                     device=dev)

    def blocks(groups):
        return nn.ModuleList(
            init_block(cfg, bt, gen, g.override(bt), dev)
            for g in groups for _ in range(g.count) for bt in g.block_types
            if bt != "shared_attn")

    children = {"final_norm": ninit(dev), "blocks": blocks(spec.groups)}
    if spec.is_encdec:
        children["enc_blocks"] = blocks(spec.enc_groups)
        children["enc_final_norm"] = ninit(dev)
    if spec.has_shared_attn:
        scfg = _shared_attn_cfg(cfg)
        sn, _ = cm.make_norm(cfg, 2 * cfg.d_model)
        children["shared_attn"] = Params(
            ln=sn(dev), attn=attn.init_attention(scfg, gen, d_in=2 * cfg.d_model, device=dev),
            ln2=ninit(dev), mlp=mlp_mod.init_mlp(cfg, gen, device=dev))  # the block's FFN (d_ff)
    return Params(t, **children)


# ---------------------------------------------------------------------------
# logical axes of the parameters and caches (the sharding rules' input)
# ---------------------------------------------------------------------------


def block_axes(cfg: ArchConfig, bt: str) -> dict:
    """Logical axes of one block's parameters (:func:`init_block`'s tree)."""
    nx = cm.norm_axes(cfg)
    if bt in ("attn", "enc"):
        return {"ln1": nx, "attn": attn.attention_axes(cfg), "ln2": nx,
                "mlp": mlp_mod.mlp_axes(cfg)}
    if bt == "attn_moe":
        return {"ln1": nx, "attn": attn.attention_axes(cfg), "ln2": nx,
                "moe": moe_mod.moe_axes(cfg)}
    if bt == "mamba":
        return {"ln": nx, "mamba": mb.mamba_axes(cfg)}
    if bt == "rwkv":
        return {"ln1": nx, "ln2": nx, "rwkv": rwkv_mod.rwkv_axes(cfg)}
    if bt == "dec":
        return {"ln1": nx, "attn": attn.attention_axes(cfg), "lnx": nx,
                "xattn": attn.attention_axes(cfg), "ln2": nx, "mlp": mlp_mod.mlp_axes(cfg)}
    raise ValueError(bt)


def _top_axes(spec: LMSpec) -> dict:
    """The axes of the parameters outside the blocks."""
    cfg = spec.cfg
    nx = cm.norm_axes(cfg)
    axes: dict[str, Any] = {"embed": ("vocab", "embed_d"), "final_norm": nx}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed_d", "vocab")
    if spec.is_encdec:
        axes["enc_final_norm"] = nx
    if spec.has_shared_attn:
        axes["shared_attn"] = {"ln": nx, "attn": attn.attention_axes(_shared_attn_cfg(cfg)),
                               "ln2": nx, "mlp": mlp_mod.mlp_axes(cfg)}
    return axes


def params_tree_axes(spec: LMSpec) -> dict:
    """Logical axes of :func:`params_tree`'s layout (the training state): each
    group's block entries stacked behind a ``layers`` axis, the JAX package's
    ``lm.param_axes`` leaf for leaf."""
    cfg = spec.cfg
    axes = _top_axes(spec)

    def groups(gspecs):
        return [{str(bi): cm.stacked_axes(block_axes(cfg, bt))
                 for bi, bt in enumerate(g.block_types) if bt != "shared_attn"}
                for g in gspecs]

    axes["groups"] = groups(spec.groups)
    if spec.is_encdec:
        axes["enc_groups"] = groups(spec.enc_groups)
    return axes


def param_axes(spec: LMSpec) -> dict:
    """Logical axes of :func:`init_params`' tree: :func:`params_tree_axes`
    with each group unstacked into ``blocks`` (and ``enc_blocks``), one
    entry a layer, each leaf without its leading ``layers`` entry (the port
    keeps one container a layer), so ``cm.named_leaves(param_axes(spec))``
    has the module's ``named_parameters`` names."""
    tree = params_tree_axes(spec)
    axes = {k: v for k, v in tree.items() if k not in ("groups", "enc_groups")}

    def blocks(gtrees, gspecs):
        return [cm.map_axes(lambda ax: ax[1:], gt[str(bi)])
                for gt, g in zip(gtrees, gspecs, strict=True) for _ in range(g.count)
                for bi, bt in enumerate(g.block_types) if bt != "shared_attn"]

    axes["blocks"] = blocks(tree["groups"], spec.groups)
    if spec.is_encdec:
        axes["enc_blocks"] = blocks(tree["enc_groups"], spec.enc_groups)
    return axes


def param_specs(spec: LMSpec, rules) -> dict:
    """:func:`param_axes` mapped to :class:`~repro_torch.models.common.Spec` by ``rules``."""
    return cm.tree_specs(param_axes(spec), rules)


def cache_axes(spec: LMSpec) -> dict:
    """Logical axes of :func:`init_cache`'s tree (``kv_seq`` over ``model`` =
    flash-decode): ``layers`` one entry per block, each shared-block
    invocation its own; each leaf the JAX package's ``lm.cache_axes`` leaf
    without its leading ``layers`` entry.  ``pos`` is a host int here (a
    0-dim int32 in the JAX cache)."""
    layers = []
    for bt in spec.layers():
        if bt in ("attn", "attn_moe", "dec", "shared_attn"):
            kv = ("batch", "kv_seq", "kv_heads", "head_dim")
            e = {"k": kv, "v": kv}
            if bt == "dec":
                e["xk"] = ("batch", None, "kv_heads", "head_dim")
                e["xv"] = ("batch", None, "kv_heads", "head_dim")
        elif bt == "mamba":
            e = {"conv": ("batch", None, "inner"), "ssm": ("batch", "inner", None, None)}
        elif bt == "rwkv":
            e = {"tm_prev": ("batch", None, "embed"), "cm_prev": ("batch", None, "embed"),
                 "wkv": ("batch", "inner", None, None)}
        else:
            raise ValueError(bt)
        layers.append(e)
    return {"layers": layers, "pos": ()}


def param_count(params) -> int:
    """Parameters of a :class:`Params` module or of a :func:`params_tree`."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    return sum(x.numel() for x in tree_leaves(params))


def _walk(spec: LMSpec, params):
    """(block type, its parameters) of every decoder block in execution order;
    the shared block's are ``params.shared_attn`` at each invocation."""
    blocks = iter(params.blocks)
    for bt in spec.layers():
        yield bt, (params.shared_attn if bt == "shared_attn" else next(blocks))


def _walk_enc(spec: LMSpec, params):
    return zip(spec.enc_layers(), params.enc_blocks, strict=True)


# ---------------------------------------------------------------------------
# the JAX package's parameter tree: each group's layers stacked
# ---------------------------------------------------------------------------


def _module_tree(mod: nn.Module) -> dict:
    """A module's parameters as nested dicts (names as the JAX package's keys)."""
    out = dict(mod._parameters)
    out.update({name: _module_tree(child) for name, child in mod._modules.items()})
    return out


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack([t.detach() for t in trees])


def params_tree(spec: LMSpec, params: Params) -> dict:
    """``params`` in the layout of the JAX package's ``lm.init_params``:
    ``embed``, ``final_norm``, ``lm_head`` unless tied, ``groups`` (a list with
    one dict per group, its block entries stacked on a leading ``(count,
    ...)`` axis; a shared block's position has no entry), and for an
    encoder-decoder ``enc_groups`` and ``enc_final_norm``, for a hybrid
    ``shared_attn``.  New tensors, detached; dtypes kept."""
    def groups(gspecs, blocks):
        it = iter(blocks)
        out = []
        for g in gspecs:
            kept = [bi for bi, bt in enumerate(g.block_types) if bt != "shared_attn"]
            if g.count == 0:  # stacks of no layers: one block's shapes on a zero axis
                one = {bi: _module_tree(init_block(spec.cfg, g.block_types[bi],
                                                   torch.Generator().manual_seed(0),
                                                   g.override(g.block_types[bi]), "cpu"))
                       for bi in kept}
                out.append({str(bi): tree_map(lambda t: t.new_empty((0, *t.shape)).to(
                    params.embed.device), one[bi]) for bi in kept})
                continue
            layers = [{bi: _module_tree(next(it)) for bi in kept} for _ in range(g.count)]
            out.append({str(bi): _stack([layer[bi] for layer in layers]) for bi in kept})
        return out

    def copy(mod):
        return tree_map(lambda t: t.detach().clone(), _module_tree(mod))

    tree = {"embed": params.embed.detach().clone(), "final_norm": copy(params.final_norm),
            "groups": groups(spec.groups, params.blocks)}
    if not spec.cfg.tie_embeddings:
        tree["lm_head"] = params.lm_head.detach().clone()
    if spec.is_encdec:
        tree["enc_groups"] = groups(spec.enc_groups, params.enc_blocks)
        tree["enc_final_norm"] = copy(params.enc_final_norm)
    if spec.has_shared_attn:
        tree["shared_attn"] = copy(params.shared_attn)
    return tree


def _unstack(tree, count: int) -> list:
    """A stacked tree -> ``count`` trees of views (``unbind``: one backward
    stacks the layers' gradients)."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, count) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(count)]
    return list(tree.unbind(0))


def _namespace(tree):
    if isinstance(tree, dict):
        return SimpleNamespace(**{k: _namespace(v) for k, v in tree.items()})
    return tree


def params_view(spec: LMSpec, tree: dict) -> SimpleNamespace:
    """The model's parameters (``params.blocks``, ``params.embed``, ...) as
    views of a :func:`params_tree`: every layer's tensors are ``unbind``
    views of its group's stacks, so a gradient through the view reaches the
    stacks, one stacked gradient per leaf."""
    def blocks(gspecs, gtrees):
        out = []
        for g, gp in zip(gspecs, gtrees, strict=True):
            per = {bi: _unstack(gp[str(bi)], g.count) for bi, bt in enumerate(g.block_types)
                   if bt != "shared_attn"}
            out += [_namespace(per[bi][layer]) for layer in range(g.count) for bi in per]
        return out

    view = {k: tree[k] for k in ("embed", "lm_head", "final_norm", "enc_final_norm",
                                 "shared_attn") if k in tree}
    ns = _namespace(view)
    ns.blocks = blocks(spec.groups, tree["groups"])
    if spec.is_encdec:
        ns.enc_blocks = blocks(spec.enc_groups, tree["enc_groups"])
    return ns


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
# the full-sequence forward (training, the encoder) and the loss
# ---------------------------------------------------------------------------


def _shared_in(cfg: ArchConfig, bp, h, emb0):
    """The shared block's attention input: concat(h, emb0) normed at 2 * d_model."""
    _, napply2 = cm.make_norm(cfg, 2 * cfg.d_model)
    return napply2(bp.ln, torch.cat([h, emb0], dim=-1))


def _apply_block_train(cfg: ArchConfig, bt: str, bp, h, *, emb0=None, enc_out=None):
    """One block over a whole sequence: (h, the MoE layer's aux losses or None)."""
    _, napply = cm.make_norm(cfg, cfg.d_model)
    if bt in ("attn", "enc"):
        h = h + attn.attend_train(cfg, bp.attn, napply(bp.ln1, h), causal=bt == "attn")
        return h + mlp_mod.apply_mlp(cfg, bp.mlp, napply(bp.ln2, h)), None
    if bt == "attn_moe":
        h = h + attn.attend_train(cfg, bp.attn, napply(bp.ln1, h))
        y, aux = moe_mod.apply_moe(cfg, bp.moe, napply(bp.ln2, h))
        return h + y, aux
    if bt == "mamba":
        return h + mb.apply_mamba(cfg, bp.mamba, napply(bp.ln, h)), None
    if bt == "rwkv":
        h = h + rwkv_mod.apply_rwkv_timemix(cfg, bp.rwkv, napply(bp.ln1, h))
        return h + rwkv_mod.apply_rwkv_channelmix(cfg, bp.rwkv, napply(bp.ln2, h)), None
    if bt == "shared_attn":
        h = h + attn.attend_train(_shared_attn_cfg(cfg), bp.attn, _shared_in(cfg, bp, h, emb0))
        return h + mlp_mod.apply_mlp(cfg, bp.mlp, napply(bp.ln2, h)), None
    if bt == "dec":
        h = h + attn.attend_train(cfg, bp.attn, napply(bp.ln1, h))
        kv = attn.project_kv(cfg, bp.xattn, enc_out)
        h = h + attn.attend_train(cfg, bp.xattn, napply(bp.lnx, h), causal=False,
                                  kv_override=kv)
        return h + mlp_mod.apply_mlp(cfg, bp.mlp, napply(bp.ln2, h)), None
    raise ValueError(bt)


def _run_blocks_train(cfg: ArchConfig, blocks, h, *, emb0=None, enc_out=None):
    """Every block of ``blocks`` ((type, params) pairs) over the sequence;
    returns (h, {"lb_loss", "z_loss"}, summed over the MoE layers).  With
    ``cfg.remat`` and a gradient wanted, each block is checkpointed
    (``torch.utils.checkpoint``): its activations are recomputed in the
    backward, as ``jax.checkpoint`` on the JAX package's scanned body."""
    lb = torch.zeros((), dtype=torch.float32, device=h.device)
    z = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for bt, bp in blocks:
        fn = partial(_apply_block_train, cfg, bt, bp, emb0=emb0, enc_out=enc_out)
        h, aux = checkpoint(fn, h, use_reentrant=False) if remat else fn(h)
        if aux is not None:
            lb, z = lb + aux["lb_loss"], z + aux["z_loss"]
    return h, {"lb_loss": lb, "z_loss": z}


def encode(spec: LMSpec, params, frames: torch.Tensor) -> torch.Tensor:
    """The encoder over frame embeddings (B, T, d_model), final norm applied."""
    cfg = spec.cfg
    _, napply = cm.make_norm(cfg, cfg.d_model)
    enc, _ = _run_blocks_train(cfg, _walk_enc(spec, params), frames.to(cfg.cdtype))
    return napply(params.enc_final_norm, enc)


def _chunk_loss(cfg: ArchConfig, params, hh, ll):
    """Summed cross-entropy of one sequence chunk (its logits in fp32)."""
    logits = _unembed(cfg, params, hh).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, ll[..., None])[..., 0]
    return torch.sum(lse - gold)


def _chunked_xent(cfg: ArchConfig, params, h, labels):
    """Mean cross-entropy without the whole (B, S, vocab) logits: sequence
    chunks of ``min(vocab_chunk, S)`` halved until it divides S, each
    checkpointed under remat (its logits recomputed in the backward)."""
    b, s, _ = h.shape
    ck = min(cfg.vocab_chunk, s)
    while s % ck:
        ck //= 2
    remat = cfg.remat and torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, ck):
        args = (cfg, params, h[:, c0 : c0 + ck], labels[:, c0 : c0 + ck])
        total = total + (checkpoint(_chunk_loss, *args, use_reentrant=False) if remat
                         else _chunk_loss(*args))
    return total / (b * s)


def loss_fn(spec: LMSpec, params, batch: dict):
    """(loss, metrics) of a batch: tokens (B, S) and labels (B, S) int64 tensors
    [+ frames (B, T, d_model) for an encoder-decoder].

    ``params`` is a :class:`Params` module or a :func:`params_view`.  The loss
    is ``xent + 0.01 * lb_loss + 0.001 * z_loss`` (the MoE aux losses, 0
    without MoE layers); metrics hold ``xent``, ``lb_loss`` and ``z_loss``.
    """
    cfg = spec.cfg
    enc_out = encode(spec, params, batch["frames"]) if spec.is_encdec else None
    h = _embed_tokens(cfg, params, batch["tokens"])
    emb0 = h if spec.has_shared_attn else None
    h, aux = _run_blocks_train(cfg, _walk(spec, params), h, emb0=emb0, enc_out=enc_out)
    _, napply = cm.make_norm(cfg, cfg.d_model)
    xent = _chunked_xent(cfg, params, napply(params.final_norm, h), batch["labels"])
    loss = xent + 0.01 * aux["lb_loss"] + 0.001 * aux["z_loss"]
    return loss, {"xent": xent, **aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(spec: LMSpec, batch: int, s_max: int, device="cuda", *, enc_len: int = 0) -> dict:
    """Decode caches, one dict per block (each shared-block invocation its
    own), and the next position.  A decoder block of an encoder-decoder also
    holds the cross-attention's K/V over ``enc_len`` encoder positions."""
    cfg = spec.cfg
    dt = cfg.cdtype
    layers = []
    for bt in spec.layers():
        if bt in ("attn", "attn_moe", "shared_attn", "dec"):
            acfg = _shared_attn_cfg(cfg) if bt == "shared_attn" else cfg
            shape = (batch, s_max, acfg.n_kv_heads, acfg.hd)
            c = {"k": torch.zeros(shape, dtype=dt, device=device),
                 "v": torch.zeros(shape, dtype=dt, device=device)}
            if bt == "dec":
                xshape = (batch, enc_len, cfg.n_kv_heads, cfg.hd)
                c["xk"] = torch.zeros(xshape, dtype=dt, device=device)
                c["xv"] = torch.zeros(xshape, dtype=dt, device=device)
            layers.append(c)
        elif bt == "mamba":
            layers.append(mb.mamba_cache_init(cfg, batch, dt, device=device))
        elif bt == "rwkv":
            layers.append(rwkv_mod.rwkv_cache_init(cfg, batch, dt, device=device))
        else:
            raise ValueError(bt)
    return {"layers": layers, "pos": 0}


def _ffn(cfg: ArchConfig, bt: str, bp: Params, x):
    """The block's second half: the MLP, or the MoE layer (its aux dropped)."""
    if bt == "attn_moe":
        return moe_mod.moe_forward(cfg, bp.moe, x)[0]
    return mlp_mod.apply_mlp(cfg, bp.mlp, x)


def _apply_block_prefill(cfg: ArchConfig, bt: str, bp: Params, h, c: dict, emb0, enc_out=None):
    """One block over the prompt; fills the block's decode cache ``c`` in place."""
    _, napply = cm.make_norm(cfg, cfg.d_model)
    if bt in ("attn", "attn_moe", "shared_attn", "dec"):
        if bt == "shared_attn":
            y, (k, v) = attn.attend_prefill(_shared_attn_cfg(cfg), bp.attn,
                                            _shared_in(cfg, bp, h, emb0))
        else:
            y, (k, v) = attn.attend_prefill(cfg, bp.attn, napply(bp.ln1, h))
        h = h + y
        if bt == "dec":
            c["xk"][:], c["xv"][:] = attn.project_kv(cfg, bp.xattn, enc_out)
            h = h + attn.attend_train(cfg, bp.xattn, napply(bp.lnx, h), causal=False,
                                      kv_override=(c["xk"], c["xv"]))
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


def prefill(spec: LMSpec, params: Params, tokens: torch.Tensor, s_max: int, *, frames=None):
    """Run the prompt (B, S) [and, for an encoder-decoder, the encoder over
    ``frames`` (B, T, d_model)]; return (last-position logits (B, V_padded),
    cache)."""
    cfg = spec.cfg
    _, napply = cm.make_norm(cfg, cfg.d_model)
    s = tokens.shape[1]
    if s > s_max:
        raise ValueError(f"prompt of {s} tokens does not fit s_max={s_max}")
    if spec.is_encdec != (frames is not None):
        raise ValueError(f"{cfg.name}: frames are the encoder's input and only an "
                         f"encoder-decoder takes them")
    enc_out = encode(spec, params, frames) if spec.is_encdec else None
    cache = init_cache(spec, tokens.shape[0], s_max, device=tokens.device,
                       enc_len=0 if enc_out is None else enc_out.shape[1])
    h = _embed_tokens(cfg, params, tokens)
    emb0 = h if spec.has_shared_attn else None
    for (bt, bp), c in zip(_walk(spec, params), cache["layers"], strict=True):
        h = _apply_block_prefill(cfg, bt, bp, h, c, emb0, enc_out)
    h = napply(params.final_norm, h[:, -1:, :])
    logits = _unembed(cfg, params, h)
    cache["pos"] = s
    if enc_out is not None:
        cache["enc_out"] = enc_out
    return logits[:, 0], cache


def _apply_block_decode(cfg: ArchConfig, bt: str, bp: Params, h, c: dict, pos: int, emb0):
    _, napply = cm.make_norm(cfg, cfg.d_model)
    if bt in ("attn", "attn_moe", "shared_attn", "dec"):
        if bt == "shared_attn":
            y, (k, v) = attn.attend_decode(_shared_attn_cfg(cfg), bp.attn,
                                           _shared_in(cfg, bp, h, emb0), (c["k"], c["v"]), pos)
        else:
            y, (k, v) = attn.attend_decode(cfg, bp.attn, napply(bp.ln1, h), (c["k"], c["v"]),
                                           pos)
        h = h + y
        if bt == "dec":
            h = h + attn.cross_attend_decode(cfg, bp.xattn, napply(bp.lnx, h),
                                             (c["xk"], c["xv"]), pos)
        h = h + _ffn(cfg, bt, bp, napply(bp.ln2, h))
        return h, {**c, "k": k, "v": v}
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
    return logits, {**cache, "layers": layers, "pos": pos + 1}


def _kv_len(cache: dict) -> int | None:
    """The KV caches' S_max; None for a model without KV caches."""
    for c in cache["layers"]:
        if "k" in c:
            return c["k"].shape[1]
    return None
