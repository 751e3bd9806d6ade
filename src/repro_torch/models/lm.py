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

On a device grid -- ``rules`` carrying one (``cm.attach_axis_sizes``) --
``loss_fn``, ``init_cache``, ``prefill`` and ``decode_step`` run every
family in lockstep over the tiles: parameters, batch, cache and outputs
are per-tile values
(:class:`~repro_torch.core.collectives.Sharded`, parameters as
:func:`grid_view` gives them) laid out by the rules, the blocks' per-tile
code is the single-device code, and the collectives between them are
counted.  The embedding and the loss work over vocab shards: each tile
looks up the ids in its range and the tiles' rows are summed in order; the
loss is a distributed log-sum-exp (the max, then the sum over the vocab
shards).  An MoE layer runs the JAX ``apply_moe``'s mesh branches
(``moe.apply_moe_grid``): its output, and so the model's, depends on the
grid through the capacity per batch shard.  RWKV6 and Mamba2 split their
heads over ``inner``'s axes (``rwkv6.apply_rwkv_timemix_grid``,
``mamba2.apply_mamba_grid``) and run on the whole sequence of their batch
rows, gathered where the rules split it; zamba2's shared block runs the
grid attention at width 2 * d_model, its one parameter set laid out at
each invocation (so every invocation's gradient reaches it); an
encoder-decoder encodes its frames laid out by ``(batch, seq, embed)`` and
cross-attends with each tile's q heads over every KV head
(``attention.cross_attend_train_grid``).  The caches follow
:func:`cache_axes`.  A 1x1 grid in ``rules`` is no grid: every family runs
the single-device code on single-device values.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from types import SimpleNamespace
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import collectives as coll
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
    if isinstance(tree, list) and not isinstance(tree, coll.Sharded):
        return [_namespace(v) for v in tree]
    return tree


def _per_layer(spec: LMSpec, tree: dict, unstack=_unstack) -> dict:
    """A :func:`params_tree` (or a tree of its layout) in :func:`param_axes`'
    layout: the top entries as they are, ``blocks`` (and ``enc_blocks``) one
    dict a layer; ``unstack(stacked subtree, count)`` gives the per-layer
    subtrees."""
    def blocks(gspecs, gtrees):
        out = []
        for g, gp in zip(gspecs, gtrees, strict=True):
            per = {bi: unstack(gp[str(bi)], g.count) for bi, bt in enumerate(g.block_types)
                   if bt != "shared_attn"}
            out += [per[bi][layer] for layer in range(g.count) for bi in per]
        return out

    out = {k: tree[k] for k in ("embed", "lm_head", "final_norm", "enc_final_norm",
                                "shared_attn") if k in tree}
    out["blocks"] = blocks(spec.groups, tree["groups"])
    if spec.is_encdec:
        out["enc_blocks"] = blocks(spec.enc_groups, tree["enc_groups"])
    return out


def params_view(spec: LMSpec, tree: dict) -> SimpleNamespace:
    """The model's parameters (``params.blocks``, ``params.embed``, ...) as
    views of a :func:`params_tree`: every layer's tensors are ``unbind``
    views of its group's stacks, so a gradient through the view reaches the
    stacks, one stacked gradient per leaf."""
    return _namespace(_per_layer(spec, tree))


def _unstack_specs(tree, count: int) -> list:
    return [cm.map_axes(lambda s: cm.Spec(*tuple(s)[1:]), tree)] * count


def param_dict(params: Params) -> dict:
    """A :class:`Params` module as nested dicts in :func:`param_axes`' layout
    (``blocks`` a list), its own tensors."""
    out = _module_tree(params)
    for k in ("blocks", "enc_blocks"):
        if k in out:
            out[k] = [out[k][str(i)] for i in range(len(out[k]))]
    return out


def grid_view(spec: LMSpec, tiles: list, specs, grid, *, stacked: bool = True):
    """The grid forward's parameters: per-tile trees (tile order) and their
    sanitized specs as one namespace tree (``params.blocks``, ...) whose
    leaves are :class:`~repro_torch.core.collectives.Sharded`.  With
    ``stacked`` the trees are :func:`params_tree`'s layout (the training
    state; each layer a view of its tile's stacks), else :func:`param_dict`'s."""
    if stacked:
        tiles = [_per_layer(spec, t) for t in tiles]
        specs = _per_layer(spec, specs, _unstack_specs)
    return _namespace(cm.sharded_tree(tiles, specs, grid))


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


def loss_fn(spec: LMSpec, params, batch: dict, *, rules=None):
    """(loss, metrics) of a batch: tokens (B, S) and labels (B, S) int64 tensors
    [+ frames (B, T, d_model) for an encoder-decoder].

    ``params`` is a :class:`Params` module or a :func:`params_view`.  The loss
    is ``xent + 0.01 * lb_loss + 0.001 * z_loss`` (the MoE aux losses, 0
    without MoE layers); metrics hold ``xent``, ``lb_loss`` and ``z_loss``.

    With a grid in ``rules``: ``params`` from :func:`grid_view`, the batch's
    tokens and labels per-tile values laid out by ``(batch, seq)`` (frames
    by ``(batch, seq, embed)``); the loss
    and metrics come back as per-tile lists, the same value on every tile.
    """
    run = _grid_run(spec, rules)
    if run is not None:
        return _loss_grid(spec, params, batch, run)
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


def init_cache(spec: LMSpec, batch: int, s_max: int, device="cuda", *, enc_len: int = 0,
               rules=None) -> dict:
    """Decode caches, one dict per block (each shared-block invocation its
    own), and the next position.  A decoder block of an encoder-decoder also
    holds the cross-attention's K/V over ``enc_len`` encoder positions.

    With a grid in ``rules`` every entry is a per-tile value laid out by
    :func:`cache_axes` (sanitized): its tiles are allocated on their devices
    at exactly those shapes."""
    run = _grid_run(spec, rules)
    if run is not None:
        return _init_cache_grid(spec, batch, s_max, run, enc_len)
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


def prefill(spec: LMSpec, params: Params, tokens: torch.Tensor, s_max: int, *, frames=None,
            rules=None):
    """Run the prompt (B, S) [and, for an encoder-decoder, the encoder over
    ``frames`` (B, T, d_model)]; return (last-position logits (B, V_padded),
    cache).

    With a grid in ``rules``: ``params`` from :func:`grid_view` (unstacked),
    ``tokens`` a per-tile value laid out by ``(batch, seq)`` and ``frames``
    by ``(batch, seq, embed)``; the logits come back per tile, laid out by
    ``(batch,)`` with the whole vocab on every tile (gathered over the
    vocab shards)."""
    run = _grid_run(spec, rules)
    if run is not None:
        return _prefill_grid(spec, params, tokens, s_max, frames, run)
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


def decode_step(spec: LMSpec, params: Params, token: torch.Tensor, cache: dict, *,
                rules=None):
    """One decode step.  token (B,) int -> (logits (B, V_padded), cache).
    With a grid in ``rules`` the token, the cache and the logits are per-tile
    values, as :func:`prefill` gives them."""
    run = _grid_run(spec, rules)
    if run is not None:
        return _decode_grid(spec, params, token, cache, run)
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


# ---------------------------------------------------------------------------
# on a device grid
# ---------------------------------------------------------------------------


def _grid_run(spec: LMSpec, rules) -> cm.GridRun | None:
    """The grid in ``rules``, or None: no grid, or a 1x1 one (the
    single-device code, on single-device values)."""
    if not rules or rules.get("_grid") is None or rules["_grid"].is_trivial:
        return None
    return cm.GridRun(rules)


def _add(a: coll.Sharded, b) -> coll.Sharded:
    return coll.Sharded([x + y for x, y in zip(a, b)], a.spec, a.shape)


def _embed_grid(cfg: ArchConfig, params, tokens: coll.Sharded, run) -> coll.Sharded:
    """The embedding of per-tile ids over a vocab-sharded table: each tile
    looks up the ids in its vocab range (zero elsewhere), the tiles' rows
    summed over the vocab axes in order; laid out as ``tokens`` by batch and
    sequence, d_model whole."""
    grid, table = run.grid, params.embed
    ev = coll.entry_axes(table.spec[0])
    varying = tuple(a for e in tokens.spec for a in coll.entry_axes(e)) + ev
    tab = run.param(table, (ev, ()), varying)
    v_loc = tab[0].shape[0]
    rows = []
    for t in range(grid.n_tiles):
        local = tokens[t] - grid.position(t, ev) * v_loc
        inr = (local >= 0) & (local < v_loc)
        e = tab[t][local.clamp(0, v_loc - 1)] * inr[..., None].to(tab[t].dtype)
        rows.append(e.to(cfg.cdtype))
    h = coll.all_reduce(rows, grid, ev, run.path)
    return coll.Sharded(h, (*tokens.spec, None), (*tokens.shape, cfg.d_model))


def _head_grid(cfg: ArchConfig, params, run, ev: tuple, varying: tuple) -> list:
    """Each tile's (d_model, vocab slice) unembedding, laid out for the
    vocab axes ``ev``."""
    if cfg.tie_embeddings:
        tab = run.param(params.embed, (ev, ()), varying)
        return [w.T for w in tab]
    return run.param(params.lm_head, ((), ev), varying)


def _logits_grid(cfg: ArchConfig, run, x: list, head: list, ev: tuple) -> list:
    """Per-tile logits over each tile's vocab slice; padding columns -1e30."""
    out = []
    for t, (xx, w) in enumerate(zip(x, head)):
        logits = xx @ w.to(cfg.cdtype)
        if cfg.vocab_padded != cfg.vocab:
            col = run.grid.position(t, ev) * w.shape[1] + torch.arange(w.shape[1],
                                                                     device=logits.device)
            logits = torch.where(col >= cfg.vocab, torch.full_like(logits, -1e30), logits)
        out.append(logits)
    return out


def _xent_grid(cfg: ArchConfig, params, h: coll.Sharded, labels: coll.Sharded, run) -> list:
    """:func:`_chunked_xent` over vocab shards: per sequence chunk each tile's
    logits over its vocab slice, the log-sum-exp from the max over the
    shards (no gradient) and the sum of exp over them, the gold logit from
    the shard that holds the label; the tiles' sums then added over the
    batch and sequence axes, divided by B * S.  The same value on every tile."""
    grid = run.grid
    ev = run.entry("vocab", cfg.vocab_padded)
    bs = coll.entry_axes(h.spec[0]) + coll.entry_axes(h.spec[1])
    head = _head_grid(cfg, params, run, ev, bs + ev)
    x = coll.pvary(h, grid, ev, run.path)
    s_loc = h[0].shape[1]
    ck = min(cfg.vocab_chunk, s_loc)
    while s_loc % ck:
        ck //= 2
    v_loc = head[0].shape[1]
    offs = [grid.position(t, ev) * v_loc for t in range(grid.n_tiles)]
    n = grid.n_tiles

    def chunk(*xs_ls):
        xs, ls = xs_ls[:n], xs_ls[n:]
        logits = [lg.to(torch.float32) for lg in _logits_grid(cfg, run, list(xs), head, ev)]
        big = coll.all_max([lg.detach().amax(-1) for lg in logits], grid, ev, run.path)
        sums = coll.all_reduce([torch.exp(lg - m[..., None]).sum(-1)
                                for lg, m in zip(logits, big)], grid, ev, run.path)
        gold = []
        for t, (lg, ll) in enumerate(zip(logits, ls)):
            local = ll - offs[t]
            inr = (local >= 0) & (local < v_loc)
            g = lg.gather(-1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
            gold.append(torch.where(inr, g, torch.zeros_like(g)))
        gold = coll.all_reduce(gold, grid, ev, run.path)
        return tuple(torch.sum(m + torch.log(sm) - g) for m, sm, g in zip(big, sums, gold))

    remat = cfg.remat and torch.is_grad_enabled()
    totals = [torch.zeros((), dtype=torch.float32, device=d) for d in grid.devices]
    for c0 in range(0, s_loc, ck):
        args = [xx[:, c0:c0 + ck] for xx in x] + [ll[:, c0:c0 + ck] for ll in labels]
        part = checkpoint(chunk, *args, use_reentrant=False) if remat else chunk(*args)
        totals = [a + b for a, b in zip(totals, part)]
    totals = coll.all_reduce(totals, grid, bs, run.path)
    b, s = h.shape[:2]
    return [tot / (b * s) for tot in totals]


def _ffn_grid(cfg: ArchConfig, bt: str, bp, x: coll.Sharded, run):
    """The block's second half on a grid: (y, the MoE layer's aux or None)."""
    if bt == "attn_moe":
        return moe_mod.apply_moe_grid(cfg, run, bp.moe, x)
    return mlp_mod.apply_mlp_grid(cfg, run, bp.mlp, x), None


def _shared_in_grid(cfg: ArchConfig, run, bp, h: coll.Sharded, emb0: coll.Sharded):
    """:func:`_shared_in` on a grid: each tile's concat(h, emb0), normed at
    2 * d_model."""
    cat = coll.Sharded([torch.cat([a, b], dim=-1) for a, b in zip(h, emb0)], h.spec,
                       (*h.shape[:-1], 2 * cfg.d_model))
    return cm.apply_norm_grid(cfg, run, bp.ln, cat, d=2 * cfg.d_model)


def _block_grid(cfg: ArchConfig, bt: str, bp, h: coll.Sharded, run, *, emb0=None,
                enc_out=None):
    """One block over a per-tile sequence (training, the encoder): (h, aux or None)."""
    def norm(p, x):
        return cm.apply_norm_grid(cfg, run, p, x)

    if bt == "mamba":
        return _add(h, mb.apply_mamba_grid(cfg, run, bp.mamba, norm(bp.ln, h))), None
    if bt == "rwkv":
        h = _add(h, rwkv_mod.apply_rwkv_timemix_grid(cfg, run, bp.rwkv, norm(bp.ln1, h))[0])
        return _add(h, rwkv_mod.apply_rwkv_channelmix_grid(cfg, run, bp.rwkv,
                                                           norm(bp.ln2, h))[0]), None
    if bt == "shared_attn":
        h = _add(h, attn.attend_train_grid(_shared_attn_cfg(cfg), run, bp.attn,
                                           _shared_in_grid(cfg, run, bp, h, emb0)))
        return _add(h, mlp_mod.apply_mlp_grid(cfg, run, bp.mlp, norm(bp.ln2, h))), None
    h = _add(h, attn.attend_train_grid(cfg, run, bp.attn, norm(bp.ln1, h), causal=bt != "enc"))
    if bt == "dec":
        h = _add(h, attn.cross_attend_train_grid(cfg, run, bp.xattn, norm(bp.lnx, h),
                                                 enc_out)[0])
    y, aux = _ffn_grid(cfg, bt, bp, norm(bp.ln2, h), run)
    return _add(h, y), aux


def _run_blocks_grid(cfg: ArchConfig, blocks, h: coll.Sharded, run, *, emb0=None,
                     enc_out=None):
    """:func:`_run_blocks_train` on a grid: every block of ``blocks`` over
    the per-tile sequence, each checkpointed under remat; returns (h, the
    per-tile sums of the MoE layers' lb_loss and z_loss)."""
    n = run.grid.n_tiles
    remat = cfg.remat and torch.is_grad_enabled()
    lb = [torch.zeros((), dtype=torch.float32, device=d) for d in run.grid.devices]
    z = list(lb)
    for bt, bp in blocks:
        def fn(*tiles, bt=bt, bp=bp, spec_=h.spec, shape=h.shape):
            out, aux = _block_grid(cfg, bt, bp, coll.Sharded(tiles, spec_, shape), run,
                                   emb0=emb0, enc_out=enc_out)
            return tuple(out) + (() if aux is None else (*aux["lb_loss"], *aux["z_loss"]))

        out = checkpoint(fn, *h, use_reentrant=False) if remat else fn(*h)
        h = coll.Sharded(out[:n], h.spec, h.shape)
        if len(out) > n:
            lb = [a + c for a, c in zip(lb, out[n:2 * n])]
            z = [a + c for a, c in zip(z, out[2 * n:])]
    return h, lb, z


def _encode_grid(spec: LMSpec, params, frames: coll.Sharded, run) -> coll.Sharded:
    """:func:`encode` on a grid: the frames (B, T, d_model) laid out by
    ``(batch, seq, embed)`` (re-laid if they are not), the encoder's blocks
    non-causal, its final norm."""
    cfg = spec.cfg
    h = coll.Sharded([f.to(cfg.cdtype) for f in frames], frames.spec, frames.shape)
    h = cm.constrain(h, ("batch", "seq", "embed"), run.rules)
    h, _, _ = _run_blocks_grid(cfg, _walk_enc(spec, params), h, run)
    return cm.apply_norm_grid(cfg, run, params.enc_final_norm, h)


def _loss_grid(spec: LMSpec, params, batch: dict, run):
    cfg = spec.cfg
    enc_out = _encode_grid(spec, params, batch["frames"], run) if spec.is_encdec else None
    h = _embed_grid(cfg, params, batch["tokens"], run)
    emb0 = h if spec.has_shared_attn else None
    h, lb, z = _run_blocks_grid(cfg, _walk(spec, params), h, run, emb0=emb0, enc_out=enc_out)
    x = cm.apply_norm_grid(cfg, run, params.final_norm, h)
    xent = _xent_grid(cfg, params, x, batch["labels"], run)
    loss = [xe + 0.01 * a + 0.001 * c for xe, a, c in zip(xent, lb, z)]
    return loss, {"xent": xent, "lb_loss": lb, "z_loss": z}


def _cache_specs(spec: LMSpec, batch: int, s_max: int, enc_len: int, run):
    """(the single-device cache's shapes and dtypes on meta, its layers'
    sanitized specs under the rules)."""
    meta = init_cache(spec, batch, s_max, device="meta", enc_len=enc_len)
    specs = cm.sanitize_specs(cm.tree_specs(cache_axes(spec)["layers"], run.rules),
                              meta["layers"], run.grid)
    return meta["layers"], specs


def _init_cache_grid(spec: LMSpec, batch: int, s_max: int, run, enc_len: int = 0) -> dict:
    """:func:`init_cache` on a grid: every entry's tiles zeros of its
    ``tile_shape`` under :func:`cache_axes`' sanitized spec, on their devices."""
    grid = run.grid
    meta, specs = _cache_specs(spec, batch, s_max, enc_len, run)

    def zeros(x, sp):
        tile = cm.tile_shape(sp, x.shape, grid)
        return coll.Sharded([torch.zeros(tile, dtype=x.dtype, device=d) for d in grid.devices],
                            sp, x.shape)

    return {"layers": [{k: zeros(x, sp[k]) for k, x in c.items()} for c, sp in zip(meta, specs)],
            "pos": 0}


def cache_to_grid(spec: LMSpec, cache: dict, rules) -> dict:
    """A single-device cache (as a prefill without a grid leaves it: K/V,
    Mamba2's conv rows and states, RWKV6's shifts and states, an
    encoder-decoder's cross K/V and encoder output) cut onto the grid in
    ``rules``: :func:`init_cache`'s layout, each tile holding its slice, at
    the same next position (a placement: no move is counted)."""
    run = _grid_run(spec, rules)
    first = cache["layers"][0]
    batch = next(iter(first.values())).shape[0]
    enc_len = first["xk"].shape[1] if "xk" in first else 0
    _, specs = _cache_specs(spec, batch, _kv_len(cache) or 1, enc_len, run)
    tiles = cm.shard_tree(cache["layers"], specs, run.grid)
    layers = cm.sharded_tree(tiles, specs, run.grid)
    out = {"layers": layers, "pos": cache["pos"]}
    if "enc_out" in cache:
        out["enc_out"] = run.place(cache["enc_out"], ("batch", "seq", "embed"))
    return out


def _write_prefill_grid(c: dict, k: coll.Sharded, v: coll.Sharded, run) -> None:
    """Each tile's slice of the cache's positions from the prompt's K/V
    (gathered whole over the sequence first, where it was split)."""
    grid = run.grid
    for name, x in (("k", k), ("v", v)):
        whole = coll.relayout(x, (x.spec[0], None, None, None), grid, run.path)
        buf = c[name]
        kva = coll.entry_axes(buf.spec[1])
        s_loc, s = buf[0].shape[1], x.shape[1]
        for t in range(grid.n_tiles):
            lo = grid.position(t, kva) * s_loc
            hi = min(lo + s_loc, s)
            if hi > lo:
                buf[t][:, : hi - lo] = whole[t][:, lo:hi].to(buf[t].dtype)


def _last_logits_grid(cfg: ArchConfig, params, h: coll.Sharded, run) -> coll.Sharded:
    """The final norm and the unembedding of the last position, the logits
    gathered over the vocab shards: (B, V_padded) laid out by batch."""
    grid = run.grid
    h = coll.relayout(h, (h.spec[0], None, None), grid, run.path)
    last = coll.Sharded([x[:, -1:, :] for x in h], h.spec, (h.shape[0], 1, h.shape[2]))
    x = cm.apply_norm_grid(cfg, run, params.final_norm, last)
    ev = run.entry("vocab", cfg.vocab_padded)
    head = _head_grid(cfg, params, run, ev, coll.entry_axes(x.spec[0]) + ev)
    logits = coll.all_gather(_logits_grid(cfg, run, list(x), head, ev), grid, ev, -1, run.path)
    return coll.Sharded([lg[:, 0] for lg in logits], (x.spec[0], None),
                        (x.shape[0], cfg.vocab_padded))


def _prefill_block_grid(cfg: ArchConfig, bt: str, bp, h: coll.Sharded, c: dict, run, emb0,
                        enc_out) -> coll.Sharded:
    """One block over the per-tile prompt; fills its cache ``c`` (K/V in
    place, the recurrent blocks' entries re-laid to their specs)."""
    def norm(p, x):
        return cm.apply_norm_grid(cfg, run, p, x)

    def put(name, x):
        c[name] = coll.relayout(x, c[name].spec, run.grid, run.path)

    if bt == "mamba":
        y, cn = mb.apply_mamba_grid(cfg, run, bp.mamba, norm(bp.ln, h),
                                    cache_specs={k: c[k].spec for k in ("conv", "ssm")})
        c.update(cn)
        return _add(h, y)
    if bt == "rwkv":
        y, tm_prev, states = rwkv_mod.apply_rwkv_timemix_grid(cfg, run, bp.rwkv,
                                                              norm(bp.ln1, h))
        h = _add(h, y)
        y, cm_prev = rwkv_mod.apply_rwkv_channelmix_grid(cfg, run, bp.rwkv, norm(bp.ln2, h))
        put("tm_prev", tm_prev)
        put("cm_prev", cm_prev)
        put("wkv", states)
        return _add(h, y)
    if bt == "shared_attn":
        y, k, v = attn.attend_prefill_grid(_shared_attn_cfg(cfg), run, bp.attn,
                                           _shared_in_grid(cfg, run, bp, h, emb0))
    else:
        y, k, v = attn.attend_prefill_grid(cfg, run, bp.attn, norm(bp.ln1, h))
    h = _add(h, y)
    if bt == "dec":
        y, xk, xv = attn.cross_attend_train_grid(cfg, run, bp.xattn, norm(bp.lnx, h), enc_out)
        put("xk", xk)
        put("xv", xv)
        h = _add(h, y)
    h = _add(h, _ffn_grid(cfg, bt, bp, norm(bp.ln2, h), run)[0])
    _write_prefill_grid(c, k, v, run)
    return h


def _prefill_grid(spec: LMSpec, params, tokens: coll.Sharded, s_max: int, frames, run):
    cfg = spec.cfg
    s = tokens.shape[1]
    if s > s_max:
        raise ValueError(f"prompt of {s} tokens does not fit s_max={s_max}")
    if spec.is_encdec != (frames is not None):
        raise ValueError(f"{cfg.name}: frames are the encoder's input and only an "
                         f"encoder-decoder takes them")
    enc_out = _encode_grid(spec, params, frames, run) if spec.is_encdec else None
    cache = _init_cache_grid(spec, tokens.shape[0], s_max, run,
                             enc_len=0 if enc_out is None else enc_out.shape[1])
    h = _embed_grid(cfg, params, tokens, run)
    emb0 = h if spec.has_shared_attn else None
    for (bt, bp), c in zip(_walk(spec, params), cache["layers"], strict=True):
        h = _prefill_block_grid(cfg, bt, bp, h, c, run, emb0, enc_out)
    cache["pos"] = s
    if enc_out is not None:
        cache["enc_out"] = enc_out
    return _last_logits_grid(cfg, params, h, run), cache


def _decode_block_grid(cfg: ArchConfig, bt: str, bp, h: coll.Sharded, c: dict, pos: int,
                       emb0, run):
    """One block's decode step on a grid: (h, the block's new cache)."""
    def norm(p, x):
        return cm.apply_norm_grid(cfg, run, p, x)

    if bt == "mamba":
        y, cn = mb.apply_mamba_decode_grid(cfg, run, bp.mamba, norm(bp.ln, h), c)
        return _add(h, y), cn
    if bt == "rwkv":
        y, cn = rwkv_mod.rwkv_timemix_decode_grid(cfg, run, bp.rwkv, norm(bp.ln1, h), c)
        h = _add(h, y)
        y, cn = rwkv_mod.rwkv_channelmix_decode_grid(cfg, run, bp.rwkv, norm(bp.ln2, h), cn)
        return _add(h, y), cn
    if bt == "shared_attn":
        h = _add(h, attn.attend_decode_grid(_shared_attn_cfg(cfg), run, bp.attn,
                                            _shared_in_grid(cfg, run, bp, h, emb0),
                                            (c["k"], c["v"]), pos))
    else:
        h = _add(h, attn.attend_decode_grid(cfg, run, bp.attn, norm(bp.ln1, h),
                                            (c["k"], c["v"]), pos))
    if bt == "dec":
        h = _add(h, attn.cross_attend_decode_grid(cfg, run, bp.xattn, norm(bp.lnx, h),
                                                  (c["xk"], c["xv"]), pos))
    return _add(h, _ffn_grid(cfg, bt, bp, norm(bp.ln2, h), run)[0]), c


def _decode_grid(spec: LMSpec, params, token: coll.Sharded, cache: dict, run):
    cfg = spec.cfg
    pos = cache["pos"]
    s_max = _kv_len(cache)
    if s_max is not None and pos >= s_max:
        raise ValueError(f"decode position {pos} is past the KV cache (s_max={s_max})")
    tok = coll.Sharded([t[:, None] for t in token], (token.spec[0], None), (token.shape[0], 1))
    h = _embed_grid(cfg, params, tok, run)
    emb0 = h if spec.has_shared_attn else None
    layers = []
    for (bt, bp), c in zip(_walk(spec, params), cache["layers"], strict=True):
        h, cn = _decode_block_grid(cfg, bt, bp, h, c, pos, emb0, run)
        layers.append(cn)
    return _last_logits_grid(cfg, params, h, run), {**cache, "layers": layers, "pos": pos + 1}
