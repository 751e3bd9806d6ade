"""State carried across from the JAX package, as numpy arrays.

CADDeLaG has no weights; its state is the chain operator and the embedding.
These helpers turn the JAX package's objects, handed over as numpy arrays,
into the port's, so one module can be checked at a time: a JAX-built
operator (plain or delta-corrected) into the port's solver, a JAX-built base
chain into the port's incremental update, two JAX-built embeddings into the
port's scorer, or a JAX-initialized LM parameter tree into the port's
serving path, or its parameter tree and optimizer state into the port's
training step.  This module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.chain import ChainOperator
from repro_torch.core.delta_chain import BaseChain
from repro_torch.core.embedding import Embedding
from repro_torch.device import resolve_device
from repro_torch.models.common import Params
from repro_torch.models.lm import LMSpec
from repro_torch.tree import tree_map


def _tensor(x, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).to(dev)  # a writable copy


def chain_operator_from_numpy(p1, p2, deg, vol, rho, device="cuda", *, p1_scale=None,
                              u1=None, v1=None, u2=None, v2=None) -> ChainOperator:
    """A :class:`ChainOperator` on ``device`` from numpy P1, P2, deg, vol and rho.

    ``p1_scale, u1, v1, u2, v2`` carry a delta-corrected operator's low-rank
    correction (all five or none); such an operator shares its P1 / P2 with
    a base chain, so it is marked ``shared_base``.
    """
    dev = resolve_device(device)
    corr = dict(p1_scale=p1_scale, u1=u1, v1=v1, u2=u2, v2=v2)
    if len({x is None for x in corr.values()}) > 1:
        raise ValueError("p1_scale, u1, v1, u2 and v2 come all together or not at all")
    corrected = p1_scale is not None
    return ChainOperator(
        p1=_tensor(p1, dev), p2=_tensor(p2, dev), deg=_tensor(deg, dev),
        vol=_tensor(vol, dev).reshape(()), rho=None if rho is None else float(rho),
        **{k: _tensor(x, dev) if corrected else None for k, x in corr.items()},
        shared_base=corrected,
    )


def base_chain_from_numpy(t_levels, p_levels, op: ChainOperator, d_len: int,
                          deflate: bool) -> BaseChain:
    """A resident :class:`BaseChain` from the JAX package's retained levels.

    ``t_levels`` are T_0 .. T_{d-1} and ``p_levels`` P_1 .. P_{d-2} as numpy
    arrays (a JAX ``BaseChain``'s lists); ``op`` is its base operator, already
    carried across (:func:`chain_operator_from_numpy`), whose device the
    levels go to.
    """
    dev = op.deg.device
    op.shared_base = True
    return BaseChain(op=op, t_levels=[_tensor(t, dev) for t in t_levels],
                     p_levels=[_tensor(p, dev) for p in p_levels], d_len=d_len,
                     deflate=deflate)


def embedding_from_numpy(z, vol, device="cuda") -> Embedding:
    """An :class:`Embedding` on ``device`` from a numpy Z (n, k) and volume."""
    dev = resolve_device(device)
    return Embedding(z=_tensor(z, dev), vol=_tensor(vol, dev).reshape(()))


def _leaf(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A writable copy of ``a`` in its dtype (bfloat16 too, which numpy holds
    as the ``ml_dtypes`` type that ``torch.from_numpy`` does not take)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def _params_tree(tree: dict, dev: torch.device, index=None) -> Params:
    """Nested dicts of numpy arrays -> nested :class:`Params`; ``index`` picks
    one layer of a stacked ``(count, ...)`` group."""
    tensors, children = {}, {}
    for name, x in tree.items():
        if isinstance(x, dict):
            children[name] = _params_tree(x, dev, index)
        else:
            tensors[name] = _leaf(np.asarray(x) if index is None else np.asarray(x)[index], dev)
    return Params(tensors, **children)


def lm_params_from_numpy(spec: LMSpec, tree: dict, device="cuda") -> Params:
    """The port's LM parameters from the JAX package's ``lm.init_params`` tree.

    ``tree`` is that pytree with numpy leaves (``jax.tree.map(np.asarray,
    params)``): ``embed``, ``final_norm``, ``lm_head`` unless tied, and
    ``groups``, a list with one dict per group whose block entries are stacked
    on a leading ``(count, ...)`` layer axis, the unstacked ``shared_attn``
    of a hybrid, and an encoder-decoder's ``enc_groups`` (stacked as
    ``groups``) and ``enc_final_norm``.  The layers are unstacked into
    ``params.blocks`` (``params.enc_blocks``) in execution order (a group's
    shared-block positions have no entry, and no block); dtypes are kept.
    """
    dev = resolve_device(device)

    def blocks(gspecs, gtrees):
        out = []
        for g, gp in zip(gspecs, gtrees, strict=True):
            for layer in range(g.count):
                for bi, bt in enumerate(g.block_types):
                    if bt != "shared_attn":
                        out.append(_params_tree(gp[str(bi)], dev, index=layer))
        return torch.nn.ModuleList(out)

    out = _params_tree({k: v for k, v in tree.items() if k in ("embed", "lm_head")}, dev)
    out.add_module("final_norm", _params_tree(tree["final_norm"], dev))
    out.add_module("blocks", blocks(spec.groups, tree["groups"]))
    if spec.is_encdec:
        out.add_module("enc_blocks", blocks(spec.enc_groups, tree["enc_groups"]))
        out.add_module("enc_final_norm", _params_tree(tree["enc_final_norm"], dev))
    if "shared_attn" in tree:
        out.add_module("shared_attn", _params_tree(tree["shared_attn"], dev))
    return out


def tree_from_numpy(tree, device="cuda"):
    """A tree of numpy arrays (dicts and lists, the JAX package's layout) as
    the same tree of tensors on ``device``, dtypes (bf16 too) and bits kept."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf(a, dev), tree)


def lm_tree_from_numpy(tree: dict, device="cuda") -> dict:
    """The training step's parameters (the layout of ``lm.params_tree``) from
    the JAX package's ``lm.init_params`` tree with numpy leaves, each leaf a
    leaf tensor that requires grad."""
    return tree_map(lambda t: t.requires_grad_(True), tree_from_numpy(tree, device))


def opt_state_from_numpy(state: dict, device="cuda") -> dict:
    """An optimizer state of the port from the JAX package's, as numpy.

    AdamW's ``{"m": tree, "v": tree, "count": int32 ()}`` and Adafactor's
    ``{"v": tree of {"vr", "vc"} (a parameter of two or more dims) or {"v"},
    "count"}`` have the same layout in both packages, moments fp32, so the
    state carries across leaf for leaf: a train step then starts from the
    same state in both.
    """
    return tree_from_numpy(state, device)


def grid_tree_from_numpy(tree, specs, grid, *, requires_grad: bool = False) -> list:
    """A tree of numpy arrays (the JAX package's layout: a parameter tree or
    an optimizer state) cut onto a device grid by its sanitized ``specs``:
    per-tile trees (``models.common.shard_tree``), each leaf on its tile's
    device; with ``requires_grad`` the leaves require grad (the training
    step's parameters)."""
    from repro_torch.models.common import device_grid, shard_tree

    g = device_grid(grid)
    whole = tree_from_numpy(tree, "cpu")
    if requires_grad:
        whole = tree_map(lambda t: t.requires_grad_(True), whole)
    return shard_tree(whole, specs, g)


def lm_grid_params_from_numpy(spec: LMSpec, tree: dict, specs, grid) -> list:
    """The serving path's per-tile parameters on a device grid from the JAX
    package's ``lm.init_params`` tree: :func:`lm_params_from_numpy`'s layers,
    in ``lm.param_dict``'s layout, cut by ``specs`` (the sanitized
    ``lm.param_specs``); ``lm.grid_view(..., stacked=False)`` reads them."""
    from repro_torch.models.common import device_grid, shard_tree
    from repro_torch.models.lm import param_dict

    params = lm_params_from_numpy(spec, tree, "cpu")
    return shard_tree(param_dict(params), specs, device_grid(grid))
