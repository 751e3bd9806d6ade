"""State carried across from the JAX package, as numpy arrays.

CADDeLaG has no weights; its state is the chain operator and the embedding.
These helpers turn the JAX package's objects, handed over as numpy arrays,
into the port's, so one module can be checked at a time: a JAX-built
operator (plain or delta-corrected) into the port's solver, a JAX-built base
chain into the port's incremental update, two JAX-built embeddings into the
port's scorer, or a JAX-initialized LM parameter tree into the port's
serving path.  This module imports neither JAX nor the JAX package.
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
    on a leading ``(count, ...)`` layer axis, and the unstacked
    ``shared_attn`` of a hybrid.  The layers are unstacked into
    ``params.blocks`` in execution order (a group's shared-block positions
    have no entry, and no block); dtypes are kept.
    """
    dev = resolve_device(device)
    top = {k: v for k, v in tree.items() if k in ("embed", "lm_head")}
    blocks = []
    for g, gp in zip(spec.groups, tree["groups"], strict=True):
        for layer in range(g.count):
            for bi, bt in enumerate(g.block_types):
                if bt != "shared_attn":
                    blocks.append(_params_tree(gp[str(bi)], dev, index=layer))
    out = _params_tree(top, dev)
    out.add_module("final_norm", _params_tree(tree["final_norm"], dev))
    out.add_module("blocks", torch.nn.ModuleList(blocks))
    if "shared_attn" in tree:
        out.add_module("shared_attn", _params_tree(tree["shared_attn"], dev))
    return out
