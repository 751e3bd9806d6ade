"""State carried across from the JAX package, as numpy arrays.

CADDeLaG has no weights; its state is the chain operator and the embedding.
These helpers turn the JAX package's objects, handed over as numpy arrays,
into the port's, so one module can be checked at a time: a JAX-built
operator into the port's solver, two JAX-built embeddings into the port's
scorer, or a JAX-initialized LM parameter tree into the port's serving
path.  This module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.chain import ChainOperator
from repro_torch.core.embedding import Embedding
from repro_torch.device import resolve_device
from repro_torch.models.common import Params
from repro_torch.models.lm import LMSpec


def _tensor(x, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).to(dev)  # a writable copy


def chain_operator_from_numpy(p1, p2, deg, vol, rho, device="cuda") -> ChainOperator:
    """A :class:`ChainOperator` on ``device`` from numpy P1, P2, deg, vol and rho."""
    dev = resolve_device(device)
    return ChainOperator(
        p1=_tensor(p1, dev), p2=_tensor(p2, dev), deg=_tensor(deg, dev),
        vol=_tensor(vol, dev).reshape(()), rho=None if rho is None else float(rho),
    )


def embedding_from_numpy(z, vol, device="cuda") -> Embedding:
    """An :class:`Embedding` on ``device`` from a numpy Z (n, k) and volume."""
    dev = resolve_device(device)
    return Embedding(z=_tensor(z, dev), vol=_tensor(vol, dev).reshape(()))


def _params_tree(tree: dict, dev: torch.device, index=None) -> Params:
    """Nested dicts of numpy arrays -> nested :class:`Params`; ``index`` picks
    one layer of a stacked ``(count, ...)`` group."""
    tensors, children = {}, {}
    for name, x in tree.items():
        if isinstance(x, dict):
            children[name] = _params_tree(x, dev, index)
        else:
            a = np.asarray(x) if index is None else np.asarray(x)[index]
            tensors[name] = torch.from_numpy(np.array(a)).to(dev)  # a writable copy
    return Params(tensors, **children)


def lm_params_from_numpy(spec: LMSpec, tree: dict, device="cuda") -> Params:
    """The port's LM parameters from the JAX package's ``lm.init_params`` tree.

    ``tree`` is that pytree with numpy leaves (``jax.tree.map(np.asarray,
    params)``): ``embed``, ``final_norm``, ``lm_head`` unless tied, and
    ``groups``, a list with one dict per group whose block entries are stacked
    on a leading ``(count, ...)`` layer axis.  The layers are unstacked into
    ``params.blocks`` in execution order; dtypes are kept.
    """
    dev = resolve_device(device)
    top = {k: v for k, v in tree.items() if k in ("embed", "lm_head")}
    blocks = []
    for g, gp in zip(spec.groups, tree["groups"], strict=True):
        for layer in range(g.count):
            for bi in range(len(g.block_types)):
                blocks.append(_params_tree(gp[str(bi)], dev, index=layer))
    out = _params_tree(top, dev)
    out.add_module("final_norm", _params_tree(tree["final_norm"], dev))
    out.add_module("blocks", torch.nn.ModuleList(blocks))
    return out
