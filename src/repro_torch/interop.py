"""State carried across from the JAX package, as numpy arrays.

CADDeLaG has no weights; its state is the chain operator and the embedding.
These helpers turn the JAX package's objects, handed over as numpy arrays,
into the port's, so one module can be checked at a time: a JAX-built
operator into the port's solver, or two JAX-built embeddings into the port's
scorer.  This module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.chain import ChainOperator
from repro_torch.core.embedding import Embedding
from repro_torch.device import resolve_device


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
