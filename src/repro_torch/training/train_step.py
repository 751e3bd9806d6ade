"""The training step on one device: gradient accumulation, clipping, update.

Port of :mod:`repro.training.train_step`.  ``make_train_step`` returns

    step(params, opt_state, batch) -> (params, opt_state, metrics)

where ``params`` is the model's parameter tree (``lm.params_tree``, the JAX
package's layout, leaves that require grad), ``opt_state`` its optimizer
state and ``batch`` a dict of numpy arrays or tensors (tokens, labels
[, frames]).  The global batch is split into ``accum`` microbatches run one
after another; their gradients are averaged in fp32.  Gradients come from
autograd; the kernels on the path (``flash_attention``, ``wkv``) go through
their ``autograd.Function``s, whose backward recomputes the plain chunked
forms, as the JAX package differentiates its plain scans.  Parameters and
moments are updated in place.

``make_compressed_train_step`` and the int8 error-feedback all-reduce need a
pod axis of a device mesh, which the port does not have yet (ROADMAP.md,
item 9c).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.training import optim as opt_mod
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _split_microbatches(batch: dict, accum: int) -> list[dict]:
    """(B, ...) -> ``accum`` dicts of (B / accum, ...) each, in row order."""
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f"batch {b} does not split into {accum} microbatches")
    n = b // accum
    return [{k: x[i * n : (i + 1) * n] for k, x in batch.items()} for i in range(accum)]


def batch_to_device(batch: dict, device) -> dict:
    """Numpy or tensor batch -> tensors on ``device``: integer arrays as int64
    (the embedding's and the loss's indices), the rest as they are."""
    out = {}
    for k, x in batch.items():
        t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        if not t.is_floating_point():
            t = t.to(torch.int64)
        out[k] = t.to(device, non_blocking=True)
    return out


def make_loss_and_grad(spec: lm.LMSpec, accum: int = 1):
    """(params, batch) -> (loss, metrics, grads): the mean over ``accum``
    microbatches; metrics are the last microbatch's, as the JAX package's."""

    def grad_fn(params, batch):
        leaves = tree_leaves(params)
        loss, metrics = lm.loss_fn(spec, lm.params_view(spec, params), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(params, list(grads))

    def accum_grads(params, batch):
        if accum == 1:
            return grad_fn(params, batch)
        grads_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
        loss_acc = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
        for mb in _split_microbatches(batch, accum):
            loss, metrics, grads = grad_fn(params, mb)
            for a, g in zip(tree_leaves(grads_acc), tree_leaves(grads), strict=True):
                a.copy_(a + g.to(torch.float32) / accum)
            loss_acc = loss_acc + loss / accum
        return loss_acc, metrics, grads_acc

    return accum_grads


def make_train_step(spec: lm.LMSpec, opt_cfg: opt_mod.OptConfig, *, accum: int = 1,
                    device="cuda"):
    """step(params, opt_state, batch) -> (params, opt_state, metrics): the
    gradient (mean over ``accum`` microbatches), clipped to the global norm
    ``opt_cfg.clip_norm``, then the optimizer's update in place; metrics
    ``loss``, ``grad_norm``, ``xent``, ``lb_loss`` and ``z_loss`` (0-dim
    tensors on the device; reading one waits for the step)."""
    dev = resolve_device(device)
    _, opt_update = opt_mod.make_optimizer(opt_cfg)
    accum_grads = make_loss_and_grad(spec, accum)

    def step(params, opt_state, batch):
        loss, metrics, grads = accum_grads(params, batch_to_device(batch, dev))
        grads, gnorm = opt_mod.clip_by_global_norm(grads, opt_cfg.clip_norm)
        params, opt_state = opt_update(grads, opt_state, params)
        return params, opt_state, {**metrics, "loss": loss, "grad_norm": gnorm}

    return step


def init_state(spec: lm.LMSpec, opt_cfg: opt_mod.OptConfig, seed: int = 0, *, device="cuda"):
    """(params, opt_state) on ``device``: the port's own random init
    (``lm.init_params`` with ``seed``) as a parameter tree whose leaves
    require grad, and the optimizer's zero state."""
    dev = resolve_device(device)
    module = lm.init_params(spec, seed=seed, device=dev)
    params = tree_map(lambda t: t.requires_grad_(True), lm.params_tree(spec, module))
    del module
    opt_init, _ = opt_mod.make_optimizer(opt_cfg)
    return params, opt_init(params)
