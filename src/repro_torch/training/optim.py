"""AdamW and Adafactor, and the learning-rate schedule.

Port of :mod:`repro.training.optim` on one device.  Parameters, gradients
and states are trees in the JAX package's layout (``lm.params_tree``: each
group's layers stacked), so Adafactor factors and clips each stacked leaf
as the JAX package does, and a state crosses between the packages leaf for
leaf (``interop.opt_state_from_numpy``, ``training.checkpoint``).  Moments
are fp32; parameters keep their dtype.

The JAX updates are pure functions.  Here ``*_update`` writes the new
parameters and moments into the given tensors, in place, and returns them:
at granite-3-2b's size (2.53 B parameters) a second copy of parameters and
moments would be 30 GB more of the card's 80.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import torch

from repro_torch.tree import tree_get, tree_leaves, tree_map, tree_paths


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    min_lr_frac: float = 0.1


def lr_schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_frac``, in fp32 as the JAX
    package computes it (``step`` an int or an integer tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf (fp32), summed leaf by leaf."""
    sq = sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree))
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm before).
    The gradients are scaled in place."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.to(torch.float32) * scale)
    return grads, norm


def _count(state) -> torch.Tensor:
    return state["count"] + 1


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    leaf = tree_leaves(params)[0]
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state, params):
    """One AdamW step; returns (params, state), both updated in place."""
    c = _count(state)
    lr = lr_schedule(cfg, c)
    b1, b2 = cfg.b1, cfg.b2
    cf = c.to(torch.float32)
    bc1, bc2 = 1 - b1 ** cf, 1 - b2 ** cf
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]),
                          tree_leaves(params), strict=True):
        g = g.to(torch.float32)
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * step)
    state["count"] = c
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (factored second moments, beta1 = 0)
# ---------------------------------------------------------------------------


def adafactor_init(params) -> dict:
    def factored(p):
        z = partial(torch.zeros, dtype=torch.float32, device=p.device)
        if p.ndim >= 2:
            return {"vr": z(p.shape[:-1]),  # rows (all but the last dim)
                    "vc": z(p.shape[:-2] + p.shape[-1:])}  # columns
        return {"v": z(p.shape)}

    leaf = tree_leaves(params)[0]
    return {"v": tree_map(factored, params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}


@torch.no_grad()
def adafactor_update(cfg: OptConfig, grads, state, params):
    """One Adafactor step; returns (params, state), both updated in place."""
    c = _count(state)
    lr = lr_schedule(cfg, c)
    decay = 1.0 - (c.to(torch.float32) + 1.0) ** -0.8  # tau = step^-0.8
    for (path, p), g in zip(tree_paths(params), tree_leaves(grads), strict=True):
        v = tree_get(state["v"], path)
        g = g.to(torch.float32)
        g2 = g * g + 1e-30
        if p.ndim >= 2:
            v["vr"].copy_(decay * v["vr"] + (1 - decay) * g2.mean(dim=-1))
            v["vc"].copy_(decay * v["vc"] + (1 - decay) * g2.mean(dim=-2))
            denom = torch.clamp(v["vr"].mean(dim=-1, keepdim=True), min=1e-30)
            vhat = v["vr"][..., None] * v["vc"][..., None, :] / denom[..., None]
        else:
            v["v"].copy_(decay * v["v"] + (1 - decay) * g2)
            vhat = v["v"]
        update = g * torch.rsqrt(vhat + 1e-30)
        # update clipping (RMS <= 1) stabilizes warmup, per the Adafactor paper
        rms = torch.sqrt(torch.mean(update * update) + 1e-30)
        update = update / torch.clamp(rms, min=1.0)
        step = update + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * step)
    state["count"] = c
    return params, state


# ---------------------------------------------------------------------------
# unified front
# ---------------------------------------------------------------------------


def make_optimizer(cfg: OptConfig):
    """(init(params) -> state, update(grads, state, params) -> (params, state))."""
    if cfg.name == "adamw":
        return adamw_init, partial(adamw_update, cfg)
    if cfg.name == "adafactor":
        return adafactor_init, partial(adafactor_update, cfg)
    raise ValueError(f"unknown optimizer {cfg.name!r}")
