"""AdamW and Adafactor, and the learning-rate schedule.

Port of :mod:`repro.training.optim` on one device.  Parameters, gradients
and states are trees in the JAX package's layout (``lm.params_tree``: each
group's layers stacked), so Adafactor factors and clips each stacked leaf
as the JAX package does, and a state crosses between the packages leaf for
leaf (``interop.opt_state_from_numpy``, ``training.checkpoint``).  Moments
are fp32; parameters keep their dtype.  ``*_state_specs`` give the states'
partition specs from the parameters' (the dry run's per-tile bytes).

The JAX updates are pure functions.  Here ``*_update`` writes the new
parameters and moments into the given tensors, in place, and returns them:
at granite-3-2b's size (2.53 B parameters) a second copy of parameters and
moments would be 30 GB more of the card's 80.

On a device grid (:func:`grid_global_norm`, :func:`grid_clip`,
:func:`grid_update`) parameters, gradients and states are per-tile trees
laid out by their sanitized specs.  AdamW is elementwise, so each tile runs
:func:`adamw_update` on its own tiles.  The global norm sums every tile's
squares of the leaves it owns -- a leaf replicated over an axis counts at
coordinate 0 of that axis only -- then the tiles' sums in tile order.
Adafactor's row and column statistics, its denominator and its update RMS
are means over whole dims: a dim split over grid axes sums its tiles'
partial sums over those axes before dividing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import torch

from repro_torch.tree import tree_get, tree_leaves, tree_map, tree_paths

GRID_PATH = "lm.train"


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


def adamw_state_specs(param_specs) -> dict:
    """Partition specs of :func:`adamw_init`'s state: the moments inherit the
    parameters' (they are elementwise); ``count`` is replicated."""
    from repro_torch.models.common import Spec

    return {"m": param_specs, "v": param_specs, "count": Spec()}


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


def adafactor_state_specs(param_specs, params_shape) -> dict:
    """Partition specs of :func:`adafactor_init`'s state: a factored state
    drops its parameter spec's last (``vr``) or second-last (``vc``) entry.
    ``params_shape`` is the parameter tree (tensors, meta tensors or shapes):
    whether a leaf is factored depends on its rank, so the specs follow the
    tree the optimizer runs on (``lm.params_tree``, groups stacked)."""
    from repro_torch.models.common import Spec, map_axes

    def spec_for(ps, p):
        ndim = len(p.shape) if hasattr(p, "shape") else len(p)
        ps_t = tuple(ps) + (None,) * (ndim - len(tuple(ps)))
        if ndim >= 2:
            return {"vr": Spec(*ps_t[:-1]), "vc": Spec(*(ps_t[:-2] + ps_t[-1:]))}
        return {"v": Spec(*ps_t)}

    return {"v": map_axes(spec_for, param_specs, params_shape), "count": Spec()}


# ---------------------------------------------------------------------------
# on a device grid
# ---------------------------------------------------------------------------


def _spec_axes(spec) -> set:
    from repro_torch.core.collectives import entry_axes

    return {a for e in tuple(spec) for a in entry_axes(e)}


def grid_global_norm(grads: list, specs, grid, path: str = GRID_PATH) -> list:
    """The global norm of per-tile gradient trees (tile order) on every tile:
    each tile sums the squares of the leaves it owns (coordinate 0 on every
    axis the leaf is replicated over), the tiles' sums added in tile order."""
    from repro_torch.core import collectives as coll

    spec_leaves = [s for _, s in sorted_spec_paths(specs)]
    parts = []
    for t, tree in enumerate(grads):
        c = grid.coords(t)
        sq = torch.zeros((), dtype=torch.float32, device=grid.devices[t])
        for g, s in zip(tree_leaves(tree), spec_leaves, strict=True):
            if all(c[a] == 0 for a in grid.axis_names if a not in _spec_axes(s)):
                sq = sq + torch.sum(torch.square(g.to(torch.float32)))
        parts.append(sq)
    return [torch.sqrt(x) for x in coll.all_reduce(parts, grid, grid.axis_names, path)]


def sorted_spec_paths(specs) -> list:
    """(path, spec) of a spec tree's leaves in :func:`repro_torch.tree.tree_leaves`'
    order (dict keys sorted, lists by index)."""
    from repro_torch.models.common import _is_axes

    out = []

    def walk(tree, prefix):
        if _is_axes(tree):
            out.append((prefix, tree))
        elif isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], prefix + (k,))
        else:
            for i, x in enumerate(tree):
                walk(x, prefix + (i,))

    walk(specs, ())
    return out


def grid_clip(grads: list, specs, grid, max_norm: float, path: str = GRID_PATH):
    """:func:`clip_by_global_norm` on per-tile gradient trees, in place;
    returns (grads, the norm on every tile)."""
    norms = grid_global_norm(grads, specs, grid, path)
    for tree, norm in zip(grads, norms):
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
        for g in tree_leaves(tree):
            if g.dtype == torch.float32:
                g.mul_(scale)
            else:
                g.copy_(g.to(torch.float32) * scale)
    return grads, norms


@torch.no_grad()
def grid_update(cfg: OptConfig, grads: list, states: list, params: list, specs, grid,
                path: str = GRID_PATH):
    """One optimizer step on per-tile trees (tile order), in place; ``specs``
    are the parameters' sanitized specs.  Returns (params, states)."""
    if cfg.name == "adamw":
        for g, s, p in zip(grads, states, params, strict=True):
            adamw_update(cfg, g, s, p)
        return params, states
    if cfg.name != "adafactor":
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    from repro_torch.core.collectives import all_reduce, entry_axes

    def psum(parts: list, axes) -> list:  # per-tile partials summed over a dim's grid axes
        return all_reduce(parts, grid, tuple(axes), path)

    n = grid.n_tiles
    c = _count(states[0])
    lr = [lr_schedule(cfg, _count(s)).to(grid.devices[t]) for t, s in enumerate(states)]
    decay = 1.0 - (c.to(torch.float32) + 1.0) ** -0.8
    spec_list = [s for _, s in sorted_spec_paths(specs)]
    paths = [path_ for path_, _ in tree_paths(params[0])]
    gl = [tree_leaves(g) for g in grads]
    for i, (lp, spec) in enumerate(zip(paths, spec_list, strict=True)):
        p0 = tree_get(params[0], lp)
        ent = tuple(spec) + (None,) * (p0.ndim - len(tuple(spec)))
        ax = [entry_axes(e) for e in ent]
        whole = [p0.shape[d] * math.prod(grid.shape[a] for a in ax[d]) for d in range(p0.ndim)]
        g = [gl[t][i].to(torch.float32) for t in range(n)]
        v = [tree_get(states[t]["v"], lp) for t in range(n)]
        p = [tree_get(params[t], lp) for t in range(n)]
        dev = [x.device for x in p]
        dec = [decay.to(d) for d in dev]
        g2 = [x * x + 1e-30 for x in g]
        if p0.ndim >= 2:
            rows = psum([x.sum(dim=-1) for x in g2], ax[-1])
            cols = psum([x.sum(dim=-2) for x in g2], ax[-2])
            for t in range(n):
                v[t]["vr"].copy_(dec[t] * v[t]["vr"] + (1 - dec[t]) * (rows[t] / whole[-1]))
                v[t]["vc"].copy_(dec[t] * v[t]["vc"] + (1 - dec[t]) * (cols[t] / whole[-2]))
            den = psum([x["vr"].sum(dim=-1, keepdim=True) for x in v], ax[-2])
            vhat = [x["vr"][..., None] * x["vc"][..., None, :]
                    / torch.clamp(d_ / whole[-2], min=1e-30)[..., None] for x, d_ in zip(v, den)]
        else:
            for t in range(n):
                v[t]["v"].copy_(dec[t] * v[t]["v"] + (1 - dec[t]) * g2[t])
            vhat = [x["v"] for x in v]
        upd = [x * torch.rsqrt(vh + 1e-30) for x, vh in zip(g, vhat)]
        split = tuple(a for e in ax for a in e)
        ms = psum([torch.sum(u * u) for u in upd], split)
        for t in range(n):
            rms = torch.sqrt(ms[t] / p0.numel() / math.prod(
                grid.shape[a] for a in split) + 1e-30)
            u = upd[t] / torch.clamp(rms, min=1.0)
            step = u + cfg.weight_decay * p[t].to(torch.float32)
            p[t].copy_(p[t].to(torch.float32) - lr[t] * step)
    for s in states:
        s["count"] = _count(s)
    return params, states


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
