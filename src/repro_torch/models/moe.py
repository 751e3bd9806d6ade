"""Mixture-of-Experts with capacity-based dispatch, on one device.

Port of :mod:`repro.models.moe`.  Routing: a softmax router in fp32, the
top-k experts of each token, the token's place in its expert by an
exclusive cumsum over the token-major flattening ``(t * k, E)`` of all
``B * S`` tokens, tokens past the capacity dropped (Switch/GShard), the
combine weights renormalised over the top-k.  Dispatch and combine index an
(E, C + 1, d) buffer (a spare slot for the dropped tokens); the expert
products are batched matmuls on it (the JAX package has no Pallas kernel
here either).

The JAX package's mesh branches (``_apply_moe_gathered`` and the
``shard_map`` paths: expert parallelism, the FFN dim sharded, capacity per
batch shard) have no counterpart on one device: the port runs the
semantics of ``_moe_local`` with every expert local and one capacity over
all ``B * S`` tokens, as the JAX package does without a mesh.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import ArchConfig, Params


@dataclass
class Routing:
    """One call's routing over its ``t`` tokens (token-major, as the dispatch)."""

    logits: torch.Tensor  # (t, E) fp32, the router's
    probs: torch.Tensor  # (t, E) fp32, their softmax
    gate: torch.Tensor  # (t, k) fp32, the top-k probabilities renormalised
    expert_ids: torch.Tensor  # (t, k) int64
    position: torch.Tensor  # (t, k) int64, the slot in the expert's buffer
    keep: torch.Tensor  # (t, k) bool, position < capacity


_route_log: list | None = None


@contextmanager
def record_routing():
    """Collect the :class:`Routing` of every MoE layer (:func:`moe_forward`)
    run inside the block, in call order (the serve path records nothing otherwise)."""
    global _route_log
    prev, _route_log = _route_log, []
    try:
        yield _route_log
    finally:
        _route_log = prev


def init_moe(cfg: ArchConfig, gen: torch.Generator, device=None) -> Params:
    """Router (fp32 whatever ``param_dtype`` is), expert stacks (E, d, f) / (E, f, d),
    and the shared expert's MLP when the arch has one."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_expert or cfg.d_ff
    pd = cfg.pdtype
    t = {
        "router": cm.dense_init(gen, (d, e), torch.float32, device=device),
        "w_gate": cm.dense_init(gen, (e, d, f), pd, device=device),
        "w_up": cm.dense_init(gen, (e, d, f), pd, device=device),
        "w_down": cm.dense_init(gen, (e, f, d), pd, device=device),
    }
    children = {}
    if cfg.n_shared_experts:
        f_shared = (cfg.d_expert or cfg.d_ff) * cfg.n_shared_experts
        children["shared"] = mlp_mod.init_mlp(cfg, gen, d_ff=f_shared, device=device)
    return Params(t, **children)


def capacity(cfg: ArchConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens (the JAX package's ``cap_for``)."""
    c = int(cfg.capacity_factor * t * cfg.top_k / cfg.n_experts)
    return max(4, min(c, t))


def route(cfg: ArchConfig, p: Params, xt: torch.Tensor, cap: int) -> Routing:
    """Top-k routing of ``xt`` (t, d) with ``cap`` slots per expert."""
    t, k, e = xt.shape[0], cfg.top_k, cfg.n_experts
    logits = xt.to(torch.float32) @ p.router
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: by value, ties to the lower index (a stable sort)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = vals[:, :k], idx[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # exclusive cumsum over the token-major flattening (t * k, E), scanned
    # along the inner dim of its transpose: a cumsum down dim 0 runs one
    # sequential thread per expert on the card
    flat_t = F.one_hot(ids.reshape(t * k), e).t().contiguous()  # (e, t * k)
    pos_t = torch.cumsum(flat_t, dim=1) - flat_t
    position = pos_t.gather(0, ids.reshape(1, t * k)).reshape(t, k)
    return Routing(logits=logits, probs=probs, gate=gate, expert_ids=ids, position=position,
                   keep=position < cap)


def _moe_local(cfg: ArchConfig, p: Params, xt: torch.Tensor, cap: int):
    """Routing, dispatch, the expert FFNs and the combine; (y (t, d), routing)."""
    t, d = xt.shape
    dt = cfg.cdtype
    r = route(cfg, p, xt, cap)
    if _route_log is not None:
        _route_log.append(r)
    ids, keep = r.expert_ids, r.keep
    safe_pos = torch.where(keep, r.position, cap - 1)
    # each kept (expert, slot) receives exactly one token: an indexed write,
    # no accumulation.  Dropped tokens go to a spare slot ``cap`` that the
    # combine never reads (the JAX package adds zeros at cap - 1 instead);
    # no boolean mask, so no wait on the card for a count
    buf = torch.zeros((cfg.n_experts, cap + 1, d), dtype=dt, device=xt.device)
    buf[ids, torch.where(keep, r.position, cap)] = xt.to(dt)[:, None, :].expand(t, ids.shape[1], d)

    g = torch.bmm(buf, p.w_gate.to(dt))
    u = torch.bmm(buf, p.w_up.to(dt))
    h = F.silu(g.to(torch.float32)).to(dt) * u
    out_buf = torch.bmm(h, p.w_down.to(dt))

    gathered = out_buf[ids, safe_pos]  # (t, k, d)
    w = (r.gate * keep).to(torch.float32)[..., None]
    y = (gathered.to(torch.float32) * w).sum(dim=1).to(dt)
    return y, r


def apply_moe(cfg: ArchConfig, p: Params, x: torch.Tensor):
    """x (B, S, d) -> (y (B, S, d), aux with lb_loss / z_loss): :func:`moe_forward`
    and the JAX ``apply_moe``'s auxiliary losses from its routing."""
    y, r = moe_forward(cfg, p, x)
    me = r.probs.mean(dim=0)
    ce = (F.one_hot(r.expert_ids, cfg.n_experts).sum(1) > 0).to(torch.float32).mean(dim=0)
    aux = {"lb_loss": cfg.n_experts * torch.sum(me * ce),
           "z_loss": torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2)}
    return y, aux


def moe_forward(cfg: ArchConfig, p: Params, x: torch.Tensor):
    """x (B, S, d) -> (y (B, S, d), routing), without the aux losses (the serve
    path's MoE).  One capacity over all B * S tokens; the shared expert's MLP
    is added when the arch has one."""
    b, s, d = x.shape
    y, r = _moe_local(cfg, p, x.reshape(b * s, d), capacity(cfg, b * s))
    return _shared_expert_add(cfg, p, x, y.reshape(b, s, d)), r


def _shared_expert_add(cfg: ArchConfig, p: Params, x, y):
    """y (B, S, d) += shared-expert MLP(x) when the arch has one."""
    if cfg.n_shared_experts:
        return y + mlp_mod.apply_mlp(cfg, p.shared, x)
    return y
