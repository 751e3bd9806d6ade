"""Mixture-of-Experts with capacity-based dispatch.

Port of :mod:`repro.models.moe`.  Routing: a softmax router in fp32, the
top-k experts of each token, the token's place in its expert by an
exclusive cumsum over the token-major flattening ``(t * k, E)`` of the
call's tokens, tokens past the capacity dropped (Switch/GShard), the
combine weights renormalised over the top-k.  Dispatch and combine index an
(E + 1, C + 1, d) buffer (a spare row for the experts another tile owns, a
spare slot for the dropped tokens); the expert products are batched
matmuls on it (the JAX package has no Pallas kernel here either).

On one device every expert is local and one capacity covers all ``B * S``
tokens, as the JAX package runs without a mesh.  On a device grid
(:func:`apply_moe_grid`) the port runs each branch of the JAX ``apply_moe``
on a mesh, with its choices and fallbacks:

- expert parallelism: the experts over ``experts``' axis, each tile routing
  its batch shard's tokens (capacity per batch shard) to all ``E`` experts
  and running those it owns, the partial outputs summed over that axis;
- the expert FFN dim over ``expert_ff``'s axis when the experts are not
  sharded (granite-moe's override), the partials of ``w_down`` summed;
- with ``moe_gathered`` (the serve engine's decode rules) the tokens
  gathered over the batch axes with one capacity over all of them, the
  weights in their 2-axis storage (experts over ``experts``' axis, d_model
  over ``expert_embed``'s), the gate and up products summed over the d
  axis and the output over the expert axis; it becomes one of the two
  above when the experts, d_model or the batch do not divide their axes.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from repro_torch.core import collectives as coll
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


def compare_routings(got: list, want: list, margin: float) -> list[dict]:
    """Hold the routings one prefill recorded (:func:`record_routing`) against
    another's on the same weights and tokens (on another device, say).

    Each entry is a layer's :class:`Routing`, or on a grid a list of one a
    tile.  Expert ids and kept masks must be equal, except that a choice may
    flip where ``want``'s two probabilities lie within ``margin``.  Positions
    are cumsums in token order and a token reads only the tokens before it,
    so from a tile's first flipped token on nothing more of that tile is
    compared, in that layer or a later one; its other tokens and the other
    tiles still are.  Returns a record per layer and tile; raises
    ``ValueError`` on a difference."""
    if len(got) != len(want):
        raise ValueError(f"{len(got)} MoE calls against {len(want)}")
    first: dict[int, int] = {}  # a tile's first flipped token so far
    out = []
    for li, (gl, wl) in enumerate(zip(got, want)):
        gl, wl = (gl, wl) if isinstance(gl, list) else ([gl], [wl])
        if len(gl) != len(wl):
            raise ValueError(f"layer {li}: {len(gl)} tiles against {len(wl)}")
        for ti, (rg, rw) in enumerate(zip(gl, wl)):
            n = first.get(ti, rw.expert_ids.shape[0])
            ig, iw = rg.expert_ids[:n].cpu(), rw.expert_ids[:n].cpu()
            rec = {"layer": li, "tile": ti, "compared_tokens": n, "flips": 0,
                   "dropped": int((~rw.keep).sum())}
            rows, cols = (ig != iw).nonzero(as_tuple=True)
            if len(rows):
                probs = rw.probs.cpu()
                gap = (probs[rows, ig[rows, cols]] - probs[rows, iw[rows, cols]]).abs()
                if float(gap.max()) > margin:
                    raise ValueError(f"layer {li} tile {ti}: {len(rows)} routing flips, the "
                                     f"widest between probabilities {float(gap.max()):.3e} "
                                     f"apart (> {margin:g})")
                n = first[ti] = int(rows.min())
                rec |= {"flips": len(rows), "max_margin": float(gap.max()),
                        "first_flipped_token": n}
            if not torch.equal(rg.keep[:n].cpu(), rw.keep[:n].cpu()):
                raise ValueError(f"layer {li} tile {ti}: kept masks differ before token {n}")
            out.append(rec)
    return out


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


def moe_axes(cfg: ArchConfig) -> dict:
    """Logical axes of :func:`init_moe`'s parameters, by name."""
    ax = {
        "router": ("embed_p", "experts"),
        "w_gate": ("experts", "expert_embed", "expert_ff"),
        "w_up": ("experts", "expert_embed", "expert_ff"),
        "w_down": ("experts", "expert_ff", "expert_embed"),
    }
    if cfg.n_shared_experts:
        ax["shared"] = mlp_mod.mlp_axes(cfg)
    return ax


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


def _dispatch(cfg: ArchConfig, r: Routing, xt, cap: int, e_loc: int, e_off: int):
    """The (e_loc, cap + 1, d) buffer of the experts ``[e_off, e_off + e_loc)``
    from ``xt`` (t, d) by the routing ``r``; returns (buffer, the tokens'
    local expert ids, which of them this call owns).

    Each kept (expert, slot) receives exactly one token: an indexed write,
    no accumulation.  Tokens routed to an expert this call does not own go
    to a spare row ``e_loc`` and dropped tokens to the spare slot ``cap``
    (the JAX package adds zeros out of bounds and at ``cap - 1`` instead);
    neither is read back, and no boolean mask makes the card wait for a count.
    """
    t, d = xt.shape
    local = r.expert_ids - e_off
    owned = (local >= 0) & (local < e_loc)
    buf = torch.zeros((e_loc + 1, cap + 1, d), dtype=cfg.cdtype, device=xt.device)
    buf[torch.where(owned, local, e_loc), torch.where(r.keep, r.position, cap)] = \
        xt.to(cfg.cdtype)[:, None, :].expand(t, local.shape[1], d)
    return buf[:e_loc], local, owned


def _combine(cfg: ArchConfig, r: Routing, gate, out_buf, local, owned, cap: int):
    """y (t, d_out) in the compute dtype: each token's owned, kept experts'
    outputs from ``out_buf`` (e_loc, cap + 1, d_out), weighted by ``gate``."""
    gathered = out_buf[local.clamp(0, out_buf.shape[0] - 1),
                       torch.where(r.keep, r.position, cap - 1)]
    wt = (gate * (owned & r.keep)).to(torch.float32)[..., None]
    return (gathered.to(torch.float32) * wt).sum(dim=1).to(cfg.cdtype)


def _experts(cfg: ArchConfig, r: Routing, gate, xt, w, cap: int, e_loc: int, e_off: int = 0):
    """Dispatch ``xt`` (t, d), run the ``e_loc`` experts from ``e_off`` whose
    weights are ``w`` (``w_gate``, ``w_up``: (e_loc, d, f), ``w_down``:
    (e_loc, f, d)) and combine with ``gate`` (t, k); y (t, d)."""
    dt = cfg.cdtype
    buf, local, owned = _dispatch(cfg, r, xt, cap, e_loc, e_off)
    g = torch.bmm(buf, w.w_gate.to(dt))
    u = torch.bmm(buf, w.w_up.to(dt))
    h = F.silu(g.to(torch.float32)).to(dt) * u
    return _combine(cfg, r, gate, torch.bmm(h, w.w_down.to(dt)), local, owned, cap)


def _moe_local(cfg: ArchConfig, p: Params, xt: torch.Tensor, cap: int):
    """Routing, dispatch, the expert FFNs and the combine; (y (t, d), routing)."""
    r = route(cfg, p, xt, cap)
    if _route_log is not None:
        _route_log.append(r)
    return _experts(cfg, r, r.gate, xt, p, cap, cfg.n_experts), r


def aux_losses(cfg: ArchConfig, r: Routing) -> dict:
    """The JAX ``_moe_local``'s load-balancing and router z losses of a routing."""
    me = r.probs.mean(dim=0)
    ce = (F.one_hot(r.expert_ids, cfg.n_experts).sum(1) > 0).to(torch.float32).mean(dim=0)
    return {"lb_loss": cfg.n_experts * torch.sum(me * ce),
            "z_loss": torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2)}


def apply_moe(cfg: ArchConfig, p: Params, x: torch.Tensor):
    """x (B, S, d) -> (y (B, S, d), aux with lb_loss / z_loss): :func:`moe_forward`
    and the JAX ``apply_moe``'s auxiliary losses from its routing."""
    y, r = moe_forward(cfg, p, x)
    return y, aux_losses(cfg, r)


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


# ---------------------------------------------------------------------------
# on a device grid
# ---------------------------------------------------------------------------


def _batch_axes(rules: dict, grid) -> tuple:
    """The grid axes of the ``batch`` rule (the JAX ``apply_moe``'s ``batch_axes``)."""
    return tuple(a for a in coll.entry_axes(rules.get("batch")) if a in grid.axis_names)


def _record(rs: list) -> None:
    """Log a grid call's routing: one :class:`Routing` a tile, in tile order."""
    if _route_log is not None:
        _route_log.append(rs)


def apply_moe_grid(cfg: ArchConfig, run, p, x: coll.Sharded):
    """The JAX ``apply_moe`` on a mesh, on a grid (:class:`~repro_torch.models.common.GridRun`):
    ``x`` (B, S, d) per tile, laid out by ``(batch, seq, embed)``; ``p`` the
    layer's per-tile parameters as stored.  Returns (y laid out as ``x``,
    aux with ``lb_loss`` / ``z_loss`` as per-tile lists, the same value on
    every tile).

    With ``moe_gathered`` in the rules and the experts, d_model and the
    batch each dividing their axes, the gathered path (the JAX
    ``_apply_moe_gathered``); otherwise the batch shards' path: capacity per
    batch shard (the batch axes dropped when B does not divide them), the
    experts over ``experts``' axis when E divides it, else the FFN dim over
    ``expert_ff``'s when f divides it, else every expert whole on every tile.
    The aux losses are the mean over the batch shards.
    """
    rules, grid = run.rules, run.grid
    b, _, d = x.shape
    e = cfg.n_experts
    sizes = grid.shape
    if rules.get("moe_gathered"):
        e_ax, d_ax = rules.get("experts"), rules.get("expert_embed")
        d_ax = d_ax if isinstance(d_ax, str) else None
        batch_axes = _batch_axes(rules, grid)
        ok = (e_ax in grid.axis_names and e % sizes[e_ax] == 0
              and d_ax in grid.axis_names and d % sizes[d_ax] == 0
              and batch_axes and b % math.prod(sizes[a] for a in batch_axes) == 0)
        if ok:
            y, aux = _moe_gathered_grid(cfg, run, p, x, e_ax, d_ax, batch_axes)
            return _shared_add_grid(cfg, run, p, x, y), aux
        run = cm.GridRun({k: v for k, v in rules.items() if k != "moe_gathered"})
    y, aux = _moe_sharded_grid(cfg, run, p, x)
    return _shared_add_grid(cfg, run, p, x, y), aux


def _moe_sharded_grid(cfg: ArchConfig, run, p, x: coll.Sharded):
    """The JAX ``apply_moe``'s ``shard_map`` branch (capacity per batch shard).

    Each tile routes its batch shard's tokens with the whole router; the
    routing is the same on every tile of a batch shard, and only the expert
    products differ along the expert (or FFN) axis, so the tokens and the
    gate enter them through ``pvary`` and the router reads them as they are.
    """
    rules, grid, path = run.rules, run.grid, run.path
    b, s, d = x.shape
    e = cfg.n_experts
    sizes = grid.shape
    batch_axes = _batch_axes(rules, grid)
    if batch_axes and b % math.prod(sizes[a] for a in batch_axes):
        batch_axes = ()
    n_batch = math.prod(sizes[a] for a in batch_axes)
    cap = capacity(cfg, b * s // n_batch)
    e_ax = rules.get("experts")
    if e_ax is not None and e % sizes.get(e_ax, 1):
        e_ax = None
    f_ax = rules.get("expert_ff") if e_ax is None else None
    if f_ax is not None and (cfg.d_expert or cfg.d_ff) % sizes.get(f_ax, 1):
        f_ax = None
    ea, fa = coll.entry_axes(e_ax), coll.entry_axes(f_ax)
    red = ea + fa
    e_loc = e // math.prod(sizes[a] for a in ea)

    xb = coll.relayout(x, (batch_axes or None, None, None), grid, path, varying=batch_axes)
    xd = coll.pvary(xb, grid, red, path)
    router = run.param(p.router, ((), ()), batch_axes)
    w = {k: run.param(getattr(p, k), ents, batch_axes + red)
         for k, ents in (("w_gate", (ea, (), fa)), ("w_up", (ea, (), fa)),
                         ("w_down", (ea, fa, ())))}
    rs = [route(cfg, SimpleNamespace(router=router[t]), xb[t].reshape(-1, d), cap)
          for t in range(grid.n_tiles)]
    _record(rs)
    gates = coll.pvary([r.gate for r in rs], grid, red, path)
    ys = []
    for t in range(grid.n_tiles):
        wt = SimpleNamespace(**{k: v[t] for k, v in w.items()})
        y = _experts(cfg, rs[t], gates[t], xd[t].reshape(-1, d), wt, cap, e_loc,
                     grid.position(t, ea) * e_loc)
        ys.append(y.reshape(xb[t].shape))
    ys = coll.all_reduce(ys, grid, red, path)
    y = coll.relayout(coll.Sharded(ys, xb.spec, xb.shape), x.spec, grid, path,
                      varying=_spec_axes(x))
    auxes = [aux_losses(cfg, r) for r in rs]
    aux = {k: coll.pmean([a[k] for a in auxes], grid, batch_axes, path)
           for k in ("lb_loss", "z_loss")}
    return y, aux


def _moe_gathered_grid(cfg: ArchConfig, run, p, x: coll.Sharded, e_ax: str, d_ax: str,
                       batch_axes: tuple):
    """The JAX ``_apply_moe_gathered``: move the tokens, never the weights.

    The tokens are gathered over the batch axes (one capacity over all of
    them; the routing is the same on every tile); tile (d slice i, experts
    j) dispatches d-slice i of the tokens to its experts, its gate and up
    partials are summed over the d axis, its output slice over the expert
    axis; the (B, S, d / n_d) result is laid back out as ``x``.  Entering
    moves no weight bytes but the router's.
    """
    grid, path = run.grid, run.path
    b, s, d = x.shape
    e = cfg.n_experts
    e_loc, d_loc = e // grid.shape[e_ax], d // grid.shape[d_ax]
    t_all = b * s
    cap = capacity(cfg, t_all)
    xb = coll.relayout(x, (batch_axes, None, None), grid, path, varying=batch_axes)
    xg = coll.all_gather(xb, grid, batch_axes, 0, path, invariant=True)
    xd = coll.pvary(xg, grid, (e_ax, d_ax), path)
    router = run.param(p.router, ((), ()), ())
    both = (e_ax, d_ax)
    w = {k: run.param(getattr(p, k), ents, both)
         for k, ents in (("w_gate", ((e_ax,), (d_ax,), ())), ("w_up", ((e_ax,), (d_ax,), ())),
                         ("w_down", ((e_ax,), (), (d_ax,))))}
    rs = [route(cfg, SimpleNamespace(router=router[t]), xg[t].reshape(t_all, d), cap)
          for t in range(grid.n_tiles)]
    _record(rs)
    gates = coll.pvary([r.gate for r in rs], grid, both, path)
    dt = cfg.cdtype
    gs, us, owns = [], [], []
    for t in range(grid.n_tiles):
        i0 = grid.position(t, (d_ax,)) * d_loc
        xt = xd[t].reshape(t_all, d)[:, i0:i0 + d_loc]
        buf, local, owned = _dispatch(cfg, rs[t], xt, cap, e_loc,
                                      grid.position(t, (e_ax,)) * e_loc)
        gs.append(torch.bmm(buf, w["w_gate"][t].to(dt)))
        us.append(torch.bmm(buf, w["w_up"][t].to(dt)))
        owns.append((local, owned))
    gs = coll.all_reduce(gs, grid, (d_ax,), path)
    us = coll.all_reduce(us, grid, (d_ax,), path)
    hs = coll.pvary([F.silu(g.to(torch.float32)).to(dt) * u for g, u in zip(gs, us)],
                    grid, (d_ax,), path)
    ys = [_combine(cfg, rs[t], gates[t], torch.bmm(hs[t], w["w_down"][t].to(dt)), *owns[t],
                   cap).reshape(b, s, d_loc) for t in range(grid.n_tiles)]
    ys = coll.all_reduce(ys, grid, (e_ax,), path)
    y = coll.relayout(coll.Sharded(ys, (None, None, (d_ax,)), (b, s, d)), x.spec, grid, path,
                      varying=_spec_axes(x))
    auxes = [aux_losses(cfg, r) for r in rs]
    return y, {k: [a[k] for a in auxes] for k in ("lb_loss", "z_loss")}


def _spec_axes(x: coll.Sharded) -> tuple:
    return tuple(a for e in x.spec for a in coll.entry_axes(e))


def _shared_add_grid(cfg: ArchConfig, run, p, x: coll.Sharded, y: coll.Sharded) -> coll.Sharded:
    """y += the shared expert's MLP of ``x`` on the grid, when the arch has one."""
    if not cfg.n_shared_experts:
        return y
    z = mlp_mod.apply_mlp_grid(cfg, run, p.shared, x)
    return coll.Sharded([a + c for a, c in zip(y, z)], y.spec, y.shape)
