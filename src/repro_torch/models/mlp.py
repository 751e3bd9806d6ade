"""SwiGLU MLP (the dense FFN).  Port of :mod:`repro.models.mlp`.

On a device grid (:func:`apply_mlp_grid`) ``ff`` over ``model`` makes it
tensor-parallel: each tile runs :func:`apply_mlp` on its slice of d_ff and
the partial outputs are summed over ``model``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import collectives as coll
from repro_torch.models import common as cm
from repro_torch.models.common import ArchConfig, Params


def init_mlp(cfg: ArchConfig, gen: torch.Generator, *, d_ff: int | None = None,
             device=None) -> Params:
    f = d_ff or cfg.d_ff
    return Params({
        "w_gate": cm.dense_init(gen, (cfg.d_model, f), cfg.pdtype, device=device),
        "w_up": cm.dense_init(gen, (cfg.d_model, f), cfg.pdtype, device=device),
        "w_down": cm.dense_init(gen, (f, cfg.d_model), cfg.pdtype, device=device),
    })


def mlp_axes(cfg: ArchConfig) -> dict:
    """Logical axes of :func:`init_mlp`'s parameters, by name."""
    return {
        "w_gate": ("embed_p", "ff"),
        "w_up": ("embed_p", "ff"),
        "w_down": ("ff", "embed_p"),
    }


def apply_mlp(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    dt = cfg.cdtype
    g = x @ p.w_gate.to(dt)
    u = x @ p.w_up.to(dt)
    h = F.silu(g.to(torch.float32)).to(dt) * u
    return h @ p.w_down.to(dt)


def apply_mlp_grid(cfg: ArchConfig, run, p, x: coll.Sharded) -> coll.Sharded:
    """:func:`apply_mlp` on a grid (:class:`~repro_torch.models.common.GridRun`):
    ``x`` (B, S, d) per tile, laid out by ``(batch, seq, embed)``; ``w_gate``
    and ``w_up`` by their ``ff`` columns and ``w_down`` by its rows over
    ``ff``'s sanitized axes, the partials of ``w_down`` summed over them."""
    grid = run.grid
    tf = run.entry("ff", p.w_gate.shape[1])
    varying = coll.entry_axes(x.spec[0]) + coll.entry_axes(x.spec[1]) + tf
    xt = coll.pvary(x, grid, tf, run.path)
    w = run.tiles(p, {"w_gate": ((), tf), "w_up": ((), tf), "w_down": (tf, ())}, varying)
    ys = [apply_mlp(cfg, w[t], xt[t]) for t in range(grid.n_tiles)]
    return coll.Sharded(coll.all_reduce(ys, grid, tf, run.path), x.spec, x.shape)
