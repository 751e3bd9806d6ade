"""SwiGLU MLP (the dense FFN).  Port of :mod:`repro.models.mlp`."""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def apply_mlp(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    dt = cfg.cdtype
    g = x @ p.w_gate.to(dt)
    u = x @ p.w_up.to(dt)
    h = F.silu(g.to(torch.float32)).to(dt) * u
    return h @ p.w_down.to(dt)
