"""Device grids for the CLI: the port's counterpart of :mod:`repro.launch.mesh`.

``make_device_grid(data, model, device)`` takes the first ``data * model``
devices of ``device``'s kind as a ``data x model`` grid.  On ``cuda`` each
tile gets a card of its own, and a host with fewer cards is refused: a card
is never repeated silently (a grid on one card is built on purpose with
:func:`repro_torch.core.distmatrix.make_context`).  On ``cpu`` every tile is
on the one CPU device.
"""

from __future__ import annotations

import torch

from repro_torch.core.distmatrix import DistContext, make_context
from repro_torch.device import resolve_device


def make_device_grid(data: int = 1, model: int = 1, device: str = "cuda") -> DistContext:
    """A ``data x model`` grid over the first ``data * model`` devices of ``device``."""
    if data < 1 or model < 1:
        raise ValueError(f"a device grid needs data, model >= 1, got {data}x{model}")
    dev = resolve_device(device)
    n = data * model
    if dev.type == "cpu":
        return make_context(["cpu"] * n, data)
    have = torch.cuda.device_count()
    if have < n:
        raise ValueError(f"a {data}x{model} grid needs {n} CUDA devices, but this host has "
                         f"{have}; pass --device cpu, or a smaller --data x --model")
    return make_context([torch.device("cuda", i) for i in range(n)], data)


def mesh_chip_count(ctx: DistContext) -> int:
    """The tiles of the grid (one per card on a CUDA grid built here)."""
    return ctx.n_row_shards * ctx.n_col_shards
