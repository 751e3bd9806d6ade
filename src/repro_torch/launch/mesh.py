"""Device grids: the port's counterpart of :mod:`repro.launch.mesh`.

``make_device_grid(data, model, device)`` takes the first ``data * model``
devices of ``device``'s kind as a ``data x model`` grid.  On ``cuda`` each
tile gets a card of its own, and a host with fewer cards is refused: a card
is never repeated silently (a grid on one card is built on purpose with
:func:`repro_torch.core.distmatrix.make_context`).  On ``cpu`` every tile is
on the one CPU device, on ``meta`` (the dry run) on the meta device.

``make_production_mesh(multi_pod)`` is the production layout as a logical
grid of axis names and sizes (:class:`LogicalGrid`), which holds no devices:
the dry run (:mod:`repro_torch.launch.dryrun`) turns the sharding rules into
per-tile shapes on it, each tile standing for one H100 80GB.

Single pod:  (16, 16)    = 256 tiles, axes ("data", "model")
Multi pod:   (2, 16, 16) = 512 tiles, axes ("pod", "data", "model")

``"data"`` carries the batch (and the FSDP weight shard inside a pod),
``"model"`` the tensor-parallel / expert / flash-decode sequence shards,
``"pod"`` pure data parallelism across pods.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.distmatrix import DistContext, make_context
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class LogicalGrid:
    """A grid of named axes and their sizes, with no devices behind it."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or min(self.sizes, default=0) < 1:
            raise ValueError(f"a grid needs one size >= 1 per axis, got {self.axis_names} "
                             f"{self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> LogicalGrid:
    if multi_pod:
        return LogicalGrid(("pod", "data", "model"), (2, 16, 16))
    return LogicalGrid(("data", "model"), (16, 16))


def make_device_grid(data: int = 1, model: int = 1, device: str = "cuda") -> DistContext:
    """A ``data x model`` grid over the first ``data * model`` devices of ``device``."""
    if data < 1 or model < 1:
        raise ValueError(f"a device grid needs data, model >= 1, got {data}x{model}")
    dev = resolve_device(device)
    n = data * model
    if dev.type in ("cpu", "meta"):
        return make_context([dev.type] * n, data)
    have = torch.cuda.device_count()
    if have < n:
        raise ValueError(f"a {data}x{model} grid needs {n} CUDA devices, but this host has "
                         f"{have}; pass --device cpu, or a smaller --data x --model")
    return make_context([torch.device("cuda", i) for i in range(n)], data)


def mesh_chip_count(grid: LogicalGrid | DistContext) -> int:
    """The tiles of a grid: a :class:`LogicalGrid`'s product of axis sizes, or
    a :class:`DistContext`'s R x C (one per card on a CUDA grid built here)."""
    if isinstance(grid, LogicalGrid):
        return math.prod(grid.sizes)
    return grid.n_row_shards * grid.n_col_shards
