"""Device grids: the port's counterpart of :mod:`repro.launch.mesh`.

``make_device_grid(data, model, device)`` takes the first ``data * model``
devices of ``device``'s kind as a ``data x model`` grid.  On ``cuda`` each
tile gets a card of its own, and a host with fewer cards is refused: a card
is never repeated silently (a grid on one card is built on purpose with
:func:`repro_torch.core.distmatrix.make_context`).  On ``cpu`` every tile is
on the one CPU device, on ``meta`` (the dry run) on the meta device.

``make_cpu_mesh(data, model, pod, device)`` is a :class:`DeviceGrid` whose
every tile sits on the one ``device`` (the CPU by default): axes
``("data", "model")``, or ``("pod", "data", "model")`` with ``pod > 0``.  The
LM substrate's grid paths (the sharded forward, serving, the train step and
the int8 pod sync) run on it; ``grid.context(pod=i)`` is pod ``i``'s
``data x model`` :class:`~repro_torch.core.distmatrix.DistContext`, the
grid the CADDeLaG paths take.

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

import itertools
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


@dataclass(frozen=True)
class DeviceGrid:
    """A grid of devices with named axes, one process driving every tile.

    ``pods`` holds one ``data x model`` :class:`DistContext` per pod; with
    ``pod_axis`` the axes are ``("pod", "data", "model")``, else
    ``("data", "model")`` over the one context.  Tiles are numbered
    row-major over the axes (pod, then data, then model): a value on the
    grid is a list of tensors in that order (:mod:`repro_torch.core.collectives`).
    A grid may repeat a device, as a :class:`DistContext` may.
    """

    pods: tuple[DistContext, ...]
    pod_axis: bool = False

    def __post_init__(self):
        if not self.pods or (not self.pod_axis and len(self.pods) != 1):
            raise ValueError(f"a grid without a pod axis holds one context, got {len(self.pods)}")
        shapes = {(c.n_row_shards, c.n_col_shards) for c in self.pods}
        if len(shapes) != 1:
            raise ValueError(f"every pod needs the same data x model shape, got {shapes}")

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("pod", "data", "model") if self.pod_axis else ("data", "model")

    @property
    def sizes(self) -> tuple[int, ...]:
        c = self.pods[0]
        rc = (c.n_row_shards, c.n_col_shards)
        return (len(self.pods), *rc) if self.pod_axis else rc

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def n_tiles(self) -> int:
        return math.prod(self.sizes)

    @property
    def is_trivial(self) -> bool:
        return self.n_tiles == 1

    @property
    def devices(self) -> list[torch.device]:
        """Every tile's device, in tile order."""
        return [d for c in self.pods for row in c.devices for d in row]

    @property
    def home(self) -> torch.device:
        return self.pods[0].home

    def context(self, pod: int = 0) -> DistContext:
        """Pod ``pod``'s ``data x model`` grid (the whole grid without a pod axis)."""
        return self.pods[pod]

    def coords(self, t: int) -> dict[str, int]:
        """Tile ``t``'s coordinate on every axis."""
        out = {}
        for name, size in zip(reversed(self.axis_names), reversed(self.sizes)):
            t, out[name] = divmod(t, size)
        return {n: out[n] for n in self.axis_names}

    def index(self, coords: dict[str, int]) -> int:
        t = 0
        for name, size in zip(self.axis_names, self.sizes):
            t = t * size + coords[name]
        return t

    def groups(self, axes) -> list[list[int]]:
        """The tiles that differ only along ``axes``, one list for each
        position on the other axes; within a list, row-major over ``axes`` in
        the order given (a spec entry's order: its first axis major)."""
        axes = tuple(axes)
        other = [a for a in self.axis_names if a not in axes]
        out = []
        for oc in itertools.product(*(range(self.shape[a]) for a in other)):
            base = dict(zip(other, oc))
            out.append([self.index({**base, **dict(zip(axes, ac))})
                        for ac in itertools.product(*(range(self.shape[a]) for a in axes))])
        return out

    def position(self, t: int, axes) -> int:
        """Tile ``t``'s place along ``axes`` (row-major, the first axis major)."""
        c = self.coords(t)
        p = 0
        for a in axes:
            p = p * self.shape[a] + c[a]
        return p


def as_grid(grid) -> DeviceGrid:
    """A :class:`DeviceGrid` from a grid or a ``data x model`` :class:`DistContext`."""
    if isinstance(grid, DeviceGrid):
        return grid
    if isinstance(grid, DistContext):
        return DeviceGrid((grid,))
    raise TypeError(f"not a device grid: {grid!r}")


def make_cpu_mesh(data: int = 1, model: int = 1, pod: int = 0, device="cpu") -> DeviceGrid:
    """A ``data x model`` grid (``pod x data x model`` with ``pod > 0``) with
    every tile on ``device``: the CPU by default, as the tests run it; a card
    named on purpose hosts the whole grid on that one card."""
    if data < 1 or model < 1 or pod < 0:
        raise ValueError(f"a grid needs data, model >= 1 and pod >= 0, got {pod}x{data}x{model}")
    dev = resolve_device(device)
    ctx = make_context([dev] * (data * model), data)
    return DeviceGrid((ctx,) * pod, pod_axis=True) if pod else DeviceGrid((ctx,))


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


def mesh_chip_count(grid: LogicalGrid | DeviceGrid | DistContext) -> int:
    """The tiles of a grid: a :class:`LogicalGrid`'s or :class:`DeviceGrid`'s
    product of axis sizes, or a :class:`DistContext`'s R x C (one per card on
    a CUDA grid built here)."""
    if isinstance(grid, (LogicalGrid, DeviceGrid)):
        return math.prod(grid.sizes)
    return grid.n_row_shards * grid.n_col_shards
