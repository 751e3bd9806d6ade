"""Collectives over a one-process device grid, in lockstep over its tiles.

A value on a grid (:class:`repro_torch.launch.mesh.DeviceGrid`) is a list
of tensors, one per tile in the grid's tile order; :class:`Sharded` is such
a list that also carries its layout (a :class:`~repro_torch.models.common.Spec`
over the grid's axis names) and its whole shape.  A collective is a
function over such a list.  Each differentiable one is a
``torch.autograd.Function`` whose backward is its dual, as ``shard_map``
transposes them in the JAX package:

- :func:`all_gather` -- concatenate the tiles along ``axes`` on every one of
  them; backward a reduce-scatter (the gathered value feeds computation that
  differs from tile to tile, so each tile's gradient is a partial sum);
  with ``invariant=True`` (the gathered value feeds the same computation on
  every tile) the backward takes each tile's own slice;
- :func:`all_reduce` -- the sum over ``axes`` on every tile; backward the
  identity (the result is the same on every tile, so is its gradient);
- :func:`pvary` -- the identity; backward an all-reduce: a value that is
  the same on every tile along ``axes`` enters computation that differs
  along them (Megatron's "copy to the tensor-parallel region");
- :func:`reduce_scatter` -- the sum, each tile keeping its slice; backward
  an all-gather;
- :func:`pmean` -- :func:`all_reduce` over the count.

Autograd through them yields per-tile gradients that are already summed
where they must be.  Every sum runs in the group's fixed tile order on each
receiving tile, with no atomics: two runs are bitwise equal and the copies
of a replicated result are bitwise equal to each other.  On axes of size 1
(a 1x1 grid) every collective is the identity.

Every move is counted in the obs registry, by path (``lm.serve``,
``lm.train``, ``lm.pod``) and kind (``gather``, ``reduce``,
``reduce_scatter``, ``permute``): ``<path>.<kind>_bytes`` and
``<path>.<kind>s``.  A move counts by logical grid position, as
``distmatrix`` counts its tiles: tiles that share a device count what a grid
of distinct cards would move, though no copy is made.  Along a group of
``n`` tiles, a gather or an all-reduce brings each tile the ``n - 1`` other
tiles' parts (``n (n - 1)`` parts a group); a reduce-scatter brings each
tile the ``n - 1`` others' partials of its own slice.  Forward and backward
both count.  :func:`lm_moves` reads the counters.
"""

from __future__ import annotations

import math

import torch

from repro_torch.obs import REGISTRY

KINDS = ("gather", "reduce", "reduce_scatter", "permute")
PATHS = ("lm.serve", "lm.train", "lm.pod")


def _count(path: str, kind: str, nbytes: float, calls: int = 1) -> None:
    REGISTRY.add_named({f"{path}.{kind}_bytes": float(nbytes), f"{path}.{kind}s": float(calls)})


def lm_moves(registry=REGISTRY, paths=PATHS) -> dict:
    """Bytes and calls moved between grid positions so far, by path and kind:
    ``{path: {"gather_bytes", "gathers", ...}}`` (process-wide counters; take
    a difference around a run)."""
    return {p: {f"{k}{suffix}": registry.value(f"{p}.{k}{suffix}")
                for k in KINDS for suffix in ("_bytes", "s")} for p in paths}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Sharded(list):
    """Per-tile tensors (a list in tile order) with their layout.

    ``spec`` has one entry per dimension: ``None`` (whole on every tile) or a
    tuple of grid axis names (the dimension split over their product, the
    first axis major).  ``shape`` is the whole tensor's shape.
    """

    def __init__(self, tiles, spec, shape):
        super().__init__(tiles)
        self.spec = tuple(entry_axes(e) or None for e in spec)
        self.shape = tuple(shape)


def entry_axes(entry) -> tuple:
    """A spec entry as a tuple of axis names (``()`` for replicated)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _live(grid, axes) -> tuple:
    """``axes`` without those of size 1."""
    return tuple(a for a in entry_axes(axes) if grid.shape[a] > 1)


def _size(grid, axes) -> int:
    return math.prod(grid.shape[a] for a in axes)


def _sum_into(parts: list, dev: torch.device) -> torch.Tensor:
    """The sum of ``parts`` in list order, on ``dev``."""
    acc = parts[0].to(dev)
    for p in parts[1:]:
        acc = acc + p.to(dev)
    return acc


def _gather_fwd(tiles, grid, axes, dim):
    out = [None] * len(tiles)
    for grp in grid.groups(axes):
        parts = [tiles[i] for i in grp]
        for i in grp:
            dev = tiles[i].device
            out[i] = torch.cat([p.to(dev) for p in parts], dim=dim)
    return out


def _scatter_sum(grads, grid, axes, dim):
    """Each tile's slice of the sum over its group (the group's order)."""
    out = [None] * len(grads)
    for grp in grid.groups(axes):
        n = len(grp)
        w = grads[grp[0]].shape[dim] // n
        for a, i in enumerate(grp):
            out[i] = _sum_into([grads[j].narrow(dim, a * w, w) for j in grp], grads[i].device)
    return out


def _reduce_fwd(tiles, grid, axes):
    out = [None] * len(tiles)
    for grp in grid.groups(axes):
        for i in grp:
            out[i] = _sum_into([tiles[j] for j in grp], tiles[i].device)
    return out


def _own_slice(grads, grid, axes, dim):
    out = []
    for t, g in enumerate(grads):
        n = _size(grid, axes)
        w = g.shape[dim] // n
        out.append(g.narrow(dim, grid.position(t, axes) * w, w).contiguous())
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, axes, dim, path, invariant, *tiles):
        ctx.meta = (grid, axes, dim, path, invariant)
        n = _size(grid, axes)
        _count(path, "gather", (n - 1) * sum(_nbytes(t) for t in tiles))
        return tuple(_gather_fwd(list(tiles), grid, axes, dim))

    @staticmethod
    def backward(ctx, *grads):
        grid, axes, dim, path, invariant = ctx.meta
        if invariant:
            return (None,) * 5 + tuple(_own_slice(list(grads), grid, axes, dim))
        n = _size(grid, axes)
        _count(path, "reduce_scatter", (n - 1) * sum(_nbytes(g) for g in grads) / n)
        return (None,) * 5 + tuple(_scatter_sum(list(grads), grid, axes, dim))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, axes, dim, path, *tiles):
        ctx.meta = (grid, axes, dim, path)
        n = _size(grid, axes)
        _count(path, "reduce_scatter", (n - 1) * sum(_nbytes(t) for t in tiles) / n)
        return tuple(_scatter_sum(list(tiles), grid, axes, dim))

    @staticmethod
    def backward(ctx, *grads):
        grid, axes, dim, path = ctx.meta
        n = _size(grid, axes)
        _count(path, "gather", (n - 1) * sum(_nbytes(g) for g in grads))
        return (None,) * 4 + tuple(_gather_fwd(list(grads), grid, axes, dim))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, axes, path, scale, *tiles):
        ctx.scale = scale
        n = _size(grid, axes)
        _count(path, "reduce", (n - 1) * sum(_nbytes(t) for t in tiles))
        out = _reduce_fwd(list(tiles), grid, axes)
        return tuple(out if scale == 1.0 else [o * scale for o in out])

    @staticmethod
    def backward(ctx, *grads):
        s = ctx.scale
        return (None,) * 4 + tuple(g if s == 1.0 else g * s for g in grads)


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, axes, path, *tiles):
        ctx.meta = (grid, axes, path)
        return tuple(t.view_as(t) for t in tiles)

    @staticmethod
    def backward(ctx, *grads):
        grid, axes, path = ctx.meta
        n = _size(grid, axes)
        _count(path, "reduce", (n - 1) * sum(_nbytes(g) for g in grads))
        return (None,) * 3 + tuple(_reduce_fwd(list(grads), grid, axes))


def _spec_after(x, dim, axes, gathered: bool):
    if not isinstance(x, Sharded):
        return None
    spec = list(x.spec) + [None] * (len(x.shape) - len(x.spec))
    shape = list(x.shape)
    cur = entry_axes(spec[dim])
    if gathered:
        spec[dim] = tuple(a for a in cur if a not in axes) or None
    else:
        spec[dim] = (cur + tuple(axes)) or None
    return spec, shape


def _wrap(out, x, after):
    return Sharded(out, *after) if after is not None else list(out)


def all_gather(x, grid, axes, dim: int, path: str, *, invariant: bool = False):
    """Tiles concatenated along ``dim`` over ``axes`` (row-major, the first
    axis major), on every tile of each group."""
    axes = _live(grid, axes)
    dim = dim % x[0].ndim
    if not axes:
        return x
    out = _AllGather.apply(grid, axes, dim, path, invariant, *x)
    return _wrap(out, x, _spec_after(x, dim, axes, gathered=True))


def reduce_scatter(x, grid, axes, dim: int, path: str):
    """The sum over ``axes``, each tile keeping its slice along ``dim``."""
    axes = _live(grid, axes)
    dim = dim % x[0].ndim
    if not axes:
        return x
    out = _ReduceScatter.apply(grid, axes, dim, path, *x)
    return _wrap(out, x, _spec_after(x, dim, axes, gathered=False))


def all_reduce(x, grid, axes, path: str):
    """The sum over ``axes`` (each group's tile order) on every tile."""
    axes = _live(grid, axes)
    if not axes:
        return x
    return _wrap(_AllReduce.apply(grid, axes, path, 1.0, *x), x,
                 (x.spec, x.shape) if isinstance(x, Sharded) else None)


def pmean(x, grid, axes, path: str):
    """The mean over ``axes``: :func:`all_reduce` times ``1 / n``."""
    axes = _live(grid, axes)
    if not axes:
        return x
    return _wrap(_AllReduce.apply(grid, axes, path, 1.0 / _size(grid, axes), *x), x,
                 (x.spec, x.shape) if isinstance(x, Sharded) else None)


def pvary(x, grid, axes, path: str):
    """The identity, whose backward sums the tiles' gradients over ``axes``
    (nothing to do where no gradient can reach ``x``)."""
    axes = _live(grid, axes)
    if not axes or not (torch.is_grad_enabled() and any(t.requires_grad for t in x)):
        return x
    return _wrap(_Pvary.apply(grid, axes, path, *x), x,
                 (x.spec, x.shape) if isinstance(x, Sharded) else None)


@torch.no_grad()
def all_max(x, grid, axes, path: str) -> list:
    """The elementwise max over ``axes`` on every tile (no gradient)."""
    axes = _live(grid, axes)
    if not axes:
        return list(x)
    _count(path, "reduce", (_size(grid, axes) - 1) * sum(_nbytes(t) for t in x))
    out = [None] * len(x)
    for grp in grid.groups(axes):
        for i in grp:
            acc = x[grp[0]].to(x[i].device)
            for j in grp[1:]:
                acc = torch.maximum(acc, x[j].to(x[i].device))
            out[i] = acc
    return out


@torch.no_grad()
def lse_merge(parts: list, grid, axes, path: str) -> list:
    """Flash-decode's combine: each tile's partial softmax statistics
    ``(m, l, o)`` (the running max, the sum of exp(s - m), the unnormalized
    output) merged over ``axes`` in tile order into the normalized output
    ``sum_c exp(m_c - M) o_c / sum_c exp(m_c - M) l_c`` on every tile (no
    gradient).  Counted as an all-reduce of the three."""
    axes = _live(grid, axes)
    if not axes:
        return [o / l[..., None] for m, l, o in parts]
    n = _size(grid, axes)
    _count(path, "reduce", (n - 1) * sum(sum(_nbytes(x) for x in p) for p in parts))
    out = [None] * len(parts)
    for grp in grid.groups(axes):
        for i in grp:
            dev = parts[i][2].device
            ms = [parts[j][0].to(dev) for j in grp]
            big = ms[0]
            for m in ms[1:]:
                big = torch.maximum(big, m)
            wl = wo = None
            for j, m in zip(grp, ms):
                w = torch.exp(m - big)
                lj = w * parts[j][1].to(dev)
                oj = w[..., None] * parts[j][2].to(dev)
                wl = lj if wl is None else wl + lj
                wo = oj if wo is None else wo + oj
            out[i] = wo / wl[..., None]
    return out


def split(x, grid, axes, dim: int) -> list:
    """Each tile's slice along ``dim`` of a value that is whole on every tile
    along ``axes`` (its place along them, row-major): no bytes move."""
    axes = _live(grid, axes)
    if not axes:
        return x
    dim = dim % x[0].ndim
    out = _own_slice(list(x), grid, axes, dim)
    return _wrap(out, x, _spec_after(x, dim, axes, gathered=False))


def relayout(x: Sharded, dst, grid, path: str, *, varying=()) -> Sharded:
    """``x`` re-laid to the spec ``dst``: gathered along every dimension whose
    axes ``dst`` drops, then split where ``dst`` adds axes (every gather
    before any split: a split along one dim makes the tiles of a group hold
    other rows of another).  A gather along an axis of ``varying`` (the axes
    along which the computation that reads the result differs) takes the
    reduce-scatter backward, along any other axis the own-slice backward."""
    nd = len(x.shape)
    src = list(x.spec) + [None] * (nd - len(x.spec))
    dst = list(tuple(dst)) + [None] * (nd - len(tuple(dst)))
    adds = []
    for d in range(nd):
        have, want = entry_axes(src[d]), entry_axes(dst[d])
        if have == want:
            continue
        # gather what ``dst`` does not keep as the leading axes of this dim
        keep = 0
        while keep < min(len(have), len(want)) and have[keep] == want[keep]:
            keep += 1
        # one axis at a time, the minor first: the dim's tiles are row-major
        for a in reversed(have[keep:]):
            x = all_gather(x, grid, (a,), d, path, invariant=a not in varying)
        if want[keep:]:
            adds.append((d, want[keep:]))
    for d, add in adds:
        x = split(x, grid, add, d)
    return x
