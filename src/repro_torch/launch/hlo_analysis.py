"""Op-level cost extraction: the port's counterpart of :mod:`repro.launch.hlo_analysis`.

The JAX package lowers a step to HLO and reads its cost there.  XLA's
``compiled.cost_analysis()`` visits every computation once, so the body of a
95-layer scan or of a 32-chunk flash-attention loop counts a single time and
FLOPs and collective bytes come out short by the trip count; the JAX module
parses the HLO's call graph and multiplies each computation by its known
trip counts to correct that.

The port has no HLO and no compiled loop.  :func:`analyze` runs ``fn``
eagerly under a ``TorchDispatchMode`` (:class:`OpCounter`), usually on
``meta`` tensors, so nothing is allocated or computed, and sees every aten
op each time it executes: a Python loop's body counts once per trip by
construction, nested loops multiply, and a ``torch.utils.checkpoint`` body
recomputed in the backward counts again, as XLA's remat recompute does.
The keys are the JAX module's:

- ``dot_flops``: 2 x m x n x k summed over the matmul-family ops
  (``torch.utils.flop_counter``'s formulas for mm, addmm, bmm, baddbmm,
  convolution and SDPA; an einsum runs as bmm).
- ``collective_bytes`` by op type, ``collective_total_bytes`` and
  ``collective_counts``: the tile moves of a device grid
  (:func:`repro_torch.core.distmatrix.grid_moves`) read around the call,
  SUMMA's panel gathers as ``all-gather`` and Cannon's skews and shifts as
  ``collective-permute``; the LM substrate's moves
  (:func:`repro_torch.core.collectives.lm_moves`, read by the dry run around
  a grid step) by :func:`collectives_of`: ``gather`` as ``all-gather``,
  ``reduce`` as ``all-reduce``, ``reduce_scatter`` as ``reduce-scatter``.
  A call with no grid (``grid=None``) has None there, never 0: nothing was
  measured.

  Bytes are those that cross between logical grid positions, summed over
  the whole grid (a tile already at its destination is not counted).  The
  JAX module counts each collective's result bytes per device times
  ``RING_MULTIPLIER``.  For a group of n tiles and a result of R bytes a
  tile (S a tile's slice of a reduce-scatter), per tile:

  ==================  ===============  ==============
  collective          JAX, per device  port, per tile
  ==================  ===============  ==============
  all-reduce          2 R              (n - 1) R
  all-gather          R                (n - 1) R / n
  reduce-scatter      S                (n - 1) S
  ==================  ===============  ==============

  so a port count converts to the JAX convention by 2 / (n - 1),
  n / (n - 1) and 1 / (n - 1) of its per-tile bytes (the port's total over
  the tiles).  GSPMD's all-to-all and resharding collective-permutes have
  no counterpart: the port's grid code issues only its explicit
  collectives.

Besides: ``peak_live_bytes``, the high-water mark of the bytes of tensors
made during the call and still alive (each storage once; views cost
nothing; the arguments, made before, are not counted), ``flops_by_op`` and
``n_ops``, and ``timeline``: (segment, op, live bytes after it) for every
op, a segment being a run of ops in one autograd phase (forward, inside a
backward, after it).

``shares`` names arguments whose bytes count at a share (the dry run's
parameters and optimizer state, at a tile's share of them on a grid).  A
storage made during the call counts at a share by what it is, never by its
shape alone (an activation may have a parameter's shape):

- made by an op that is no product (a cast, a copy, an elementwise op)
  from an input of its own shape that counts at a share, it counts at that
  share (the smallest, where there are several);
- a parameter's gradient (the parameter's hook sees it) counts at the
  parameter's share, and so do the partial gradients that the op making it
  summed or stacked (each layer's slice of a stacked weight);
- a storage into which an in-place op writes a share of its shape counts
  at that share (a gradient accumulator);
- in the optimizer (ops run outside a backward with grad mode off), where
  every tensor made is a parameter's or its state's, one that the rules
  above give no share takes the share of the parameter of its shape
  (Adafactor's second moment rebuilt from its two factors).

Shares are settled when the call ends and the live bytes are counted then,
so a storage found to be a gradient counts at its share over its whole
life.  A partial gradient of a weight used twice (tied embeddings, zamba2's
shared block) that autograd sums in place counts whole until it is summed.

On ``meta`` most pointwise ops run a Python meta kernel (~0.25 ms each in
PyTorch 2.13).  The counter runs each pointwise op's kernel once per
signature (the op, its tensor arguments' shapes, strides and dtypes, its
other arguments) and answers a repeat with an empty tensor of the shape,
strides and dtype the kernel gave (an in-place op with its first argument):
the same tensors, without the cost.  Without it the 64 cells and the chain
of ``dryrun --all --mesh both --chain`` take about 1.8 times as long.
:class:`MetaMemo` does the same for every op that returns one new tensor
(no view, no in-place op but a pointwise one), with nothing counted: the
dry run's grid steps run under it, where every tile repeats the ops of
every other.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# the grid counters' move kinds -> the JAX module's collective op types
_KIND_TO_COLLECTIVE = {"gather": "all-gather", "permute": "collective-permute",
                       "reduce": "all-reduce", "reduce_scatter": "reduce-scatter"}

# ops whose result may be a gradient summed or stacked from partial gradients
_GRAD_JOINS = ("add", "stack")


def _leaves(x, out: list) -> list:
    """The leaves of an op's arguments or results (lists, tuples, dicts);
    ``torch.utils._pytree`` is general and about three times slower here."""
    if isinstance(x, (list, tuple)):
        for y in x:
            _leaves(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _leaves(y, out)
    else:
        out.append(x)
    return out


class _Storage:
    """A storage made during the count."""

    __slots__ = ("key", "nbytes", "share", "made", "freed", "alive", "joined")

    def __init__(self, key: int, nbytes: int, share: float, made: int, joined):
        self.key, self.nbytes, self.share, self.made = key, nbytes, share, made
        self.freed = None  # the index of the first op after its last tensor died
        self.alive = 0  # its tensors alive
        self.joined = joined  # the storages an add / stack made it from (or None)


class MetaMemo(TorchDispatchMode):
    """Answers a repeated op on ``meta`` tensors from a memo (module
    docstring): every pointwise op (in place too) and every op with one new
    tensor as its result, or with ``pointwise_only`` the pointwise ops alone.
    :class:`OpCounter` takes the pointwise rule: under the wider one the
    activation estimate of 34 of the dry run's 64 cells moves (their
    ``activation_bytes_estimate``, so ``per_tile_bytes_estimate``, and
    ``fits_80gb`` in three; decode cells by up to 45x), FLOPs and argument
    bytes do not."""

    def __init__(self, pointwise_only: bool = False):
        super().__init__()
        self._pointwise_only = pointwise_only
        self._memo: dict = {}  # signature -> (shape, stride, dtype) or None (in place)
        self._memo_ok: dict = {}  # op -> whether its results may be memoized

    def _memoizable(self, func) -> bool:
        ok = self._memo_ok.get(func)
        if ok is None:
            schema = func._schema
            pointwise = torch.Tag.pointwise in func.tags
            fresh = (len(schema.returns) == 1 and schema.returns[0].alias_info is None
                     and not schema.is_mutable)
            ok = self._memo_ok[func] = pointwise or (not self._pointwise_only and fresh)
        return ok

    def _signature(self, func, leaves):
        """The key of a memoizable op on meta tensors, or None (not memoized)."""
        if not self._memoizable(func):
            return None
        parts = [func]
        meta = False
        for a in leaves:
            if isinstance(a, torch.Tensor):
                if a.device.type != "meta":
                    return None
                meta = True
                parts.append((tuple(a.shape), a.stride(), a.dtype))
            else:
                parts.append((type(a), a))
        if not meta:  # a factory: its device is an argument
            return None
        key = tuple(parts)
        try:
            hash(key)
        except TypeError:  # an argument that cannot key a cache
            return None
        return key

    def _run(self, func, args, kwargs, leaves):
        key = self._signature(func, leaves)
        if key is None:
            return func(*args, **kwargs)
        key = (key, tuple(kwargs))
        hit = self._memo.get(key, False)
        if hit is None:
            return args[0]
        if hit:
            return torch.empty_strided(hit[0], hit[1], dtype=hit[2], device="meta")
        out = func(*args, **kwargs)
        if func._schema.is_mutable:  # in place: the answer is the first argument
            if out is args[0]:
                self._memo[key] = None
        elif isinstance(out, torch.Tensor) and out.device.type == "meta":
            self._memo[key] = (tuple(out.shape), out.stride(), out.dtype)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        return self._run(func, args, kwargs, _leaves((args, kwargs), []))


class OpCounter(MetaMemo):
    """Counts matmul FLOPs by op and records every storage made while it is
    active: its bytes, its share (module docstring) and the ops at which it
    was made and freed.  A storage an op received (an in-place result, a
    view of an argument made before) is not new.  ``shares``: (tensor,
    share) pairs of the arguments that count at a share."""

    def __init__(self, shares=()):
        super().__init__(pointwise_only=True)
        self.flops: dict[str, int] = {}
        self.n_ops = 0
        self._arg_share = {t.untyped_storage()._cdata: w for t, w in shares}
        self._param_share: dict[tuple, float] = {}  # for the optimizer's own tensors
        for t, w in shares:
            if t.requires_grad:
                self._param_share.setdefault(tuple(t.shape), w)
        self.storages: list[_Storage] = []  # every storage made, in order
        self._alive: dict[int, _Storage] = {}  # storage key -> its record while alive
        self.ops: list[tuple[int, str]] = []  # (segment, op name) of every op
        self._phase, self._segment = "forward", 0

    def _share_of(self, key: int) -> float:
        rec = self._alive.get(key)
        return rec.share if rec is not None else self._arg_share.get(key, 1.0)

    def _same_shape_share(self, t: torch.Tensor, inputs: list) -> float:
        return min((self._share_of(k) for a, k in inputs if a.shape == t.shape), default=1.0)

    def _release(self, rec: _Storage) -> None:
        rec.alive -= 1
        if rec.alive == 0:
            rec.freed = self.n_ops
            del self._alive[rec.key]

    def mark_gradient(self, g: torch.Tensor, share: float) -> None:
        """``g`` is the gradient of a parameter counted at ``share``."""
        rec = self._alive.get(g.untyped_storage()._cdata)
        if rec is None:
            return
        for r in [rec, *(rec.joined or ())]:
            r.share = min(r.share, share)

    def _new(self, t: torch.Tensor, key: int, i: int, inputs: list, name: str, product: bool,
             optimizer: bool) -> _Storage:
        share, joined = 1.0, None
        if self._arg_share:  # some argument counts at a share
            if not product:
                share = self._same_shape_share(t, inputs)
            if share == 1.0 and optimizer:
                share = self._param_share.get(tuple(t.shape), 1.0)
            if name in _GRAD_JOINS:
                joined = [self._alive[k] for a, k in inputs
                          if k in self._alive and a.shape in (t.shape, t.shape[1:])]
        return _Storage(key, t.untyped_storage().nbytes(), share, i, joined)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = _leaves((args, kwargs), [])
        inputs = [(a, a.untyped_storage()._cdata) for a in leaves if isinstance(a, torch.Tensor)]
        out = self._run(func, args, kwargs, leaves)
        i = self.n_ops
        self.n_ops += 1
        packet = func._overloadpacket
        name = packet.__name__
        product = packet in flop_registry
        if product:
            self.flops[name] = self.flops.get(name, 0) + int(
                flop_registry[packet](*args, **kwargs, out_val=out))
        backward = torch._C._current_graph_task_id() != -1
        phase = "backward" if backward else "forward" if self._phase == "forward" else "after"
        if phase != self._phase:
            self._phase, self._segment = phase, self._segment + 1
        optimizer = not backward and not torch.is_grad_enabled()
        received = {k for _, k in inputs}
        for t in _leaves(out, []):
            if not isinstance(t, torch.Tensor):
                continue
            key = t.untyped_storage()._cdata
            rec = self._alive.get(key)
            if rec is None:
                if key in received:
                    continue  # an in-place result or a view of an argument made before
                rec = self._alive[key] = self._new(t, key, i, inputs, name, product, optimizer)
                self.storages.append(rec)
            elif rec.made < i and self._arg_share and not product and func._schema.is_mutable:
                rec.share = min(rec.share, self._same_shape_share(t, inputs))  # written in place
            rec.alive += 1
            weakref.finalize(t, self._release, rec)
        self.ops.append((self._segment, name))
        return out

    def timeline(self) -> list[tuple[int, str, int]]:
        """(segment, op name, live bytes after it) for every op, each storage
        at its settled share."""
        diff = [0] * (self.n_ops + 1)
        for rec in self.storages:
            b = int(rec.nbytes * rec.share)
            diff[rec.made] += b
            if rec.freed is not None:
                diff[rec.freed] -= b
        out, live = [], 0
        for i, (segment, name) in enumerate(self.ops):
            live += diff[i]
            out.append((segment, name, live))
        return out


def collectives_of(moves: dict) -> tuple[dict, dict]:
    """(bytes, calls) by JAX op type of grid moves ``{group: {"<kind>_bytes",
    "<kind>s"}}`` summed over the groups (schedules or paths): the counters'
    form (:func:`~repro_torch.core.distmatrix.grid_moves`,
    :func:`~repro_torch.core.collectives.lm_moves`) or a difference of it."""
    nbytes = {k: 0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for now in moves.values():
        for kind, op in _KIND_TO_COLLECTIVE.items():
            nbytes[op] += int(now.get(f"{kind}_bytes", 0))
            counts[op] += int(now.get(f"{kind}s", 0))
    return nbytes, counts


def moves_between(before: dict, after: dict) -> dict:
    """The difference of two readings of a move counter, group by group."""
    return {g: {k: v - before[g][k] for k, v in now.items()} for g, now in after.items()}


def count(fn, *args, shares=(), **kwargs) -> OpCounter:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpCounter` and return
    it.  ``shares``: (argument tensor, share) pairs; a parameter's gradient
    counts at its parameter's share."""
    counter = OpCounter(shares)
    hooks = [t.register_hook(lambda g, w=w: counter.mark_gradient(g, w))
             for t, w in shares if t.requires_grad]
    try:
        with counter:
            fn(*args, **kwargs)
    finally:
        for h in hooks:
            h.remove()
    return counter


def analyze(fn, *args, grid=None, shares=(), **kwargs) -> dict:
    """The counts of one run of ``fn(*args, **kwargs)`` (module docstring,
    :func:`count`).  ``grid`` (a
    :class:`~repro_torch.core.distmatrix.DistContext`) marks a call whose
    tile moves are read as collectives; without it they are None."""
    from repro_torch.core.distmatrix import grid_moves

    before = grid_moves() if grid is not None else None
    counter = count(fn, *args, shares=shares, **kwargs)
    timeline = counter.timeline()
    out = {
        "dot_flops": float(sum(counter.flops.values())),
        "collective_bytes": None,
        "collective_total_bytes": None,
        "collective_counts": None,
        "flops_by_op": dict(counter.flops),
        "peak_live_bytes": max((live for _, _, live in timeline), default=0),
        "n_ops": counter.n_ops,
        "timeline": timeline,
    }
    if grid is not None:
        nbytes, counts = collectives_of(moves_between(before, grid_moves()))
        out.update(collective_bytes=nbytes, collective_total_bytes=sum(nbytes.values()),
                   collective_counts=counts)
    return out
