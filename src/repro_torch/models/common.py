"""Shared model substrate: the config, the logical sharding rules, norms,
RoPE and initializers.

Port of :mod:`repro.models.common`.  Every parameter, cache entry and batch
input carries a tuple of *logical* axis names; :func:`logical_to_spec`
maps them to grid axes by a rules table, as the JAX package maps them to
mesh axes.  The port's spec type is :class:`Spec`, a tuple whose entries
are ``None``, an axis name or a tuple of names (``PartitionSpec``'s form).
The dry run (:mod:`repro_torch.launch.dryrun`) turns the rules into
per-tile shapes and bytes on a logical grid
(:func:`repro_torch.launch.mesh.make_production_mesh`).  On a device grid
(:class:`repro_torch.launch.mesh.DeviceGrid`, attached to the rules with
:func:`attach_axis_sizes`) the rules lay the tensors out: :func:`shard_tree`
cuts a tree of whole tensors into per-tile trees by their sanitized specs
(:func:`unshard_tree` puts them back together), and :func:`constrain`
re-lays a per-tile value (:class:`~repro_torch.core.collectives.Sharded`)
to the spec its logical axes give, gathering and splitting as it must.
:class:`GridRun` is what the models' grid paths read: the grid, the rules
and the helpers that sanitize an activation's spec and lay a parameter out
for a computation.

Parameters live in ``nn.Module`` containers (one per block) whose attribute
names are the JAX package's dictionary keys, so a JAX parameter tree maps
onto them name for name (``repro_torch.interop``).  Initializers draw from
a ``torch.Generator``: they match the JAX package's distributions, not its
bits.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Sequence

import torch
from torch import nn

from repro_torch.core.collectives import Sharded, entry_axes, relayout


@dataclass(frozen=True)
class ArchConfig:
    """One config object for every architecture family (the JAX package's fields)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    norm: str = "rms"  # rms | ln
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    moe_layer_step: int = 1
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0
    # --- RWKV6 ---
    rwkv: bool = False
    rwkv_head_dim: int = 64
    # --- encoder-decoder ---
    enc_layers: int = 0
    dec_layers: int = 0
    # --- modality frontend ---
    input_mode: str = "tokens"
    # --- sharding: per-arch logical-rule overrides (:func:`arch_rules`) ---
    rules_override: tuple = ()
    # --- numerics / execution ---
    optimizer: str = "adamw"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    vocab_chunk: int = 4096
    attn_chunk: int = 1024  # KV chunk of the plain chunked flash attention
    max_seq: int = 131072

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding rows padded to a multiple of 256; logits beyond ``vocab``
        are masked in the unembed."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# logical sharding rules
# ---------------------------------------------------------------------------

# logical axis -> grid axis (or None).  "batch" may map to a tuple of axes.
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("data",),
    "batch_inner": ("data",),  # batch axes usable alongside vocab sharding
    "seq": None,
    "kv_seq": "model",  # decode caches: flash-decode over the model axis
    "embed": None,  # activations' d_model replicated
    "embed_p": "data",  # parameters' d_model axis: FSDP shard
    "embed_d": "data",  # the embedding / unembedding tables' d_model axis
    "vocab": "model",
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "ff": "model",
    "experts": "model",
    "expert_embed": "data",  # expert weights' d_model dim (2-axis storage)
    "expert_ff": None,
    "moe_cap": "data",  # the MoE dispatch buffer's capacity dim
    "inner": "model",  # mamba / rwkv inner channels
    "state": None,
    "layers": None,
}


def multipod_rules() -> dict[str, Any]:
    r = dict(DEFAULT_RULES)
    r["batch"] = ("pod", "data")
    r["batch_inner"] = ("pod", "data")
    return r


def arch_rules(cfg: ArchConfig, rules: dict[str, Any]) -> dict[str, Any]:
    """Apply the config's per-arch logical-rule overrides."""
    if not cfg.rules_override:
        return rules
    return {**rules, **dict(cfg.rules_override)}


class Spec(tuple):
    """A partition spec: one entry per dimension, each ``None`` (replicated),
    a grid axis name, or a tuple of names (the dimension split over their
    product).  Missing trailing entries are replicated.  Equal to the plain
    tuple of its entries (``tuple(PartitionSpec)`` in the JAX package)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _is_axes(x) -> bool:
    """A leaf of a logical-axes tree: a tuple of axis names / None (or a Spec)."""
    return isinstance(x, Spec) or (
        isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x))


def map_axes(fn: Callable, tree, *rest):
    """``fn`` on every leaf of an axes or spec tree (dicts and lists of
    :func:`_is_axes` leaves), with the matching leaves of ``rest`` (trees of
    the same structure: tensors, shapes); the result keeps the structure."""
    if isinstance(tree, dict):
        return {k: map_axes(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_axes(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    if _is_axes(tree):
        return fn(tree, *rest)
    raise TypeError(f"not an axes tree leaf: {tree!r}")


def axes_paths(tree, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) of every leaf of an axes or spec tree (dict keys, list indices)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from axes_paths(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from axes_paths(v, prefix + (i,))
    elif _is_axes(tree):
        yield prefix, tree
    else:
        raise TypeError(f"not an axes tree leaf at {prefix}: {tree!r}")


def named_leaves(tree) -> dict[str, Any]:
    """An axes or spec tree flattened to dotted names (``blocks.0.attn.wq``):
    ``nn.Module.named_parameters``' names for the :func:`repro_torch.models.lm.param_axes` tree."""
    return {".".join(map(str, path)): leaf for path, leaf in axes_paths(tree)}


def logical_to_spec(axes: Sequence[str | None], rules: dict[str, Any]) -> Spec:
    return Spec(*(rules.get(ax) if ax is not None else None for ax in axes))


def tree_specs(logical_tree, rules: dict[str, Any]):
    """Map a tree of logical-axis tuples to a tree of :class:`Spec`."""
    return map_axes(lambda axes: logical_to_spec(axes, rules), logical_tree)


def device_grid(grid):
    """``grid`` as a :class:`~repro_torch.launch.mesh.DeviceGrid` when it
    holds devices (a ``DeviceGrid`` or a ``DistContext``), else None."""
    from repro_torch.core.distmatrix import DistContext
    from repro_torch.launch.mesh import DeviceGrid, as_grid

    return as_grid(grid) if isinstance(grid, (DeviceGrid, DistContext)) else None


def axis_sizes(grid) -> dict[str, int]:
    """Axis name -> size of a grid: a :class:`repro_torch.launch.mesh.LogicalGrid`
    or ``DeviceGrid`` (anything with a ``shape`` mapping), a ``DistContext``,
    or a mapping itself."""
    if isinstance(grid, dict):
        return dict(grid)
    grid = device_grid(grid) or grid
    return {k: int(v) for k, v in grid.shape.items()}


def attach_axis_sizes(rules: dict[str, Any], grid) -> dict[str, Any]:
    """A copy of ``rules`` carrying the grid's axis sizes (``_axis_sizes``)
    and, for a grid of devices, the grid itself (``_grid``): the models'
    grid paths and :func:`constrain` run on it."""
    out = {**rules, "_axis_sizes": axis_sizes(grid)}
    dg = device_grid(grid)
    if dg is not None:
        out["_grid"] = dg
    return out


def _entry_size(entry, sizes: dict[str, int]) -> int:
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(sizes[n] for n in names)


def sanitize_spec(spec: Sequence, shape: Sequence[int], grid) -> Spec:
    """Drop spec entries whose grid-axis product does not divide the dim (the
    JAX package's ``jit`` in_shardings must divide exactly); the dim falls
    back to replicated."""
    sizes = axis_sizes(grid)
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    parts = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            parts.append(None)
            continue
        prod = _entry_size(entry, sizes)
        parts.append(entry if (prod and dim % prod == 0) else None)
    return Spec(*parts)


def _shape(x) -> tuple:
    """A tensor's shape, a shape itself, or () for a host scalar (the cache's ``pos``)."""
    if hasattr(x, "shape"):
        return tuple(x.shape)
    return () if isinstance(x, (int, float)) else tuple(x)


def sanitize_specs(specs, shapes, grid):
    """:func:`sanitize_spec` over a spec tree and the matching tree of tensors
    (or shapes)."""
    return map_axes(lambda s, x: sanitize_spec(s, _shape(x), grid), specs, shapes)


def tile_shape(spec: Sequence, shape: Sequence[int], grid) -> tuple[int, ...]:
    """The per-tile shape of a dim-wise evenly split ``shape`` under ``spec``
    (a sanitized spec: every entry divides its dim)."""
    sizes = axis_sizes(grid)
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for dim, entry in zip(shape, entries):
        k = 1 if entry is None else _entry_size(entry, sizes)
        if dim % k:
            raise ValueError(f"spec {tuple(spec)} does not divide shape {tuple(shape)}")
        out.append(dim // k)
    return tuple(out)


def tile_bytes(spec: Sequence, x, grid) -> int:
    """Bytes of one tile of the tensor ``x`` (a real or meta tensor) under ``spec``."""
    return math.prod(tile_shape(spec, tuple(x.shape), grid)) * x.element_size()


# ---------------------------------------------------------------------------
# executing the rules on a device grid
# ---------------------------------------------------------------------------


def constrain(x, axes: Sequence[str | None], rules: dict[str, Any], *, varying=()):
    """The JAX package's ``constrain``: ``x`` laid out by its logical ``axes``.

    Without a grid in ``rules`` (or for a plain tensor) ``x`` comes back
    unchanged.  With one (:func:`attach_axis_sizes`), ``x`` is a per-tile
    :class:`~repro_torch.core.collectives.Sharded` value, re-laid to the
    sanitized spec of ``axes`` (an entry that does not divide its dim is
    dropped, as the JAX ``constrain`` drops it): gathered where a dim becomes
    whole, split where it becomes sharded, both counted under ``rules``'
    ``_path``.  ``varying`` names the axes along which the computation that
    reads the result differs (their gathers sum the gradients back).
    """
    grid = rules.get("_grid")
    if grid is None or not isinstance(x, Sharded):
        return x
    dst = sanitize_spec(logical_to_spec(axes, rules), x.shape, grid)
    return relayout(x, dst, grid, rules.get("_path", "lm.serve"), varying=varying)


def _shard_leaf(x, spec, grid) -> list:
    from repro_torch.launch.mesh import as_grid

    g = as_grid(grid)
    out = []
    for t, dev in enumerate(g.devices):
        y = x.detach() if isinstance(x, torch.Tensor) else x
        if isinstance(y, torch.Tensor):
            for d, e in enumerate(tuple(spec)):
                ax = entry_axes(e)
                if ax:
                    w = y.shape[d] // math.prod(g.shape[a] for a in ax)
                    y = y.narrow(d, g.position(t, ax) * w, w)
            y = y.to(dev, copy=True)
            if x.requires_grad:
                y.requires_grad_(True)
        out.append(y)
    return out


def _pick(tree, t: int):
    """Tile ``t``'s tree from a tree whose leaves are per-tile lists (tagged ``_TileList``)."""
    if isinstance(tree, dict):
        return {k: _pick(v, t) for k, v in tree.items()}
    if isinstance(tree, _TileList):
        return tree[t]
    if isinstance(tree, list):
        return [_pick(v, t) for v in tree]
    return tree


class _TileList(list):
    pass


def shard_tree(tree, specs, grid) -> list:
    """A tree of whole tensors (dicts and lists; host ints pass through) cut
    into one tree per tile, in tile order: each leaf's tile by its (sanitized)
    spec in ``specs`` (a tree of the same structure), copied to its tile's
    device; a leaf that requires grad gives tiles that do."""
    from repro_torch.launch.mesh import as_grid

    g = as_grid(grid)
    lists = map_axes(lambda s, x: _TileList(_shard_leaf(x, s, g)), specs, tree)
    return [_pick(lists, t) for t in range(g.n_tiles)]


def _unshard_leaf(parts: list, spec, grid, device):
    first = parts[0]
    if not isinstance(first, torch.Tensor):
        return first
    ent = tuple(spec) + (None,) * (first.ndim - len(tuple(spec)))
    sharded = {a for e in ent for a in entry_axes(e)}
    shape = [n * math.prod(grid.shape[a] for a in entry_axes(e))
             for n, e in zip(first.shape, ent)]
    dev = first.device if device is None else torch.device(device)
    out = torch.empty(shape, dtype=first.dtype, device=dev)
    for t, part in enumerate(parts):
        c = grid.coords(t)
        if any(c[a] for a in grid.axis_names if a not in sharded):
            continue  # a copy of a tile already placed
        idx = tuple(slice(grid.position(t, entry_axes(e)) * n,
                          (grid.position(t, entry_axes(e)) + 1) * n) if e else slice(None)
                    for n, e in zip(first.shape, ent))
        out[idx] = part.detach().to(dev)
    return out


def unshard_tree(tiles: list, specs, grid, device=None):
    """The inverse of :func:`shard_tree`: per-tile trees (tile order) put back
    into one tree of whole tensors on ``device`` (by default the first tile's
    device); a replicated leaf is read from its first copy."""
    from repro_torch.launch.mesh import as_grid

    g = as_grid(grid)

    def leaf(s, *parts):
        return _unshard_leaf(list(parts), s, g, device)

    return map_axes(leaf, specs, *tiles)


def sharded_tree(tiles: list, specs, grid):
    """Per-tile trees (tile order) as one tree of
    :class:`~repro_torch.core.collectives.Sharded` leaves (each the tiles of
    one leaf with its spec and whole shape): the form the models' grid paths
    read.  The tiles are the trees' own tensors, not copies."""
    from repro_torch.launch.mesh import as_grid

    g = as_grid(grid)

    def leaf(s, *parts):
        if not isinstance(parts[0], torch.Tensor):
            return parts[0]
        ent = tuple(s) + (None,) * (parts[0].ndim - len(tuple(s)))
        shape = [n * math.prod(g.shape[a] for a in entry_axes(e))
                 for n, e in zip(parts[0].shape, ent)]
        return Sharded(parts, ent, shape)

    return map_axes(leaf, specs, *tiles)


class GridRun:
    """What a model's grid path reads: the grid, the rules (sizes attached),
    the path its moves count under, and helpers for layouts.

    ``entry(axis, n)`` is the sanitized grid entry of a logical activation
    axis on a dim of size ``n`` (a tuple of axis names, ``()`` when whole);
    ``place(x, axes)`` cuts a whole host or device tensor into its tiles by
    its logical axes (an input's placement: no move is counted);
    ``param(w, entries, varying)`` lays a stored parameter out for a
    computation that differs along ``varying``: gathered or split to
    ``entries``, and made to sum its gradient over every axis along which it
    is the same on every tile but the computation differs.
    """

    def __init__(self, rules: dict[str, Any]):
        self.rules = rules
        self.grid = rules["_grid"]
        self.path = rules.get("_path", "lm.serve")

    def entry(self, axis: str | None, n: int) -> tuple:
        e = entry_axes(self.rules.get(axis) if axis is not None else None)
        size = math.prod(self.grid.shape[a] for a in e)
        return e if e and n % size == 0 else ()

    def place(self, x: torch.Tensor, axes: Sequence[str | None]):
        spec = tuple(self.entry(a, n) or None for a, n in zip(axes, x.shape))
        spec = spec + (None,) * (x.ndim - len(spec))
        return Sharded(_shard_leaf(x, spec, self.grid), spec, x.shape)

    def param(self, w, entries: Sequence[tuple], varying) -> list:
        from repro_torch.core import collectives as coll

        nd = len(w.shape)
        src = {a for e in w.spec for a in entry_axes(e)}
        ent = tuple(entries) + ((),) * (nd - len(tuple(entries)))
        dst = {a for e in ent for a in e}
        w = coll.pvary(w, self.grid, tuple(a for a in self.grid.axis_names
                                           if a in (set(varying) | dst) - src), self.path)
        return coll.relayout(w, tuple(e or None for e in ent), self.grid, self.path,
                             varying=tuple(varying))

    def tiles(self, p, ents: dict, varying) -> list:
        """Each tile's parameters of the container ``p`` for one computation:
        ``param(getattr(p, name), entries, varying)`` for every ``name:
        entries`` of ``ents``, as one namespace a tile (tile order)."""
        from types import SimpleNamespace

        laid = {k: self.param(getattr(p, k), e, varying) for k, e in ents.items()}
        return [SimpleNamespace(**{k: v[t] for k, v in laid.items()})
                for t in range(self.grid.n_tiles)]

    def size(self, axes) -> int:
        """The number of tiles along ``axes``."""
        return math.prod(self.grid.shape[a] for a in axes)

    def whole_seq(self, x: Sharded) -> tuple[Sharded, tuple]:
        """``x`` (B, S, ...) with its sequence whole on every tile, and the
        axes it was split over: gathered along them (counted), the gradient
        summed back over them (the tiles then keep other rows of the result,
        :func:`~repro_torch.core.collectives.split`).  A token shift, a causal
        conv or a chunk scan reads the rows before its own, so the recurrent
        blocks run on the whole sequence, as the JAX package's GSPMD does."""
        sa = entry_axes(x.spec[1])
        if not sa:
            return x, ()
        return relayout(x, (x.spec[0], None, *x.spec[2:]), self.grid, self.path,
                        varying=sa), sa


# ---------------------------------------------------------------------------
# parameter containers and initializers
# ---------------------------------------------------------------------------


def param(t: torch.Tensor) -> nn.Parameter:
    """An inference parameter (no gradient)."""
    return nn.Parameter(t, requires_grad=False)


class Params(nn.Module):
    """A container of named parameters and child containers.

    Names are the JAX package's dictionary keys (``p.wq`` for ``p["wq"]``).
    """

    def __init__(self, tensors: dict | None = None, **children: nn.Module):
        super().__init__()
        for name, t in (tensors or {}).items():
            self.register_parameter(name, param(t))
        for name, child in children.items():
            self.add_module(name, child)


# Parameters that the model only ever reads cast to the compute dtype (the
# matrices, biases and mix coefficients); cast_for_compute may cast them once.
COMPUTE_NAMES = frozenset({
    "embed", "lm_head",
    "wq", "wk", "wv", "wo", "bq", "bk", "bv",
    "w_gate", "w_up", "w_down",
    "mix", "wr", "wg", "cm_mix", "cm_k", "cm_v", "cm_r",
    "w_z", "w_x", "w_b", "w_c", "w_dt", "w_out",
})
# Not Mamba2's conv filters (conv_wx, conv_wbc, conv_b), norm, a_log, d_skip or
# dt_bias, nor the MoE router: prefill casts the conv filters to the compute
# dtype, but decode reads them in fp32 from the parameter dtype, and the
# others are read in fp32.


def cast_for_compute(mod: nn.Module, dtype: torch.dtype, device=None) -> nn.Module:
    """A copy of ``mod`` on ``device`` with its :data:`COMPUTE_NAMES` parameters in ``dtype``.

    The caller's module is left as it is; a parameter already on ``device`` in
    its dtype is shared, not copied.  The model's functions cast the
    :data:`COMPUTE_NAMES` parameters with ``.to(cdtype)`` before use, which is
    then a no-op, so the copy gives bitwise what ``mod`` gives without a cast
    at every call.
    """
    new = object.__new__(type(mod))
    new.__dict__ = dict(mod.__dict__)
    new._parameters = {
        k: param(t.to(device=device, dtype=dtype if k in COMPUTE_NAMES else t.dtype))
        for k, t in mod._parameters.items()
    }
    new._modules = {k: cast_for_compute(m, dtype, device) for k, m in mod._modules.items()}
    return new


def _trunc_normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-3.0, b=3.0, generator=gen)


def dense_init(gen: torch.Generator | None, shape, dtype, scale: float | None = None,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (within 3 std), as the JAX package's.

    The fan-in is ``shape[0]``, as there: E for a (E, d_in, d_out) expert
    stack.  Such a stack is drawn one matrix at a time into its dtype, so no
    fp32 temporary of the whole stack exists (llama4's is 21.5 GB in fp32).
    """
    if gen is None:  # the meta build (lm.init_params on "meta"): shapes only, nothing drawn
        return torch.empty(shape, dtype=dtype, device=device)
    std = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    if len(shape) == 3:
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            out[i] = _trunc_normal(gen, shape[1:], device).mul_(std)
        return out
    return _trunc_normal(gen, shape, device).mul_(std).to(dtype)


def embed_init(gen: torch.Generator | None, shape, dtype, device=None) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (t * 0.02).to(dtype)


def normal(gen: torch.Generator | None, shape, std: float, device=None) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * std


# ---------------------------------------------------------------------------
# norms and RoPE
# ---------------------------------------------------------------------------


def norm_axes(cfg: ArchConfig) -> dict:
    ax = {"scale": ("embed",)}
    if cfg.norm == "ln":
        ax["bias"] = ("embed",)
    return ax


def stacked_axes(axes_tree):
    """Prepend the stacked ``layers`` logical axis to every leaf's axes (the
    JAX package's scanned groups; the port's ``lm.params_tree`` layout)."""
    return map_axes(lambda axes: ("layers",) + tuple(axes), axes_tree)


def make_norm(cfg: ArchConfig, d: int):
    """Returns (init_fn, apply_fn) for the configured norm type (rms or ln)."""

    def init(device=None) -> Params:
        t = {"scale": torch.ones((d,), dtype=cfg.pdtype, device=device)}
        if cfg.norm == "ln":
            t["bias"] = torch.zeros((d,), dtype=cfg.pdtype, device=device)
        return Params(t)

    def apply(p: Params, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if cfg.norm == "ln":
            mu = xf.mean(-1, keepdim=True)
            var = ((xf - mu) ** 2).mean(-1, keepdim=True)
            y = (xf - mu) * torch.rsqrt(var + 1e-5)
            y = y * p.scale.to(torch.float32) + p.bias.to(torch.float32)
        else:
            ms = (xf * xf).mean(-1, keepdim=True)
            y = xf * torch.rsqrt(ms + 1e-6) * p.scale.to(torch.float32)
        return y.to(x.dtype)

    return init, apply


def apply_norm_grid(cfg: ArchConfig, run: GridRun, p, x, d: int | None = None):
    """The configured norm over the last dim of a per-tile value laid out
    with that dim whole: each tile applies it to its rows; the (replicated)
    scale and bias sum their gradients over the axes the rows vary on."""
    from types import SimpleNamespace

    _, napply = make_norm(cfg, d or cfg.d_model)
    varying = tuple(a for e in x.spec for a in entry_axes(e))
    names = ("scale", "bias") if cfg.norm == "ln" else ("scale",)
    laid = {k: run.param(getattr(p, k), ((),), varying) for k in names}
    out = [napply(SimpleNamespace(**{k: v[t] for k, v in laid.items()}), x[t])
           for t in range(run.grid.n_tiles)]
    return Sharded(out, x.spec, x.shape)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for the given absolute positions, (..., head_dim/2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / torch.pow(float(theta), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (S, D/2) broadcast over batch and heads."""
    half = x.shape[-1] // 2
    c, s = cos[:, None, :], sin[:, None, :]
    xf1, xf2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1).to(x.dtype)
