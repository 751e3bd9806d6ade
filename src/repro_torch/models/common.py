"""Shared model substrate: the config, the logical sharding rules, norms,
RoPE and initializers.

Port of :mod:`repro.models.common`.  Every parameter, cache entry and batch
input carries a tuple of *logical* axis names; :func:`logical_to_spec`
maps them to grid axes by a rules table, as the JAX package maps them to
mesh axes.  The port's spec type is :class:`Spec`, a tuple whose entries
are ``None``, an axis name or a tuple of names (``PartitionSpec``'s form).
The rules are data here: the dry run (:mod:`repro_torch.launch.dryrun`)
turns them into per-tile shapes and bytes on a logical grid
(:func:`repro_torch.launch.mesh.make_production_mesh`).  The model
itself runs on one device and reads no rule; ``constrain`` is not ported.

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


def axis_sizes(grid) -> dict[str, int]:
    """Axis name -> size of a grid: a :class:`repro_torch.launch.mesh.LogicalGrid`
    (anything with a ``shape`` mapping), or a mapping itself."""
    return dict(grid) if isinstance(grid, dict) else {k: int(v) for k, v in grid.shape.items()}


def attach_axis_sizes(rules: dict[str, Any], grid) -> dict[str, Any]:
    """A copy of ``rules`` carrying the grid's axis sizes (``_axis_sizes``)."""
    return {**rules, "_axis_sizes": axis_sizes(grid)}


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
