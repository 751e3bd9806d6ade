"""Shared model substrate: the config, norms, RoPE and initializers.

Port of :mod:`repro.models.common` for one device.  There is no mesh, so the
logical sharding rules, ``constrain`` and the spec helpers have no
counterpart.  Parameters live in ``nn.Module`` containers (one per block)
whose attribute names are the JAX package's dictionary keys, so a JAX
parameter tree maps onto them name for name (``repro_torch.interop``).
Initializers draw from a ``torch.Generator``: they match the JAX package's
distributions, not its bits.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

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
    # --- sharding (kept for parity; one device reads none of it) ---
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


def dense_init(gen: torch.Generator, shape, dtype, scale: float | None = None,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (within 3 std), as the JAX package's.

    The fan-in is ``shape[0]``, as there: E for a (E, d_in, d_out) expert
    stack.  Such a stack is drawn one matrix at a time into its dtype, so no
    fp32 temporary of the whole stack exists (llama4's is 21.5 GB in fp32).
    """
    std = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    if len(shape) == 3:
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            out[i] = _trunc_normal(gen, shape[1:], device).mul_(std)
        return out
    return _trunc_normal(gen, shape, device).mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device=None) -> torch.Tensor:
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (t * 0.02).to(dtype)


def normal(gen: torch.Generator, shape, std: float, device=None) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * std


# ---------------------------------------------------------------------------
# norms and RoPE
# ---------------------------------------------------------------------------


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
