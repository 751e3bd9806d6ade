"""Architecture registry of the port: ``--arch <id>`` -> (full config, smoke config).

The JAX package's ten architectures, in its order, and the input-shape cells
(:mod:`repro_torch.configs.shapes`).  Full configs run on a card or, at any
size, on the ``meta`` device in the dry run; the tests instantiate the
reduced SMOKE variants on the CPU.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.shapes import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES_BY_NAME,
    TRAIN_4K,
    ShapeSpec,
    input_specs,
    is_supported,
    supported_shapes,
)
from repro_torch.models.common import ArchConfig

_MODULES = {
    "seamless-m4t-medium": "seamless_m4t_medium",
    "granite-3-2b": "granite_3_2b",
    "qwen2-1.5b": "qwen2_1_5b",
    "deepseek-67b": "deepseek_67b",
    "stablelm-1.6b": "stablelm_1_6b",
    "zamba2-7b": "zamba2_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "rwkv6-3b": "rwkv6_3b",
    "chameleon-34b": "chameleon_34b",
}
ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    return _module(arch_id).SMOKE


def all_cells() -> list[tuple[str, ShapeSpec]]:
    """Every supported (arch x shape) cell: 32 runnable of the 40 (the eight
    ``long_500k`` cells of full-attention archs are documented skips; the
    JAX package's docstring says 34 of 40, its function returns these 32)."""
    return [(aid, sh) for aid in ARCH_IDS for sh in supported_shapes(get_config(aid))]


__all__ = [
    "ALL_SHAPES",
    "ARCH_IDS",
    "ArchConfig",
    "DECODE_32K",
    "LONG_500K",
    "PREFILL_32K",
    "SHAPES_BY_NAME",
    "TRAIN_4K",
    "ShapeSpec",
    "all_cells",
    "get_config",
    "get_smoke",
    "input_specs",
    "is_supported",
    "supported_shapes",
]
