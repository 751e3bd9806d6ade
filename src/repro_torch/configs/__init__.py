"""Architecture registry of the port: ``--arch <id>`` -> (full config, smoke config).

The JAX package's ten architectures, in its order.
"""

from __future__ import annotations

import importlib

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


__all__ = ["ARCH_IDS", "ArchConfig", "get_config", "get_smoke"]
