"""The LM substrate of the port, for serving: the dense (GQA), vlm, MoE, Mamba2
hybrid and RWKV6 families."""

from repro_torch.models.common import ArchConfig
from repro_torch.models.lm import (
    GroupSpec,
    LMSpec,
    build_spec,
    decode_step,
    init_cache,
    init_params,
    param_count,
    prefill,
)

__all__ = [
    "ArchConfig",
    "GroupSpec",
    "LMSpec",
    "build_spec",
    "decode_step",
    "init_cache",
    "init_params",
    "param_count",
    "prefill",
]
