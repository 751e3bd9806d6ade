"""The LM substrate of the port, for training and serving: the dense (GQA),
vlm, MoE, Mamba2 hybrid, RWKV6 and encoder-decoder families."""

from repro_torch.models.common import ArchConfig
from repro_torch.models.lm import (
    GroupSpec,
    LMSpec,
    build_spec,
    decode_step,
    init_cache,
    init_params,
    loss_fn,
    param_count,
    params_tree,
    params_view,
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
    "loss_fn",
    "param_count",
    "params_tree",
    "params_view",
    "prefill",
]
