"""Input-shape cells shared by every LM architecture.

Port of :mod:`repro.configs.shapes`.  ``decode_*`` / ``long_*`` cells run
the serve step (one new token against a KV cache of ``seq_len``), not the
train step.  ``long_500k`` needs sub-quadratic attention: it runs only for
the state-based families (zamba2, rwkv6) and is a documented skip for the
full-attention architectures.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.common import ArchConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeSpec("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeSpec("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeSpec("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeSpec("long_500k", "decode", 524288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}

# families whose attention cost is sub-quadratic in context (state-based)
_SUBQUADRATIC = ("ssm", "hybrid")


def supported_shapes(cfg: ArchConfig) -> tuple[ShapeSpec, ...]:
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.family in _SUBQUADRATIC:
        out.append(LONG_500K)
    return tuple(out)


def is_supported(cfg: ArchConfig, shape: ShapeSpec) -> bool:
    return any(s.name == shape.name for s in supported_shapes(cfg))


def input_specs(cfg: ArchConfig, shape: ShapeSpec, batch: int | None = None,
                device="meta") -> dict:
    """Empty tensors standing in for every model input of this cell (the JAX
    package's ``ShapeDtypeStruct``s): on ``meta`` by default, so nothing is
    allocated.  ``batch`` replaces the cell's global batch (the dry run's
    per-tile batch).

    The modality frontend is a stub: seamless's encoder input is precomputed
    frame embeddings (B, S, d_model) in the compute dtype; chameleon's image
    tokens share the token vocabulary, so its inputs are token ids.  A decode
    cell's input is the one new token; its KV cache of ``seq_len`` is the
    caller's (``lm.init_cache``).
    """
    b, s = batch or shape.global_batch, shape.seq_len

    def empty(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)

    i32 = torch.int32
    if shape.kind == "train":
        specs = {"tokens": empty((b, s), i32), "labels": empty((b, s), i32)}
    elif shape.kind == "prefill":
        specs = {"tokens": empty((b, s), i32)}
    elif shape.kind == "decode":
        return {"token": empty((b,), i32)}
    else:
        raise ValueError(shape.kind)
    if cfg.input_mode == "frames":
        specs["frames"] = empty((b, s, cfg.d_model), cfg.cdtype)
    return specs
