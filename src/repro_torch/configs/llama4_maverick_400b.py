"""llama4-maverick-400b-a17b [moe]: MoE top-1 128e, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Interleaved MoE (every 2nd layer, as in the HF release): 24 dense layers
with d_ff 2x16384 alternate with 24 MoE layers (128 routed experts top-1
with d_ff=8192 + 1 shared expert) -> ~400B total / ~17B active params.
Early fusion: image tokens share the 202048 vocab (frontend stub).
bf16 params (one MoE layer's expert stacks are 32 GB); the optimizer field
names the JAX trainer's Adafactor.  long_500k: SKIPPED (full attn).

A copy of ``repro.configs.llama4_maverick_400b``.
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,           # expert FFN width; dense layers use 2x
    vocab=202048,
    n_experts=128,
    top_k=1,
    d_expert=8192,
    moe_layer_step=2,
    n_shared_experts=1,
    optimizer="adafactor",
    param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64,
    vocab=512, n_experts=8, d_expert=64, remat=False,
    param_dtype="float32", compute_dtype="float32",
)
