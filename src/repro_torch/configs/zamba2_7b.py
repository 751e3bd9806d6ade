"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention block.
[arXiv:2411.15242; unverified].

81 Mamba2 layers; one weight-SHARED attention+MLP block applied every 6
layers (13 invocations; its input is concat(hidden, initial-embedding), so
the attention runs at width 2*d_model).  d_ff=14336 is the shared block's
FFN.  long_500k RUNS: SSM state is O(1) in sequence length and the shared
block decodes against its KV cache (linear per token).

A copy of ``repro.configs.zamba2_7b``.
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=64,  # S*Q*H decay-tensor memory is linear in Q (EXPERIMENTS P5)
    attn_every=6,
)

SMOKE = CONFIG.replace(
    n_layers=7, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    ssm_state=16, ssm_headdim=16, ssm_chunk=8, attn_every=3,
    remat=False, param_dtype="float32", compute_dtype="float32",
)
