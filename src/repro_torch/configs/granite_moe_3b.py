"""granite-moe-3b-a800m [moe]: 40 experts top-8, fine-grained d_expert=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

NOTE: the assignment text says both "MoE 40e" and "32 experts"; we follow
the structured spec (40 experts, top-8), matching granite-3.0-3b-a800m.

A copy of ``repro.configs.granite_moe_3b``.
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    n_experts=40,
    top_k=8,
    d_expert=512,
    tie_embeddings=True,
    # 40 experts don't divide the 16-way model axis: shard the dispatch
    # capacity dim over the whole mesh and the tiny expert FFN over model.
    rules_override=(("experts", None), ("expert_ff", "model"), ("moe_cap", ("data", "model"))),
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_ff=32, vocab=512,
    n_experts=8, top_k=2, d_expert=32, remat=False,
    param_dtype="float32", compute_dtype="float32",
)
