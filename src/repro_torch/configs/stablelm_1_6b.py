"""stablelm-1.6b [dense]: MHA (kv=32), LayerNorm.
[hf:stabilityai/stablelm-2-1_6b; unverified].

A copy of ``repro.configs.stablelm_1_6b``.
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    norm="ln",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    remat=False, param_dtype="float32", compute_dtype="float32",
)
