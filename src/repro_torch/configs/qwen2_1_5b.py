"""qwen2-1.5b [dense]: GQA with QKV bias.  [arXiv:2407.10671; hf].
A copy of ``repro.configs.qwen2_1_5b``."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    remat=False, param_dtype="float32", compute_dtype="float32",
)
