"""deepseek-67b [dense]: llama-arch GQA.  [arXiv:2401.02954; hf].

bf16 params: 134 GB over 95 layers, more than one 80 GB card holds.

A copy of ``repro.configs.deepseek_67b``.
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160, vocab=512,
    remat=False, param_dtype="float32", compute_dtype="float32",
)
