"""granite-3-2b [dense]: GQA.  [hf:ibm-granite/granite-3.0-2b-base; hf].
A copy of ``repro.configs.granite_3_2b``."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49155,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    remat=False, param_dtype="float32", compute_dtype="float32",
)
