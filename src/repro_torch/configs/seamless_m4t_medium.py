"""seamless-m4t-medium [audio]: enc-dec multimodal backbone.
[arXiv:2308.11596; hf].  A copy of ``repro.configs.seamless_m4t_medium``.

"12L" = 12 encoder + 12 decoder layers (HF card).  The audio frontend is a
stub: the encoder takes precomputed frame embeddings (B, T, d_model); the
decoder consumes tokens.  kv=16 == n_heads -> MHA.
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=24,
    enc_layers=12,
    dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    norm="ln",
    input_mode="frames",
)

SMOKE = CONFIG.replace(
    enc_layers=2, dec_layers=2, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, remat=False, param_dtype="float32", compute_dtype="float32",
)
