"""chameleon-34b [vlm]: early-fusion, VQ image tokens, QK-norm.
[arXiv:2405.09818; unverified].

The image tokenizer is a STUB: VQ image tokens share the 65536 vocabulary,
so the model takes plain token ids (mixed text/image stream).
QK-norm per Chameleon's training-stability fix.  long_500k: SKIPPED.

A copy of ``repro.configs.chameleon_34b``.
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,
    param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    remat=False, param_dtype="float32", compute_dtype="float32",
)
