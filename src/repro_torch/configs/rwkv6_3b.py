"""rwkv6-3b [ssm]: Finch, data-dependent decay, attention-free.
[arXiv:2404.05892; hf].  A copy of ``repro.configs.rwkv6_3b``.

40 heads x 64 head-dim; token-shift + LoRA-parameterized per-channel decay.
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    rwkv=True,
    n_layers=32,
    d_model=2560,
    n_heads=40,        # informational; the wkv recurrence uses rwkv_head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    rwkv_head_dim=64,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    rwkv_head_dim=16, ssm_chunk=8, remat=False,
    param_dtype="float32", compute_dtype="float32",
)
