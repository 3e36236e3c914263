"""rwkv6-3b [ssm] — Finch, attention-free, data-dependent decay.

32L d_model=2560 d_ff=8960 vocab=65536 [arXiv:2404.05892; hf].
head_dim 64 -> 40 heads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
    head_dim=64, d_ff=8960, vocab_size=65536,
    rwkv=True, rwkv_head_dim=64,
)
