"""zamba2-1.2b [hybrid] — Mamba2 backbone + weight-shared attention blocks.

38L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=32000 ssm_state=64
[arXiv:2411.15242; hf].  Shared attn+MLP block applied every 6th layer
(weight-tied, Zamba2 style).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    head_dim=64, d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    shared_attn_every=6, mlp_kind="geglu",
)
