"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144
[hf:google/gemma-3-*; unverified]. head_dim=128, GeGLU, sqrt(d) embed
scale, sliding window 1024 on local layers, distinct local rope theta.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    num_layers=62, d_model=5376, num_heads=32, num_kv_heads=16,
    head_dim=128, d_ff=21504, vocab_size=262144, mlp_kind="geglu",
    attn_kind="local_global", local_global_ratio=5, window=1024,
    rope_theta=1_000_000.0, rope_local_theta=10_000.0,
    embed_scale=True,
)
