"""qwen3-moe-235b-a22b [moe] — 128 experts top-8.

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936
[hf:Qwen/Qwen3-*; hf].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    head_dim=128, d_ff=1536, vocab_size=151936, mlp_kind="swiglu",
    num_experts=128, top_k=8, moe_d_ff=1536,
    tie_embeddings=False,
)
