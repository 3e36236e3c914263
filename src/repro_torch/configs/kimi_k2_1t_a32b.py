"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8.

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840
[arXiv:2501.kimi2; unverified, paper-table].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    head_dim=112, d_ff=2048, vocab_size=163840, mlp_kind="swiglu",
    num_experts=384, top_k=8, moe_d_ff=2048,
    tie_embeddings=False,
)
