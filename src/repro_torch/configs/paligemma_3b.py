"""paligemma-3b [vlm] — SigLIP vision stub + gemma text decoder, MQA.

18L d_model=2048 8H (kv=1, MQA) d_ff=16384 vocab=257216
[arXiv:2407.07726; hf]. 256 patch-prefix tokens, prefix-LM attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    head_dim=256, d_ff=16384, vocab_size=257216, mlp_kind="geglu",
    frontend="vision_stub", num_prefix=256, embed_scale=True,
)
