"""whisper-small [audio] — encoder-decoder; conv frontend is a STUB
(input_specs provides precomputed frame embeddings, per assignment).

12L enc + 12L dec, d_model=768 12H (kv=12) d_ff=3072 vocab=51865
[arXiv:2212.04356; unverified]. enc_len=1500 frames.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    num_layers=12, enc_layers=12, enc_len=1500,
    d_model=768, num_heads=12, num_kv_heads=12,
    head_dim=64, d_ff=3072, vocab_size=51865, mlp_kind="geglu",
    frontend="audio_stub",
)
