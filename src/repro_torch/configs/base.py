"""Model/config schema shared by all architectures.

Every assigned architecture gets one ``configs/<id>.py`` exporting
``CONFIG`` (the exact published shape); ``CONFIG.reduced()`` is the same
family at smoke-test scale.  A copy of the JAX package's
``configs/base.py`` with torch dtypes.  ``remat`` selects the activation
checkpointing of a training forward (``models/lm.py``); ``scan_layers``
is accepted and has no effect here: the port loops over its layers in
Python.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention flavor
    attn_kind: str = "full"       # full | swa | local_global
    window: int = 0               # sliding-window size for swa/local layers
    local_global_ratio: int = 0   # N local : 1 global (gemma3 = 5)
    mlp_kind: str = "swiglu"      # swiglu | geglu
    logit_softcap: float = 0.0
    # moe
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "dropping"    # dropping (GSPMD) | alltoall (shard_map)
    moe_group_size: int = 8192    # tokens per dispatch group (perf lever)
    decode_embed: str = "gather"  # gather | psum (see layers.embed_lookup_psum)
    logits_dtype: str = "bf16"    # bf16 | f32 — lm-head/xent precision lever
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # rwkv6
    rwkv: bool = False
    rwkv_head_dim: int = 64
    # hybrid (zamba2): one weight-shared attn+mlp block every k ssm blocks
    shared_attn_every: int = 0
    # encoder-decoder (whisper) / vlm (paligemma)
    enc_layers: int = 0
    enc_len: int = 0              # encoder frames (audio stub)
    frontend: str = "none"        # none | audio_stub | vision_stub
    num_prefix: int = 0           # vlm patch tokens (prefix-LM attention)
    # misc
    rope_theta: float = 10000.0
    rope_local_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False     # gemma-style sqrt(d) embedding scaling
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    remat: str = "full"           # full | dots | none
    scan_layers: bool = True

    # ---- derived
    @property
    def d_inner(self) -> int:     # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (see DESIGN.md §6)."""
        return self.family in ("ssm", "hybrid") or self.attn_kind in (
            "swa", "local_global")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Same family at smoke-test scale (CPU, 1 device)."""
        return self.replace(
            num_layers=min(self.num_layers, 2 + (self.shared_attn_every > 0) * 4),
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads,
                                    4 * self.num_kv_heads // max(self.num_heads, 1))),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            window=min(self.window, 8) if self.window else 0,
            num_experts=min(self.num_experts, 8),
            top_k=min(self.top_k, 2),
            moe_d_ff=64 if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            rwkv_head_dim=16 if self.rwkv else 64,
            enc_layers=min(self.enc_layers, 2),
            enc_len=min(self.enc_len, 16),
            num_prefix=min(self.num_prefix, 8),
            param_dtype=torch.float32,
            compute_dtype=torch.float32,
            remat="none",
        )


# LM shapes assigned to every architecture (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}
