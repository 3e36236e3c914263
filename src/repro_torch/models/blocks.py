"""Per-family transformer blocks: init + full-sequence apply + decode apply
(the JAX package's ``models/blocks.py``).

The ``dense`` and ``moe`` families share :class:`DenseLayer`; the port
loops over its layers in Python, so gemma3's 5:1 local:global pattern is a
per-layer ``kind_flag`` read on the host, not a ``lax.switch``.  The
other families' blocks are not ported yet and raise, citing their ROADMAP
item.
"""
from __future__ import annotations

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mlp as MLP
from repro_torch.models import moe as MOE
from repro_torch.models import not_ported
from repro_torch.models import params as pr


# --------------------------------------------------------------- dense / moe
def init_dense_layer(generator, cfg) -> dict:
    p = {
        "ln_attn": L.init_rmsnorm(generator, cfg.d_model, cfg.param_dtype),
        "attn": A.init_attention(generator, cfg),
        "ln_mlp": L.init_rmsnorm(generator, cfg.d_model, cfg.param_dtype),
    }
    if cfg.family == "moe":
        p["moe"] = MOE.init_moe(generator, cfg)
    else:
        p["mlp"] = MLP.init_mlp(generator, cfg)
    return p


def _attn_kind(cfg, kind_flag):
    """kind_flag: 0 = primary attention, 1 = alternate (local window)."""
    if cfg.attn_kind == "local_global":
        return ("swa", cfg.rope_local_theta) if kind_flag else \
            ("full", cfg.rope_theta)
    if cfg.attn_kind == "swa":
        return ("swa", cfg.rope_theta)
    return ("full", cfg.rope_theta)


def _ffn(p, x, cfg):
    if cfg.family == "moe":
        return MOE.moe(p["moe"], x, cfg)
    return MLP.mlp(p["mlp"], x, cfg), {}


def dense_layer(p, x, *, cfg, kind_flag: int, positions,
                prefix_len: int = 0, return_kv: bool = False):
    kind, theta = _attn_kind(cfg, kind_flag)
    h = A.attention(p["attn"], L.rmsnorm(p["ln_attn"], x, cfg.norm_eps),
                    cfg=cfg, kind=kind, positions=positions, theta=theta,
                    prefix_len=prefix_len, return_kv=return_kv)
    kv = None
    if return_kv:
        h, kv = h
    x = x + h
    h, aux = _ffn(p, L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps), cfg)
    if return_kv:
        return x + h, aux, kv
    return x + h, aux


def dense_layer_decode(p, x, cache, *, cfg, kind_flag: int, cur_pos: int,
                       prefix_len: int = 0, ring: bool = False):
    kind, theta = _attn_kind(cfg, kind_flag)
    h, cache = A.attention_decode(
        p["attn"], L.rmsnorm(p["ln_attn"], x, cfg.norm_eps), cache,
        cfg=cfg, kind=kind, cur_pos=cur_pos, theta=theta,
        prefix_len=prefix_len, ring=ring)
    x = x + h
    h, _ = _ffn(p, L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps), cfg)
    return x + h, cache


class DenseLayer(pr.Tree):
    """One dense or MoE layer's parameters (``ln_attn``, ``attn``,
    ``ln_mlp`` and ``mlp`` or ``moe``) and its two applications."""

    def forward(self, x, **kw):
        return dense_layer(self, x, **kw)

    def decode(self, x, cache, **kw):
        return dense_layer_decode(self, x, cache, **kw)


# ------------------------------------------- families not ported yet
def init_rwkv_layer(*args, **kwargs):
    raise not_ported("ssm")


def rwkv_layer(*args, **kwargs):
    raise not_ported("ssm")


def init_mamba_layer(*args, **kwargs):
    raise not_ported("hybrid")


def mamba_layer(*args, **kwargs):
    raise not_ported("hybrid")


def init_shared_attn_block(*args, **kwargs):
    raise not_ported("hybrid")


def shared_attn_block(*args, **kwargs):
    raise not_ported("hybrid")


def shared_attn_block_decode(*args, **kwargs):
    raise not_ported("hybrid")


def init_encoder_layer(*args, **kwargs):
    raise not_ported("encdec")


def encoder_layer(*args, **kwargs):
    raise not_ported("encdec")


def init_decoder_layer(*args, **kwargs):
    raise not_ported("encdec")


def decoder_layer(*args, **kwargs):
    raise not_ported("encdec")


def decoder_layer_decode(*args, **kwargs):
    raise not_ported("encdec")
