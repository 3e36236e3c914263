"""Per-family transformer blocks: init + full-sequence apply + decode apply
(the JAX package's ``models/blocks.py``).

The ``dense``, ``moe`` and ``vlm`` families share :class:`DenseLayer`
(``vlm``, paligemma, with the prefix-LM mask); the port loops over its
layers in Python, so gemma3's 5:1 local:global pattern is a per-layer
``kind_flag`` read on the host, not a ``lax.switch``.  The ``ssm`` family
(rwkv6) has :class:`RwkvLayer`, the ``hybrid`` family (zamba2)
:class:`MambaLayer` and the weight-tied :class:`SharedAttnBlock`, the
``encdec`` family (whisper) :class:`EncoderLayer` and
:class:`DecoderLayer`.
"""
from __future__ import annotations

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import mlp as MLP
from repro_torch.models import moe as MOE
from repro_torch.models import params as pr
from repro_torch.models import rwkv6 as R6


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


def _attention_residual(p, x, cfg, kind_flag, positions, prefix_len,
                        return_kv=False):
    kind, theta = _attn_kind(cfg, kind_flag)
    if cfg.family == "vlm":
        kind = "prefix"
    h = A.attention(p["attn"], L.rmsnorm(p["ln_attn"], x, cfg.norm_eps),
                    cfg=cfg, kind=kind, positions=positions, theta=theta,
                    prefix_len=prefix_len, return_kv=return_kv)
    kv = None
    if return_kv:
        h, kv = h
    return x + h, kv


def dense_layer(p, x, *, cfg, kind_flag: int, positions,
                prefix_len: int = 0, return_kv: bool = False):
    x, kv = _attention_residual(p, x, cfg, kind_flag, positions, prefix_len,
                                return_kv)
    h, aux = _ffn(p, L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps), cfg)
    if return_kv:
        return x + h, aux, kv
    return x + h, aux


def dense_layer_replicas(ps, xs, *, cfg, kind_flag: int, positions,
                         prefix_len: int = 0):
    """:func:`dense_layer` over data replicas: ``ps[r]`` replica ``r``'s
    layer, ``xs[r]`` and ``positions[r]`` its rows of one global batch,
    in order.  Attention is row-local, so each replica runs its own; an
    MoE FFN runs :func:`~repro_torch.models.moe.moe_replicas`, whose
    groups and router statistics are the global batch's.  Returns (the
    replicas' outputs, aux)."""
    xs = [_attention_residual(p, x, cfg, kind_flag, pos, prefix_len)[0]
          for p, x, pos in zip(ps, xs, positions)]
    hin = [L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps) for p, x in zip(ps, xs)]
    if cfg.family == "moe":
        hs, aux = MOE.moe_replicas([p["moe"] for p in ps], hin, cfg)
    else:
        hs, aux = [MLP.mlp(p["mlp"], h, cfg) for p, h in zip(ps, hin)], {}
    return [x + h for x, h in zip(xs, hs)], aux


def dense_layer_decode(p, x, cache, *, cfg, kind_flag: int, cur_pos: int,
                       prefix_len: int = 0, ring: bool = False):
    kind, theta = _attn_kind(cfg, kind_flag)
    if cfg.family == "vlm":
        kind = "prefix"
    h, cache = A.attention_decode(
        p["attn"], L.rmsnorm(p["ln_attn"], x, cfg.norm_eps), cache,
        cfg=cfg, kind=kind, cur_pos=cur_pos, theta=theta,
        prefix_len=prefix_len, ring=ring)
    x = x + h
    h, _ = _ffn(p, L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps), cfg)
    return x + h, cache


class DenseLayer(pr.Tree):
    """One dense, MoE or vlm layer's parameters (``ln_attn``, ``attn``,
    ``ln_mlp`` and ``mlp`` or ``moe``) and its two applications."""

    def forward(self, x, **kw):
        return dense_layer(self, x, **kw)

    def decode(self, x, cache, **kw):
        return dense_layer_decode(self, x, cache, **kw)


# --------------------------------------------------------------------- rwkv
def init_rwkv_layer(generator, cfg) -> dict:
    return {
        "ln_t": L.init_rmsnorm(generator, cfg.d_model, cfg.param_dtype),
        "time_mix": R6.init_rwkv6(generator, cfg),
        "ln_c": L.init_rmsnorm(generator, cfg.d_model, cfg.param_dtype),
        "channel_mix": R6.init_rwkv_channel_mix(generator, cfg),
    }


def rwkv_layer(p, x, *, cfg, state=None):
    """state: (wkv, x_last_t, x_last_c) or None (zeros) -> (x, new state
    triple)."""
    wkv, xlt, xlc = (None, None, None) if state is None else state
    hin = L.rmsnorm(p["ln_t"], x, cfg.norm_eps)
    h, (wkv2, xlt2) = R6.rwkv6_time_mix(p["time_mix"], hin, cfg, state=wkv,
                                        x_last=xlt)
    x = x + h
    hin = L.rmsnorm(p["ln_c"], x, cfg.norm_eps)
    h, xlc2 = R6.rwkv_channel_mix(p["channel_mix"], hin, cfg, x_last=xlc)
    return x + h, (wkv2, xlt2, xlc2)


class RwkvLayer(pr.Tree):
    """One rwkv6 layer's parameters (``ln_t``, ``time_mix``, ``ln_c``,
    ``channel_mix``); a whole sequence or one decoded token alike."""

    def forward(self, x, **kw):
        return rwkv_layer(self, x, **kw)


# ------------------------------------------------------------------- hybrid
def init_mamba_layer(generator, cfg) -> dict:
    return {
        "ln": L.init_rmsnorm(generator, cfg.d_model, cfg.param_dtype),
        "mamba": M2.init_mamba2(generator, cfg),
    }


def init_shared_attn_block(generator, cfg) -> dict:
    """zamba2: one weight-tied attention+MLP block reused every k layers."""
    return {
        "ln_attn": L.init_rmsnorm(generator, cfg.d_model, cfg.param_dtype),
        "attn": A.init_attention(generator, cfg),
        "ln_mlp": L.init_rmsnorm(generator, cfg.d_model, cfg.param_dtype),
        "mlp": MLP.init_mlp(generator, cfg),
    }


def mamba_layer(p, x, *, cfg, state=None, conv_state=None):
    hin = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    h, new_state, new_conv = M2.mamba2_block(p["mamba"], hin, cfg,
                                             state=state,
                                             conv_state=conv_state)
    return x + h, new_state, new_conv


def shared_attn_block(p, x, *, cfg, positions, return_kv: bool = False):
    h = A.attention(p["attn"], L.rmsnorm(p["ln_attn"], x, cfg.norm_eps),
                    cfg=cfg, kind="full", positions=positions,
                    return_kv=return_kv)
    kv = None
    if return_kv:
        h, kv = h
    x = x + h
    h = MLP.mlp(p["mlp"], L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps), cfg)
    if return_kv:
        return x + h, kv
    return x + h


def shared_attn_block_decode(p, x, cache, *, cfg, cur_pos: int):
    h, cache = A.attention_decode(
        p["attn"], L.rmsnorm(p["ln_attn"], x, cfg.norm_eps), cache,
        cfg=cfg, kind="full", cur_pos=cur_pos)
    x = x + h
    h = MLP.mlp(p["mlp"], L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps), cfg)
    return x + h, cache


class MambaLayer(pr.Tree):
    """One zamba2 Mamba2 layer's parameters (``ln``, ``mamba``)."""

    def forward(self, x, **kw):
        return mamba_layer(self, x, **kw)


class SharedAttnBlock(pr.Tree):
    """zamba2's weight-tied attention+GeGLU block: one set of parameters,
    applied after every ``shared_attn_every``-th Mamba2 layer, each
    application with its own KV history when decoding."""

    def forward(self, x, **kw):
        return shared_attn_block(self, x, **kw)

    def decode(self, x, cache, **kw):
        return shared_attn_block_decode(self, x, cache, **kw)


# ------------------------------------------------------------------- encdec
def init_encoder_layer(generator, cfg) -> dict:
    return {
        "ln_attn": L.init_rmsnorm(generator, cfg.d_model, cfg.param_dtype),
        "attn": A.init_attention(generator, cfg),
        "ln_mlp": L.init_rmsnorm(generator, cfg.d_model, cfg.param_dtype),
        "mlp": MLP.init_mlp(generator, cfg),
    }


def encoder_layer(p, x, *, cfg, positions):
    """Bidirectional self-attention (RoPE over the frame positions) and the
    MLP."""
    h = A.attention(p["attn"], L.rmsnorm(p["ln_attn"], x, cfg.norm_eps),
                    cfg=cfg, kind="bidir", positions=positions)
    x = x + h
    h = MLP.mlp(p["mlp"], L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps), cfg)
    return x + h


def init_decoder_layer(generator, cfg) -> dict:
    return {
        "ln_self": L.init_rmsnorm(generator, cfg.d_model, cfg.param_dtype),
        "self_attn": A.init_attention(generator, cfg),
        "ln_cross": L.init_rmsnorm(generator, cfg.d_model, cfg.param_dtype),
        "cross_attn": A.init_attention(generator, cfg),
        "ln_mlp": L.init_rmsnorm(generator, cfg.d_model, cfg.param_dtype),
        "mlp": MLP.init_mlp(generator, cfg),
    }


def decoder_layer(p, x, enc_out, *, cfg, positions, return_kv: bool = False):
    """Causal self-attention, cross attention on ``enc_out``, the MLP.
    ``return_kv``: also (self k, self v, cross k, cross v)."""
    h = A.attention(p["self_attn"], L.rmsnorm(p["ln_self"], x, cfg.norm_eps),
                    cfg=cfg, kind="causal", positions=positions,
                    return_kv=return_kv)
    kv = None
    if return_kv:
        h, kv = h
    x = x + h
    xin = L.rmsnorm(p["ln_cross"], x, cfg.norm_eps)
    ck, cv = A.cross_kv(p["cross_attn"], enc_out.to(x.dtype))
    x = x + A.cross_attention_kv(p["cross_attn"], xin, ck, cv, cfg=cfg)
    h = MLP.mlp(p["mlp"], L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps), cfg)
    if return_kv:
        return x + h, (kv[0], kv[1], ck, cv)
    return x + h


def decoder_layer_decode(p, x, cache, enc_kv, *, cfg, cur_pos: int):
    """One token: self-attention over ``cache`` (written in place), cross
    attention against the encoder's cached ``enc_kv`` k/v."""
    h, cache = A.attention_decode(
        p["self_attn"], L.rmsnorm(p["ln_self"], x, cfg.norm_eps), cache,
        cfg=cfg, kind="causal", cur_pos=cur_pos)
    x = x + h
    xin = L.rmsnorm(p["ln_cross"], x, cfg.norm_eps)
    x = x + A.cross_attention_kv(p["cross_attn"], xin, enc_kv["k"],
                                 enc_kv["v"], cfg=cfg)
    h = MLP.mlp(p["mlp"], L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps), cfg)
    return x + h, cache


class EncoderLayer(pr.Tree):
    """One whisper encoder layer's parameters (``ln_attn``, ``attn``,
    ``ln_mlp``, ``mlp``)."""

    def forward(self, x, **kw):
        return encoder_layer(self, x, **kw)


class DecoderLayer(pr.Tree):
    """One whisper decoder layer's parameters (``ln_self``, ``self_attn``,
    ``ln_cross``, ``cross_attn``, ``ln_mlp``, ``mlp``) and its two
    applications."""

    def forward(self, x, enc_out, **kw):
        return decoder_layer(self, x, enc_out, **kw)

    def decode(self, x, cache, enc_kv, **kw):
        return decoder_layer_decode(self, x, cache, enc_kv, **kw)
