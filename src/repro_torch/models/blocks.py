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

Over a mesh's model axis each layer runs over a
:class:`~repro_torch.launch.tensor_parallel.Group` of its pieces (the
``*_groups`` functions for the dense, MoE and vlm layers; the
``*_pieces`` functions for the rwkv6, Mamba2, shared, encoder and decoder
layers): the norms on the lead, attention, the MLPs, the time and channel
mixes and the SSD in pieces.  The rwkv6, Mamba2, shared, encoder and
decoder layers on one device are the one-piece case of their ``*_pieces``
form.
"""
from __future__ import annotations

from repro_torch.launch import tensor_parallel as tp
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


def _layer_kind(cfg, kind_flag):
    """:func:`_attn_kind`, the prefix-LM mask for the vlm family."""
    kind, theta = _attn_kind(cfg, kind_flag)
    return ("prefix" if cfg.family == "vlm" else kind), theta


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


def dense_layer_groups(gs, xs, *, cfg, kind_flag: int, positions,
                       prefix_len: int = 0, return_kv: bool = False):
    """:func:`dense_layer_replicas` over data replicas whose layers are
    cut over the mesh's model axis: ``gs[r]`` replica ``r``'s
    :class:`~repro_torch.launch.tensor_parallel.Group` of the layer's
    pieces, ``xs[r]`` and ``positions[r]`` its rows on the group's lead.
    The norms run on the lead; attention and the MLP are Megatron pieces,
    an MoE FFN expert pieces over the global batch's groups.  Returns
    (the replicas' outputs, aux) and, with ``return_kv``, each replica's
    pieces' k/v."""
    kind, theta = _layer_kind(cfg, kind_flag)
    outs, kvs = [], []
    for g, x, pos in zip(gs, xs, positions):
        h = A.attention_pieces(
            g["attn"], L.rmsnorm(g.lead["ln_attn"], x, cfg.norm_eps),
            cfg=cfg, kind=kind, positions=pos, theta=theta,
            prefix_len=prefix_len, return_kv=return_kv)
        if return_kv:
            h, kv = h
            kvs.append(kv)
        outs.append(x + h)
    out, aux = _ffn_groups(gs, outs, cfg)
    return (out, aux, kvs) if return_kv else (out, aux)


def _ffn_groups(gs, xs, cfg):
    hin = [L.rmsnorm(g.lead["ln_mlp"], x, cfg.norm_eps)
           for g, x in zip(gs, xs)]
    if cfg.family == "moe":
        hs, aux = MOE.moe_replicas([g["moe"] for g in gs], hin, cfg)
    else:
        hs, aux = [MLP.mlp_pieces(g["mlp"], h, cfg)
                   for g, h in zip(gs, hin)], {}
    return [x + h for x, h in zip(xs, hs)], aux


def dense_layer_decode_groups(gs, xs, caches, *, cfg, kind_flag: int,
                              cur_pos: int, prefix_len: int = 0,
                              ring: bool = False):
    """:func:`dense_layer_decode` over data replicas whose layers are cut
    over the mesh's model axis: ``caches[r][j]`` the layer's cache of
    replica ``r``'s piece ``j`` (its rows, its kv heads), written in
    place.  Returns the replicas' outputs."""
    kind, theta = _layer_kind(cfg, kind_flag)
    outs = []
    for g, x, cache in zip(gs, xs, caches):
        h = A.attention_decode_pieces(
            g["attn"], L.rmsnorm(g.lead["ln_attn"], x, cfg.norm_eps), cache,
            cfg=cfg, kind=kind, cur_pos=cur_pos, theta=theta,
            prefix_len=prefix_len, ring=ring)
        outs.append(x + h)
    return _ffn_groups(gs, outs, cfg)[0]


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
    triple).  The one-piece case of :func:`rwkv_layer_pieces`."""
    x, (wkv, xlt, xlc) = rwkv_layer_pieces(
        tp.Group.one(p, x.device), x, cfg=cfg,
        states=None if state is None else [state[0]],
        carries=None if state is None else state[1:])
    return x, (wkv[0], xlt, xlc)


def rwkv_layer_pieces(g, x, *, cfg, states=None, carries=None):
    """:func:`rwkv_layer` over a group of model pieces: ``states`` the
    pieces' wkv states (or None), ``carries`` the two token-shift carries
    on the lead (or None) -> (x, (the pieces' new wkv states, the new
    carries))."""
    xlt, xlc = (None, None) if carries is None else carries
    hin = L.rmsnorm(g.lead["ln_t"], x, cfg.norm_eps)
    h, (wkv2, xlt2) = R6.time_mix_pieces(g["time_mix"], hin, cfg,
                                         states=states, x_last=xlt)
    x = x + h
    hin = L.rmsnorm(g.lead["ln_c"], x, cfg.norm_eps)
    h, xlc2 = R6.channel_mix_pieces(g["channel_mix"], hin, cfg, x_last=xlc)
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
    """The one-piece case of :func:`mamba_layer_pieces`."""
    x, states, convs = mamba_layer_pieces(
        tp.Group.one(p, x.device), x, cfg=cfg,
        states=None if state is None else [state],
        conv_states=None if conv_state is None else [conv_state])
    return x, states[0], convs[0]


def mamba_layer_pieces(g, x, *, cfg, states=None, conv_states=None):
    """:func:`mamba_layer` over a group of model pieces -> (x, the
    pieces' new SSD states, their new conv tails)."""
    hin = L.rmsnorm(g.lead["ln"], x, cfg.norm_eps)
    h, states, convs = M2.mamba2_pieces(g["mamba"], hin, cfg, states,
                                        conv_states)
    return x + h, states, convs


def shared_attn_block(p, x, *, cfg, positions, return_kv: bool = False):
    """The one-piece case of :func:`shared_attn_block_pieces`."""
    out = shared_attn_block_pieces(tp.Group.one(p, x.device), x, cfg=cfg,
                                   positions=positions, return_kv=return_kv)
    return (out[0], out[1][0]) if return_kv else out


def shared_attn_block_pieces(g, x, *, cfg, positions,
                             return_kv: bool = False):
    """zamba2's shared attention + MLP block over a group of model pieces
    (Megatron attention and MLP); with ``return_kv`` also the pieces'
    k/v."""
    h = A.attention_pieces(g["attn"], L.rmsnorm(g.lead["ln_attn"], x,
                                                cfg.norm_eps),
                           cfg=cfg, kind="full", positions=positions,
                           return_kv=return_kv)
    if return_kv:
        h, kvs = h
    x = x + h
    h = MLP.mlp_pieces(g["mlp"], L.rmsnorm(g.lead["ln_mlp"], x,
                                           cfg.norm_eps), cfg)
    return (x + h, kvs) if return_kv else x + h


def shared_attn_block_decode(p, x, cache, *, cfg, cur_pos: int):
    """The one-piece case of :func:`shared_attn_block_decode_pieces`."""
    return shared_attn_block_decode_pieces(
        tp.Group.one(p, x.device), x, [cache], cfg=cfg,
        cur_pos=cur_pos), cache


def shared_attn_block_decode_pieces(g, x, caches, *, cfg, cur_pos: int):
    """One token through the shared block over a group of model pieces:
    ``caches[j]`` piece ``j``'s k/v history of this application, written
    in place."""
    h = A.attention_decode_pieces(
        g["attn"], L.rmsnorm(g.lead["ln_attn"], x, cfg.norm_eps), caches,
        cfg=cfg, kind="full", cur_pos=cur_pos)
    x = x + h
    h = MLP.mlp_pieces(g["mlp"], L.rmsnorm(g.lead["ln_mlp"], x,
                                           cfg.norm_eps), cfg)
    return x + h


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
    MLP.  The one-piece case of :func:`encoder_layer_pieces`."""
    return encoder_layer_pieces(tp.Group.one(p, x.device), x, cfg=cfg,
                                positions=positions)


def encoder_layer_pieces(g, x, *, cfg, positions):
    """:func:`encoder_layer` over a group of model pieces."""
    h = A.attention_pieces(g["attn"], L.rmsnorm(g.lead["ln_attn"], x,
                                                cfg.norm_eps),
                           cfg=cfg, kind="bidir", positions=positions)
    x = x + h
    h = MLP.mlp_pieces(g["mlp"], L.rmsnorm(g.lead["ln_mlp"], x,
                                           cfg.norm_eps), cfg)
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
    ``return_kv``: also (self k, self v, cross k, cross v).  The one-piece
    case of :func:`decoder_layer_pieces`."""
    out = decoder_layer_pieces(tp.Group.one(p, x.device), x, [enc_out],
                               cfg=cfg, positions=positions,
                               return_kv=return_kv)
    if return_kv:
        x, (kvs, cross) = out
        return x, (*kvs[0], *cross[0])
    return out


def decoder_layer_pieces(g, x, encs, *, cfg, positions,
                         return_kv: bool = False):
    """:func:`decoder_layer` over a group of model pieces: ``encs[j]``
    the encoder's output on piece ``j``'s device (one copy for every
    layer).  ``return_kv``: also (the pieces' self k/v, their cross
    k/v)."""
    h = A.attention_pieces(g["self_attn"], L.rmsnorm(g.lead["ln_self"], x,
                                                     cfg.norm_eps),
                           cfg=cfg, kind="causal", positions=positions,
                           return_kv=return_kv)
    if return_kv:
        h, kvs = h
    x = x + h
    xin = L.rmsnorm(g.lead["ln_cross"], x, cfg.norm_eps)
    cross = A.cross_kv_pieces(g["cross_attn"],
                              [e.to(x.dtype) for e in encs], cfg)
    x = x + A.cross_attention_pieces(g["cross_attn"], xin, cross, cfg=cfg)
    h = MLP.mlp_pieces(g["mlp"], L.rmsnorm(g.lead["ln_mlp"], x,
                                           cfg.norm_eps), cfg)
    return (x + h, (kvs, cross)) if return_kv else x + h


def decoder_layer_decode(p, x, cache, enc_kv, *, cfg, cur_pos: int):
    """One token: self-attention over ``cache`` (written in place), cross
    attention against the encoder's cached ``enc_kv`` k/v.  The one-piece
    case of :func:`decoder_layer_decode_pieces`."""
    return decoder_layer_decode_pieces(
        tp.Group.one(p, x.device), x, [cache], [(enc_kv["k"], enc_kv["v"])],
        cfg=cfg, cur_pos=cur_pos), cache


def decoder_layer_decode_pieces(g, x, caches, cross, *, cfg, cur_pos: int):
    """One token through a decoder layer over a group of model pieces:
    ``caches[j]`` piece ``j``'s self-attention cache (written in place),
    ``cross[j]`` its cached cross k/v."""
    h = A.attention_decode_pieces(
        g["self_attn"], L.rmsnorm(g.lead["ln_self"], x, cfg.norm_eps),
        caches, cfg=cfg, kind="causal", cur_pos=cur_pos)
    x = x + h
    xin = L.rmsnorm(g.lead["ln_cross"], x, cfg.norm_eps)
    x = x + A.cross_attention_pieces(g["cross_attn"], xin, cross, cfg=cfg)
    h = MLP.mlp_pieces(g["mlp"], L.rmsnorm(g.lead["ln_mlp"], x,
                                           cfg.norm_eps), cfg)
    return x + h


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
