"""GQA/MQA attention with full / sliding-window / prefix-LM masking and a
decode path over an externally managed KV cache (the JAX package's
``models/attention.py``).

Plain torch einsums and a float32 softmax, as the reference computes
attention outside any Pallas kernel.  ``cross_attention`` is whisper's
decoder reading the encoder's output: no RoPE and no mask.

Over a mesh's model axis (:func:`attention_pieces`,
:func:`attention_decode_pieces`; ``launch/tensor_parallel.py``) ``wq`` is
column-parallel over ``heads``, ``wk`` and ``wv`` over ``kv_heads`` (or
whole in every piece where the model axis does not divide them: piece
``j`` then attends with the kv heads its q heads map to), ``wo``
row-parallel, and the pieces' partial outputs are reduced out.  Each
piece holds its own decode cache of the kv heads it holds.  Whisper's
cross attention (:func:`cross_attention_pieces`) is cut alike: the
decoder's ``q`` over ``heads``, the encoder output's ``k`` / ``v`` over
``kv_heads``, the cross cache likewise; the encoder's ``bidir`` kind runs
in :func:`attention_pieces`.
"""
from __future__ import annotations

import torch

from repro_torch.launch import tensor_parallel as tp
from repro_torch.models import layers as L
from repro_torch.models import params as pr

NEG_INF = -2.0 ** 30


def init_attention(generator, cfg) -> dict:
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    return {
        "wq": pr.normal(generator, (d, h, hd),
                        ("embed", "heads", "head_dim"), dt),
        "wk": pr.normal(generator, (d, kh, hd),
                        ("embed", "kv_heads", "head_dim"), dt),
        "wv": pr.normal(generator, (d, kh, hd),
                        ("embed", "kv_heads", "head_dim"), dt),
        "wo": pr.normal(generator, (h, hd, d),
                        ("heads", "head_dim", "embed"), dt),
    }


def _mask(q_pos, kv_pos, kind: str, window: int, prefix_len: int):
    """(..., S_q, S_kv) additive float32 mask.  kind: causal | swa |
    prefix | bidir."""
    causal = q_pos[..., :, None] >= kv_pos[..., None, :]
    if kind == "swa":
        keep = causal & (q_pos[..., :, None] - kv_pos[..., None, :] < window)
    elif kind == "prefix":
        # prefix-LM (paligemma): full attention within [0, prefix_len)
        keep = causal | (kv_pos[..., None, :] < prefix_len)
    elif kind == "bidir":
        keep = torch.ones_like(causal)
    else:
        keep = causal
    return torch.where(keep, 0.0, NEG_INF).float()


def _qkv(p, x, cfg, positions, theta, rope: bool = True):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if rope:
        q = L.apply_rope(q, positions, theta)
        k = L.apply_rope(k, positions, theta)
    q = q * (cfg.head_dim ** -0.5)
    return q, k, v


def _sdpa(q, k, v, mask, softcap: float = 0.0):
    """q (B,S,H,D) grouped against k/v (B,T,Kh,D); scores and softmax in
    float32."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    q = q.reshape(b, s, kh, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float()
    scores = L.softcap(scores, softcap)
    scores = scores + (mask[:, None, None, :, :] if mask.ndim == 3 else mask)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)


def attention(p, x, *, cfg, kind: str, positions,
              theta: float | None = None, prefix_len: int = 0,
              rope: bool = True, return_kv: bool = False):
    """Full-sequence (prefill) attention."""
    theta = cfg.rope_theta if theta is None else theta
    q, k, v = _qkv(p, x, cfg, positions, theta, rope)
    mask = _mask(positions, positions, kind, cfg.window, prefix_len)
    out = _sdpa(q, k, v, mask, cfg.logit_softcap)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    if return_kv:
        return out, (k, v)
    return out


def attention_decode(p, x, cache, *, cfg, kind: str, cur_pos: int,
                     theta: float | None = None, prefix_len: int = 0,
                     ring: bool = False):
    """Single-token decode. x (B, 1, D); cache dict with k/v (B, T, Kh, Dh),
    written in place at this token's slot and returned.

    ``ring=True``: the cache is a ring buffer of length T (== the sliding
    window for swa layers) — slot ``cur_pos % T`` is overwritten and kv
    positions are reconstructed modularly, so local layers carry
    O(window) state, not O(seq).
    """
    theta = cfg.rope_theta if theta is None else theta
    b = x.shape[0]
    positions = torch.full((b, 1), cur_pos, dtype=torch.int32,
                           device=x.device)
    q, k_new, v_new = _qkv(p, x, cfg, positions, theta)
    k, v, mask = _cache_write(cache, k_new, v_new, cfg, kind, cur_pos,
                              prefix_len, ring)
    out = _sdpa(q, k.to(x.dtype), v.to(x.dtype), mask.expand(b, 1, -1),
                cfg.logit_softcap)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return out, {"k": k, "v": v}


def _cache_write(cache, k_new, v_new, cfg, kind, cur_pos, prefix_len,
                 ring):
    """Write this token's k/v into the cache in place -> (k, v, the (1,
    1, T) additive mask of the slots it may attend to)."""
    k, v = cache["k"], cache["v"]
    t = k.shape[1]
    slot = (cur_pos % t) if ring else cur_pos
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)
    slots = torch.arange(t, dtype=torch.int32, device=k.device)[None, :]
    if ring:
        # token position stored in slot s after writing cur_pos
        kv_pos = cur_pos - ((cur_pos - slots) % t)
    else:
        kv_pos = slots
    valid = (kv_pos >= 0) & (kv_pos <= cur_pos)
    if kind == "swa":
        valid &= kv_pos > cur_pos - cfg.window
    elif kind == "prefix":
        valid |= (kv_pos < prefix_len) & (kv_pos >= 0)
    mask = torch.where(valid, 0.0, NEG_INF).float()[:, None, :]  # (1, 1, T)
    return k, v, mask


# ------------------------------------------------------ over model pieces
def _heads_cut(g, cfg) -> bool:
    h_loc = g.lead["wq"].shape[1]
    if h_loc == cfg.num_heads:        # heads whole in every piece
        if g.lead["wk"].shape[1] < cfg.num_kv_heads:
            raise ValueError("kv heads cut over the model axis while the "
                             "q heads are whole")
        return False
    return True


def _kv_of_piece(j, q, k, v, cfg):
    """The kv heads piece ``j``'s q heads ``q`` attend with."""
    lo, hi, index = tp.kv_heads_of(j, q.shape[2], cfg.num_heads,
                                   cfg.num_kv_heads, k.shape[2])
    k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    if index is not None:
        index = index.to(k.device)
        k, v = k.index_select(2, index), v.index_select(2, index)
    return k, v


def attention_pieces(g, x, *, cfg, kind: str, positions,
                     theta: float | None = None, prefix_len: int = 0,
                     return_kv: bool = False):
    """:func:`attention` over a group of model pieces (``x`` and
    ``positions`` on the lead; the output there).  With ``return_kv`` the
    k/v are the pieces' own, one pair a piece.  Heads the model axis does
    not divide are computed whole on the lead."""
    if not _heads_cut(g, cfg):
        out = attention(g.lead, x, cfg=cfg, kind=kind, positions=positions,
                        theta=theta, prefix_len=prefix_len,
                        return_kv=return_kv)
        return (out[0], [out[1]]) if return_kv else out
    theta = cfg.rope_theta if theta is None else theta
    outs, kvs, masks = [], [], {}
    for j, (p, xj) in enumerate(zip(g.trees, tp.copy_in(g, x))):
        dev = xj.device
        pos = positions.to(dev)
        if dev not in masks:
            masks[dev] = _mask(pos, pos, kind, cfg.window, prefix_len)
        q, k, v = _qkv(p, xj, cfg, pos, theta)
        ks, vs = _kv_of_piece(j, q, k, v, cfg)
        out = _sdpa(q, ks, vs, masks[dev], cfg.logit_softcap)
        outs.append(torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)))
        kvs.append((k, v))
    out = tp.reduce_out(g, outs)
    return (out, kvs) if return_kv else out


def attention_decode_pieces(g, x, caches, *, cfg, kind: str, cur_pos: int,
                            theta: float | None = None, prefix_len: int = 0,
                            ring: bool = False):
    """:func:`attention_decode` over a group of model pieces: ``caches[j]``
    piece ``j``'s cache (its kv heads), written in place.  -> the output
    on the lead."""
    if not _heads_cut(g, cfg):
        return attention_decode(g.lead, x, caches[0], cfg=cfg, kind=kind,
                                cur_pos=cur_pos, theta=theta,
                                prefix_len=prefix_len, ring=ring)[0]
    theta = cfg.rope_theta if theta is None else theta
    b = x.shape[0]
    outs = []
    for j, (p, xj) in enumerate(zip(g.trees, tp.copy_in(g, x))):
        positions = torch.full((b, 1), cur_pos, dtype=torch.int32,
                               device=xj.device)
        q, k_new, v_new = _qkv(p, xj, cfg, positions, theta)
        k, v, mask = _cache_write(caches[j], k_new, v_new, cfg, kind,
                                  cur_pos, prefix_len, ring)
        ks, vs = _kv_of_piece(j, q, k.to(x.dtype), v.to(x.dtype), cfg)
        out = _sdpa(q, ks, vs, mask.expand(b, 1, -1), cfg.logit_softcap)
        outs.append(torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)))
    return tp.reduce_out(g, outs)


def cross_kv(p, kv_src):
    """The cross attention's k/v (B, T_enc, Kh, Dh) of the encoder's
    output ``kv_src``, in its dtype."""
    k = torch.einsum("bsd,dhk->bshk", kv_src, p["wk"].to(kv_src.dtype))
    v = torch.einsum("bsd,dhk->bshk", kv_src, p["wv"].to(kv_src.dtype))
    return k, v


def cross_kv_pieces(g, srcs, cfg) -> list:
    """:func:`cross_kv` over a group of model pieces: ``srcs[j]`` the
    encoder's output on piece ``j``'s device -> each piece's k/v of the kv
    heads it holds (one pair, the lead's, where the heads are whole)."""
    if not _heads_cut(g, cfg):
        return [cross_kv(g.lead, srcs[0])]
    return [cross_kv(t, src) for t, src in zip(g.trees, srcs)]


def cross_attention_kv(p, x, k, v, *, cfg):
    """x (B, S, D) attending to every position of the encoder's k/v: a
    zero float32 (B, S, T_enc) mask through :func:`_sdpa`.  The one-piece
    case of :func:`cross_attention_pieces`."""
    return cross_attention_pieces(tp.Group.one(p, x.device), x, [(k, v)],
                                  cfg=cfg)


def cross_attention_pieces(g, x, kvs, *, cfg):
    """:func:`cross_attention_kv` over a group of model pieces (``x`` and
    the output on the lead): ``wq`` column-parallel over ``heads``, each
    piece attending with its k/v ``kvs[j]`` (:func:`cross_kv_pieces`),
    ``wo`` row-parallel, reduced out."""
    if not _heads_cut(g, cfg):
        g = g.first()
    outs = []
    for j, (p, xj, (k, v)) in enumerate(zip(g.trees, tp.copy_in(g, x),
                                            kvs)):
        q = torch.einsum("bsd,dhk->bshk", xj, p["wq"].to(x.dtype))
        q = q * (cfg.head_dim ** -0.5)
        ks, vs = _kv_of_piece(j, q, k.to(x.dtype), v.to(x.dtype), cfg)
        zero = torch.zeros((x.shape[0], x.shape[1], k.shape[1]),
                           dtype=torch.float32, device=xj.device)
        out = _sdpa(q, ks, vs, zero, cfg.logit_softcap)
        outs.append(torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)))
    return tp.reduce_out(g, outs)


def cross_attention(p, x, kv_src, *, cfg):
    """Encoder-decoder cross attention (whisper). No RoPE, no mask."""
    k, v = cross_kv(p, kv_src.to(x.dtype))
    return cross_attention_kv(p, x, k, v, cfg=cfg)
