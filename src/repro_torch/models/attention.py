"""GQA/MQA attention with full / sliding-window / prefix-LM masking and a
decode path over an externally managed KV cache (the JAX package's
``models/attention.py``).

Plain torch einsums and a float32 softmax, as the reference computes
attention outside any Pallas kernel.  ``cross_attention`` is whisper's
decoder reading the encoder's output: no RoPE and no mask.
"""
from __future__ import annotations

import torch

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
    k, v = cache["k"], cache["v"]
    t = k.shape[1]
    slot = (cur_pos % t) if ring else cur_pos
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)
    slots = torch.arange(t, dtype=torch.int32, device=x.device)[None, :]
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
    out = _sdpa(q, k.to(x.dtype), v.to(x.dtype), mask.expand(b, 1, t),
                cfg.logit_softcap)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return out, {"k": k, "v": v}


def cross_kv(p, kv_src):
    """The cross attention's k/v (B, T_enc, Kh, Dh) of the encoder's
    output ``kv_src``, in its dtype."""
    k = torch.einsum("bsd,dhk->bshk", kv_src, p["wk"].to(kv_src.dtype))
    v = torch.einsum("bsd,dhk->bshk", kv_src, p["wv"].to(kv_src.dtype))
    return k, v


def cross_attention_kv(p, x, k, v, *, cfg):
    """x (B, S, D) attending to every position of the encoder's k/v: a
    zero float32 (B, S, T_enc) mask through :func:`_sdpa`."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    q = q * (cfg.head_dim ** -0.5)
    zero = torch.zeros((x.shape[0], x.shape[1], k.shape[1]),
                       dtype=torch.float32, device=x.device)
    out = _sdpa(q, k.to(x.dtype), v.to(x.dtype), zero, cfg.logit_softcap)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def cross_attention(p, x, kv_src, *, cfg):
    """Encoder-decoder cross attention (whisper). No RoPE, no mask."""
    k, v = cross_kv(p, kv_src.to(x.dtype))
    return cross_attention_kv(p, x, k, v, cfg=cfg)
