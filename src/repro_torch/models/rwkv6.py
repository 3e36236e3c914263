"""RWKV-6 ("Finch") block — attention-free, data-dependent per-channel
decay (the JAX package's ``models/rwkv6.py``).

Time-mix: chunked linear-attention form.  Within a chunk all decay factors
are expressed relative to the *later* timestep, so every exponent is <= 0
and the math is overflow-safe in float32 (no 1/decay blowups).  The
cross-chunk state (B, H, K, V) float32 is carried by a Python loop over
the chunks, as the reference's ``lax.scan`` carries it; decode is the
single-token recurrence.  Channel-mix: RWKV's two-layer squared-ReLU FFN.

Plain torch, as the reference computes both scans outside any Pallas
kernel.  The reference's simplification is kept: token-shift mixing
coefficients are static per channel (RWKV-5 style) while the decay ``w``
keeps the full data-dependent LoRA of RWKV-6.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import params as pr

W_LORA = 64


def init_rwkv6(generator, cfg) -> dict:
    d = cfg.d_model
    dt = cfg.param_dtype
    dev = generator.device
    f32 = torch.float32
    return {
        "mu": pr.const(torch.full((5, d), 0.5, dtype=f32, device=dev),
                       (None, "embed")),
        "wr": pr.normal(generator, (d, d), ("embed", "heads_flat"), dt),
        "wk": pr.normal(generator, (d, d), ("embed", "heads_flat"), dt),
        "wv": pr.normal(generator, (d, d), ("embed", "heads_flat"), dt),
        "wg": pr.normal(generator, (d, d), ("embed", "heads_flat"), dt),
        "w0": pr.const(torch.full((d,), -6.0, dtype=f32, device=dev),
                       ("heads_flat",)),
        "w_lora_a": pr.normal(generator, (d, W_LORA), ("embed", None), f32,
                              scale=0.1),
        "w_lora_b": pr.normal(generator, (W_LORA, d), (None, "heads_flat"),
                              f32, scale=0.1),
        "u": pr.const(torch.zeros((d,), dtype=f32, device=dev),
                      ("heads_flat",)),
        "wo": pr.normal(generator, (d, d), ("heads_flat", "embed"), dt),
        "ln_x": {"scale": pr.ones((d,), ("norm",), dt, dev)},
    }


def init_rwkv_channel_mix(generator, cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    return {
        "mu": pr.const(torch.full((2, d), 0.5, dtype=torch.float32,
                                  device=generator.device), (None, "embed")),
        "wk": pr.normal(generator, (d, f), ("embed", "mlp"), dt),
        "wv": pr.normal(generator, (f, d), ("mlp", "embed"), dt),
    }


def _token_shift(x, last):
    """shift(x)[t] = x[t-1]; position 0 takes ``last`` (decode carry)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _mix(x, prev, mu):
    return x + (prev - x) * mu[None, None, :].to(x.dtype)


def _proj(x, w):
    return torch.einsum("bsd,de->bse", x, w.to(x.dtype))


def _chunk_step(s_run, rq, kq, vq, wq, uh, tri_lt):
    """One chunk of the parallel form: (B, Q, H, K) float32 inputs, the
    running state (B, H, K, V) -> (new state, y (B, Q, H, V))."""
    cum = torch.cumsum(wq, dim=1)                           # (B,Q,H,K)
    # scores[t,s<t] = sum_k r_t k_s exp(cum[t-1]-cum[s]) ; exponent<=0
    cum_tm1 = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
    expo = cum_tm1[:, :, None] - cum[:, None, :, :]         # (B,T,S,H,K)
    expo = torch.where(tri_lt[None, :, :, None, None] > 0, expo, -1e30)
    a = torch.einsum("bthk,bshk,btshk->bths", rq, kq, torch.exp(expo))
    y_intra = torch.einsum("bths,bshv->bthv", a, vq)
    # bonus current-token term
    y_u = (rq * uh[None, None] * kq).sum(-1, keepdim=True) * vq
    # inter-chunk from running state
    y_off = torch.einsum("bthk,bhkv->bthv", rq * torch.exp(cum_tm1), s_run)
    # state update (all exponents <= 0)
    last = cum[:, -1:, :, :]
    k_dec = kq * torch.exp(last - cum)
    s_new = torch.exp(last[:, 0])[..., None] * s_run + \
        torch.einsum("bshk,bshv->bhkv", k_dec, vq)
    return s_new, y_intra + y_u + y_off


def rwkv6_time_mix(p, x, cfg, state=None, x_last=None, chunk: int = 32):
    """x (B, S, D).  state: (wkv (B,H,K,V) float32, x_last (B,D)) for
    decode / carried prefill; returns (out, (new_state, x[:, -1]))."""
    b, s, d = x.shape
    h = cfg.rwkv_heads
    hk = cfg.rwkv_head_dim
    if x_last is None:
        x_last = x.new_zeros((b, d))
    prev = _token_shift(x, x_last)
    mu = p["mu"]
    r = _proj(_mix(x, prev, mu[0]), p["wr"])
    k = _proj(_mix(x, prev, mu[1]), p["wk"])
    v = _proj(_mix(x, prev, mu[2]), p["wv"])
    g = _proj(_mix(x, prev, mu[3]), p["wg"])
    # data-dependent decay (RWKV-6 LoRA):  log w = -exp(w0 + lora(x_mix))
    wx = _mix(x, prev, mu[4]).float()
    lora = torch.tanh(wx @ p["w_lora_a"]) @ p["w_lora_b"]
    logw = -torch.exp(torch.clamp(p["w0"][None, None, :] + lora, -20.0, 4.0))

    rh = r.reshape(b, s, h, hk).float()
    kh = k.reshape(b, s, h, hk).float()
    vh = v.reshape(b, s, h, hk).float()
    lw = logw.reshape(b, s, h, hk)
    uh = p["u"].reshape(h, hk)

    if state is None:
        state = torch.zeros((b, h, hk, hk), dtype=torch.float32,
                            device=x.device)

    if s == 1:  # ---- decode recurrence
        kv = torch.einsum("bhk,bhv->bhkv", kh[:, 0], vh[:, 0])
        y = torch.einsum("bhk,bhkv->bhv", rh[:, 0],
                         state + uh[None, :, :, None] * kv)
        new_state = torch.exp(lw[:, 0])[..., None] * state + kv
        ys = y.reshape(b, 1, d)
    else:       # ---- chunked parallel form, the chunks in order
        q = chunk
        while s % q:
            q -= 1
        tri_lt = torch.tril(torch.ones((q, q), dtype=torch.float32,
                                       device=x.device), diagonal=-1)
        new_state, ys = state, []
        for c0 in range(0, s, q):
            c = slice(c0, c0 + q)
            new_state, y = _chunk_step(new_state, rh[:, c], kh[:, c],
                                       vh[:, c], lw[:, c], uh, tri_lt)
            ys.append(y)
        ys = torch.cat(ys, dim=1).reshape(b, s, d)

    y = L.rmsnorm(p["ln_x"], ys.to(x.dtype), cfg.norm_eps)
    y = y * F.silu(g)
    out = _proj(y, p["wo"])
    return out, (new_state, x[:, -1, :])


def rwkv_channel_mix(p, x, cfg, x_last=None):
    b, s, d = x.shape
    if x_last is None:
        x_last = x.new_zeros((b, d))
    prev = _token_shift(x, x_last)
    xk = _mix(x, prev, p["mu"][0])
    k = torch.einsum("bsd,df->bsf", xk, p["wk"].to(x.dtype))
    k = torch.square(F.relu(k))
    out = torch.einsum("bsf,fd->bsd", k, p["wv"].to(x.dtype))
    return out, x[:, -1, :]
