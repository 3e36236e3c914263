"""Mamba2 (SSD) block — the zamba2 backbone (the JAX package's
``models/mamba2.py``).

Training/prefill uses the chunked SSD algorithm (Mamba2 paper,
"state-space duality"): a within-chunk quadratic attention-like term plus
an inter-chunk state recurrence, carried chunk by chunk by a Python loop
as the reference's ``lax.scan`` carries it (the per-step working set stays
(B, Q, Q, H)).  Decode is the single-token recurrence over the
(B, H, P, N) float32 state.  The scan runs in float32, or in the
activations' dtype where that is wider (a float64 model is float64
throughout, the rounding yardstick of a float32 one).  Plain torch, as the
reference computes the scan outside any Pallas kernel.

One departure from the reference: the within-chunk decay
``exp(cum[t] - cum[s])`` is taken only where ``s <= t``.  The reference
exponentiates every pair and masks the product afterwards; for ``s > t``
the exponent is a positive sum of ``dt`` that overflows float32 once a
chunk is a few dozen tokens long, and ``inf * 0`` turns the whole output
into NaN (at ``ssm_chunk = 256`` it always does).  Where the reference's
product is finite the two agree: the masked entries are zero in both.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import params as pr

D_CONV = 4


def init_mamba2(generator, cfg) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dt = cfg.param_dtype
    dev = generator.device
    f32 = torch.float32
    conv_ch = di + 2 * n                 # x, B, C go through the causal conv
    return {
        "in_proj": pr.normal(generator, (d, 2 * di + 2 * n + h),
                             ("embed", "mlp"), dt),
        "conv_w": pr.normal(generator, (D_CONV, conv_ch), (None, "mlp"), dt,
                            scale=0.5),
        "conv_b": pr.zeros((conv_ch,), ("mlp",), dt, dev),
        "a_log": pr.const(torch.zeros((h,), dtype=f32, device=dev),
                          ("heads",)),
        "d_skip": pr.ones((h,), ("heads",), f32, dev),
        "dt_bias": pr.zeros((h,), ("heads",), f32, dev),
        "norm": {"scale": pr.ones((di,), ("norm",), dt, dev)},
        "out_proj": pr.normal(generator, (di, d), ("mlp", "embed"), dt),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv, window D_CONV. x (B, S, C), w (D_CONV, C).
    state (B, D_CONV-1, C) holds the trailing context for decode."""
    if state is not None:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    else:
        xp = F.pad(x, (0, 0, D_CONV - 1, 0))
    s_out = x.shape[1]
    # windowed sum via stacked slices (small static window)
    out = torch.zeros_like(x)
    for i in range(D_CONV):
        out = out + xp[:, i:i + s_out, :] * w[i][None, None, :]
    new_state = xp[:, -(D_CONV - 1):, :]
    return F.silu(out + b[None, None, :]), new_state


def _split_proj(cfg, z_xbc_dt):
    di, n = cfg.d_inner, cfg.ssm_state
    z = z_xbc_dt[..., :di]
    xbc = z_xbc_dt[..., di:di + di + 2 * n]
    dt_raw = z_xbc_dt[..., di + di + 2 * n:]
    return z, xbc, dt_raw


def _gated_norm(p, y, z, eps):
    return L.rmsnorm(p, y * F.silu(z), eps)


def _chunk_step(s_run, xq, bq, cq, dtq, a, tri):
    """One chunk: (B,Q,H,P) (B,Q,N) (B,Q,N) (B,Q,H), the running state
    (B,H,P,N) in the scan's dtype -> (new state, y (B,Q,H,P))."""
    acc = s_run.dtype
    da = dtq * a[None, None, :]                              # (B,Q,H)
    cum = torch.cumsum(da, dim=1)                            # (B,Q,H)
    xbar = xq.to(acc) * dtq[..., None].to(acc)               # (B,Q,H,P)
    # within-chunk quadratic term; exp only where s <= t (module docstring)
    expo = cum[:, :, None, :] - cum[:, None, :, :]           # (B,Q,Q,H)
    decay = torch.exp(torch.where(tri[None, :, :, None] > 0, expo,
                                  -torch.inf))
    g_ts = torch.einsum("btn,bsn->bts", cq.to(acc), bq.to(acc))  # (B,Q,Q)
    m = g_ts[:, :, :, None] * decay * tri[None, :, :, None]
    y_diag = torch.einsum("btsh,bshp->bthp", m, xbar)
    # inter-chunk contribution from the running state
    y_off = torch.einsum("btn,bhpn->bthp", cq.to(acc), s_run) \
        * torch.exp(cum)[..., None]
    # state update for next chunk
    last = cum[:, -1:, :]                                    # (B,1,H)
    w_in = torch.exp(last - cum)                             # (B,Q,H)
    s_new = s_run * torch.exp(last[:, 0, :])[:, :, None, None] + \
        torch.einsum("bsh,bshp,bsn->bhpn", w_in, xbar, bq.to(acc))
    return s_new, y_diag + y_off


def mamba2_block(p, x, cfg, state=None, conv_state=None):
    """x (B, S, D).  state None => training/prefill (returns the final
    state); state (B, H, P, N) + conv_state => single-token decode
    (S == 1).  Returns (out, new_state, new_conv_state)."""
    b, s, d = x.shape
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hp = cfg.ssm_head_dim
    zxd = torch.einsum("bsd,de->bse", x, p["in_proj"].to(x.dtype))
    z, xbc, dt_raw = _split_proj(cfg, zxd)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"].to(x.dtype),
                                 p["conv_b"].to(x.dtype), conv_state)
    xs = xbc[..., :di]
    b_in = xbc[..., di:di + n]
    c_in = xbc[..., di + n:]
    acc = torch.promote_types(x.dtype, torch.float32)   # the scan's dtype
    a = -torch.exp(p["a_log"])                                  # (H,)
    dt = F.softplus(dt_raw.to(acc) + p["dt_bias"][None, None, :])  # (B,S,H)
    xh = xs.reshape(b, s, h, hp)

    if state is not None:   # ---- decode: single-step recurrence
        da = torch.exp(dt[:, 0, :] * a[None, :])                 # (B,H)
        xbar = xh[:, 0] * dt[:, 0, :, None].to(x.dtype)          # (B,H,P)
        upd = torch.einsum("bhp,bn->bhpn", xbar.to(acc),
                           b_in[:, 0].to(acc))
        new_state = state * da[:, :, None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", new_state, c_in[:, 0].to(acc))
        y = y + p["d_skip"][None, :, None] * xh[:, 0].to(acc)
        y = y.reshape(b, 1, di).to(x.dtype)
        y = _gated_norm(p["norm"], y, z, cfg.norm_eps)
        out = torch.einsum("bsd,de->bse", y, p["out_proj"].to(x.dtype))
        return out, new_state, new_conv

    # ---- training/prefill: chunked SSD, the chunks in order
    q = min(cfg.ssm_chunk, s)
    while s % q:
        q -= 1
    tri = torch.tril(torch.ones((q, q), dtype=torch.float32,
                                device=x.device))
    s_run = torch.zeros((b, h, hp, n), dtype=acc, device=x.device)
    ys = []
    for c0 in range(0, s, q):
        c = slice(c0, c0 + q)
        s_run, y = _chunk_step(s_run, xh[:, c], b_in[:, c], c_in[:, c],
                               dt[:, c], a, tri)
        ys.append(y)
    y = torch.cat(ys, dim=1)                                 # (B,S,H,P)
    y = y + p["d_skip"][None, None, :, None] * xh.to(acc)
    y = y.reshape(b, s, di).to(x.dtype)
    y = _gated_norm(p["norm"], y, z, cfg.norm_eps)
    out = torch.einsum("bsd,de->bse", y, p["out_proj"].to(x.dtype))
    return out, s_run, new_conv
