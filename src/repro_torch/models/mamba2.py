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
reference computes the scan outside any Pallas kernel.  Over a mesh's
model axis (:func:`mamba2_pieces`) each piece runs the SSD of its own
heads; the one-device :func:`mamba2_block` is its one-piece case.

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

from repro_torch.launch import tensor_parallel as tp
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


def _ssd(xh, b_in, c_in, dt_raw, t, cfg, state, dtype):
    """The SSD of heads ``xh`` (B, S, H, P) with the shared ``b_in`` /
    ``c_in`` (B, S, N), ``dt_raw`` (B, S, H) and the heads' ``a_log``,
    ``d_skip``, ``dt_bias`` of ``t``: the single-step recurrence from
    ``state`` (B, H, P, N) where it is given (S == 1), else the chunked
    scan from zeros -> (y (B, S, H * P) in ``dtype``, the new state)."""
    b, s, h, hp = xh.shape
    n = b_in.shape[-1]
    acc = torch.promote_types(dtype, torch.float32)     # the scan's dtype
    a = -torch.exp(t["a_log"])                                  # (H,)
    dt = F.softplus(dt_raw.to(acc) + t["dt_bias"][None, None, :])  # (B,S,H)
    if state is not None:   # ---- decode: single-step recurrence
        da = torch.exp(dt[:, 0, :] * a[None, :])                 # (B,H)
        xbar = xh[:, 0] * dt[:, 0, :, None].to(dtype)           # (B,H,P)
        upd = torch.einsum("bhp,bn->bhpn", xbar.to(acc),
                           b_in[:, 0].to(acc))
        new_state = state * da[:, :, None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", new_state, c_in[:, 0].to(acc))
        y = y + t["d_skip"][None, :, None] * xh[:, 0].to(acc)
        return y.reshape(b, 1, h * hp).to(dtype), new_state
    # ---- training/prefill: chunked SSD, the chunks in order
    q = min(cfg.ssm_chunk, s)
    while s % q:
        q -= 1
    tri = torch.tril(torch.ones((q, q), dtype=torch.float32,
                                device=xh.device))
    s_run = torch.zeros((b, h, hp, n), dtype=acc, device=xh.device)
    ys = []
    for c0 in range(0, s, q):
        c = slice(c0, c0 + q)
        s_run, y = _chunk_step(s_run, xh[:, c], b_in[:, c], c_in[:, c],
                               dt[:, c], a, tri)
        ys.append(y)
    y = torch.cat(ys, dim=1)                                 # (B,S,H,P)
    y = y + t["d_skip"][None, None, :, None] * xh.to(acc)
    return y.reshape(b, s, h * hp).to(dtype), s_run


def mamba2_block(p, x, cfg, state=None, conv_state=None):
    """x (B, S, D).  state None => training/prefill (returns the final
    state); state (B, H, P, N) + conv_state => single-token decode
    (S == 1).  Returns (out, new_state, new_conv_state).  The one-piece
    case of :func:`mamba2_pieces`."""
    out, states, convs = mamba2_pieces(
        tp.Group.one(p, x.device), x, cfg,
        None if state is None else [state],
        None if conv_state is None else [conv_state])
    return out, states[0], convs[0]


def mamba2_pieces(g, x, cfg, states=None, conv_states=None):
    """:func:`mamba2_block` over a group of model pieces (``x`` and the
    output on the lead).  A piece holds the rules' blocks: columns of
    ``in_proj``, channels of ``conv_w`` / ``conv_b`` (both over ``mlp``,
    cut without regard to the ``z | x | B | C | dt`` split), its heads of
    ``a_log`` / ``d_skip`` / ``dt_bias`` and rows of ``out_proj``.  So:

    * each piece projects onto its ``in_proj`` columns and the blocks are
      gathered (:func:`~repro_torch.launch.tensor_parallel.all_gather`),
      then every piece reads its channels from its copy;
    * each piece runs the causal conv over its channel block (its own
      tail, ``conv_states[j]``) and the outputs are gathered;
    * each piece runs the SSD of its own heads, reading every head's
      ``B`` and ``C``; the gated norm sums over the pieces
      (:func:`~repro_torch.models.layers.rmsnorm_pieces`); ``out_proj``
      is row-parallel, reduced out.

    A block the model axis does not cut is computed whole on the lead.
    -> (out, the pieces' new SSD states, the pieces' new conv tails)."""
    b, s, d = x.shape
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hp = cfg.ssm_head_dim
    conv_ch = di + 2 * n
    lead = g.lead
    # ---- z | x | B | C | dt on the lead (every piece's copy)
    if lead["in_proj"].shape[1] < 2 * di + 2 * n + h:
        zxd = tp.all_gather(g, [
            torch.einsum("bsd,de->bse", xj, t["in_proj"].to(x.dtype))
            for t, xj in zip(g.trees, tp.copy_in(g, x))], dim=-1)
    else:
        zxd = torch.einsum("bsd,de->bse", x, lead["in_proj"].to(x.dtype))
    c_loc, h_loc = lead["conv_w"].shape[1], lead["a_log"].shape[0]
    if lead["out_proj"].shape[0] != h_loc * hp:
        raise ValueError(f"out_proj's {lead['out_proj'].shape[0]} rows a "
                         f"piece are not its {h_loc} heads' channels")
    zs = tp.copy_in(g, zxd) if c_loc < conv_ch or h_loc < h else [zxd]
    # ---- the causal conv over each piece's channels of x | B | C
    gc = g if c_loc < conv_ch else g.first()
    tails = conv_states if conv_states is not None else [None] * len(gc)
    outs, convs = [], []
    for j, (t, zj, tail) in enumerate(zip(gc.trees, zs, tails)):
        lo, hi = tp.piece_range(j, c_loc, conv_ch)
        out, tail = _causal_conv(zj[..., di + lo:di + hi],
                                 t["conv_w"].to(x.dtype),
                                 t["conv_b"].to(x.dtype), tail)
        outs.append(out)
        convs.append(tail)
    xbc = outs[0] if len(outs) == 1 else tp.all_gather(gc, outs, dim=-1)
    # ---- each piece's heads: the SSD and the gated norm's input
    gh = g if h_loc < h else g.first()
    ys, new_states = [], []
    for j, (t, zj, xj) in enumerate(zip(gh.trees, zs, tp.copy_in(gh, xbc))):
        h0, h1 = tp.piece_range(j, h_loc, h)
        y, state = _ssd(xj[..., h0 * hp:h1 * hp].reshape(b, s, h1 - h0, hp),
                        xj[..., di:di + n], xj[..., di + n:],
                        zj[..., 2 * di + 2 * n + h0:2 * di + 2 * n + h1], t,
                        cfg, None if states is None else states[j], x.dtype)
        ys.append(y * F.silu(zj[..., h0 * hp:h1 * hp]))
        new_states.append(state)
    ys = L.rmsnorm_pieces(gh, [t["norm"]["scale"] for t in gh.trees], ys,
                          cfg.norm_eps, di)
    out = tp.reduce_out(gh, [
        torch.einsum("bsd,de->bse", y, t["out_proj"].to(x.dtype))
        for y, t in zip(ys, gh.trees)])
    return out, new_states, convs
