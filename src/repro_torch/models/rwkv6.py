"""RWKV-6 ("Finch") block — attention-free, data-dependent per-channel
decay (the JAX package's ``models/rwkv6.py``).

Time-mix: chunked linear-attention form.  Within a chunk all decay factors
are expressed relative to the *later* timestep, so every exponent is <= 0
and the math is overflow-safe in float32 (no 1/decay blowups).  The
cross-chunk state (B, H, K, V) float32 is carried by a Python loop over
the chunks, as the reference's ``lax.scan`` carries it; decode is the
single-token recurrence.  Channel-mix: RWKV's two-layer squared-ReLU FFN.

Plain torch, as the reference computes both scans outside any Pallas
kernel.  Over a mesh's model axis (:func:`time_mix_pieces`,
:func:`channel_mix_pieces`) each piece mixes its own heads and its block
of the FFN; the one-device functions are their one-piece case.  The
reference's simplification is kept: token-shift mixing coefficients are
static per channel (RWKV-5 style) while the decay ``w`` keeps the full
data-dependent LoRA of RWKV-6.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch import tensor_parallel as tp
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


def _wkv(rh, kh, vh, lw, uh, state, chunk: int):
    """The WKV over (B, S, H, K) float32 inputs from ``state`` (B, H, K,
    V) -> (y (B, S, H * V), the state after the last token)."""
    b, s, h, hk = rh.shape
    if s == 1:  # ---- decode recurrence
        kv = torch.einsum("bhk,bhv->bhkv", kh[:, 0], vh[:, 0])
        y = torch.einsum("bhk,bhkv->bhv", rh[:, 0],
                         state + uh[None, :, :, None] * kv)
        new_state = torch.exp(lw[:, 0])[..., None] * state + kv
        return y.reshape(b, 1, h * hk), new_state
    # ---- chunked parallel form, the chunks in order
    q = chunk
    while s % q:
        q -= 1
    tri_lt = torch.tril(torch.ones((q, q), dtype=torch.float32,
                                   device=rh.device), diagonal=-1)
    new_state, ys = state, []
    for c0 in range(0, s, q):
        c = slice(c0, c0 + q)
        new_state, y = _chunk_step(new_state, rh[:, c], kh[:, c], vh[:, c],
                                   lw[:, c], uh, tri_lt)
        ys.append(y)
    return torch.cat(ys, dim=1).reshape(b, s, h * hk), new_state


def rwkv6_time_mix(p, x, cfg, state=None, x_last=None, chunk: int = 32):
    """x (B, S, D).  state: (wkv (B,H,K,V) float32, x_last (B,D)) for
    decode / carried prefill; returns (out, (new_state, x[:, -1])).  The
    one-piece case of :func:`time_mix_pieces`."""
    out, (states, last) = time_mix_pieces(
        tp.Group.one(p, x.device), x, cfg,
        None if state is None else [state], x_last, chunk)
    return out, (states[0], last)


def time_mix_pieces(g, x, cfg, states=None, x_last=None, chunk: int = 32):
    """:func:`rwkv6_time_mix` over a group of model pieces (``x`` and the
    output on the lead): ``wr``, ``wk``, ``wv`` and ``wg`` column-parallel
    over ``heads_flat`` (whole heads a piece), ``w0``, ``u`` and
    ``w_lora_b`` their blocks, ``mu`` and ``w_lora_a`` whole (each piece
    computes the LoRA's hidden state in full); the WKV over the piece's
    own heads, ``ln_x`` over the pieces' blocks (:func:`~repro_torch.
    models.layers.rmsnorm_pieces`), ``wo`` row-parallel, reduced out.
    ``states[j]`` piece ``j``'s wkv state (B, H_j, K, V) and ``x_last``
    the token-shift carry (whole, on the lead), or None (zeros).  A
    ``heads_flat`` the model axis does not cut is computed whole on the
    lead.  -> (out, (the pieces' new states, x[:, -1]))."""
    b, s, d = x.shape
    hk = cfg.rwkv_head_dim
    d_loc = g.lead["wr"].shape[1]
    if d_loc == d:
        g = g.first()
    elif d_loc % hk:
        raise ValueError(f"the model axis cuts heads_flat ({d}) into "
                         f"blocks of {d_loc}, inside heads of {hk}")
    lasts = [None] * len(g) if x_last is None else tp.copy_in(g, x_last)
    ys, gates, new_states = [], [], []
    for j, (t, xj, lj) in enumerate(zip(g.trees, tp.copy_in(g, x), lasts)):
        prev = _token_shift(xj, xj.new_zeros((b, d)) if lj is None else lj)
        mu = t["mu"]
        r = _proj(_mix(xj, prev, mu[0]), t["wr"])
        k = _proj(_mix(xj, prev, mu[1]), t["wk"])
        v = _proj(_mix(xj, prev, mu[2]), t["wv"])
        gates.append(_proj(_mix(xj, prev, mu[3]), t["wg"]))
        # data-dependent decay (RWKV-6 LoRA):  log w = -exp(w0 + lora(x_mix))
        wx = _mix(xj, prev, mu[4]).float()
        lora = torch.tanh(wx @ t["w_lora_a"]) @ t["w_lora_b"]
        logw = -torch.exp(torch.clamp(t["w0"][None, None, :] + lora,
                                      -20.0, 4.0))
        h = d_loc // hk
        state = states[j] if states is not None else torch.zeros(
            (b, h, hk, hk), dtype=torch.float32, device=xj.device)
        y, state = _wkv(r.reshape(b, s, h, hk).float(),
                        k.reshape(b, s, h, hk).float(),
                        v.reshape(b, s, h, hk).float(),
                        logw.reshape(b, s, h, hk), t["u"].reshape(h, hk),
                        state, chunk)
        ys.append(y.to(x.dtype))
        new_states.append(state)
    ys = L.rmsnorm_pieces(g, [t["ln_x"]["scale"] for t in g.trees], ys,
                          cfg.norm_eps, d)
    out = tp.reduce_out(g, [_proj(y * F.silu(gt), t["wo"]) for y, gt, t in
                            zip(ys, gates, g.trees)])
    return out, (new_states, x[:, -1, :])


def rwkv_channel_mix(p, x, cfg, x_last=None):
    """The one-piece case of :func:`channel_mix_pieces`."""
    return channel_mix_pieces(tp.Group.one(p, x.device), x, cfg, x_last)


def channel_mix_pieces(g, x, cfg, x_last=None):
    """:func:`rwkv_channel_mix` over a group of model pieces: ``wk``
    column-parallel over ``mlp``, ``wv`` row-parallel, the token shift and
    squared ReLU on each piece, the partial outputs reduced out (a
    ``d_ff`` the model axis does not cut is computed whole on the
    lead).  -> (out on the lead, x[:, -1])."""
    b, s, d = x.shape
    if g.lead["wk"].shape[1] == cfg.d_ff:
        g = g.first()
    lasts = [None] * len(g) if x_last is None else tp.copy_in(g, x_last)
    outs = []
    for t, xj, lj in zip(g.trees, tp.copy_in(g, x), lasts):
        prev = _token_shift(xj, xj.new_zeros((b, d)) if lj is None else lj)
        xk = _mix(xj, prev, t["mu"][0])
        k = torch.einsum("bsd,df->bsf", xk, t["wk"].to(x.dtype))
        k = torch.square(F.relu(k))
        outs.append(torch.einsum("bsf,fd->bsd", k, t["wv"].to(x.dtype)))
    return tp.reduce_out(g, outs), x[:, -1, :]
