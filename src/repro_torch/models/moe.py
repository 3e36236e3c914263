"""Mixture-of-Experts layer (qwen3-moe, kimi-k2), the JAX package's
``models/moe.py``.

Implementation: **group-local dropping dispatch**.  Tokens are split into
groups of ~``moe_group_size``; each group sorts its (token, expert-choice)
pairs by expert id (the Intelligent-Unroll Data Transfer step — after the
sort the gather stream is piecewise contiguous, the paper's ``L/S=1``
pattern), builds a capacity-bounded (E, C, D) dispatch buffer, runs the
expert FFNs as dense einsums over the expert dim, and combines the results
weighted by the router gates.

Both row movements run on the hand-written row gather
(:func:`repro_torch.kernels.moe_dispatch.kernel.row_gather`), as the
reference's docstring describes its Pallas ``row_gather`` for the
single-device serving path (its ``moe`` itself uses XLA scatter/gather):

* dispatch: slot ``s`` of the buffer reads token row ``slot_src[s]`` of the
  group's rows with a zero row appended, ``slot_src`` holding that zero
  row's index for every slot no kept entry fills (the reference's
  ``zeros.at[slot].set(xg[tok], mode="drop")``);
* combine: entry ``(t, j)`` (token, choice) reads its slot's expert output
  row, or the appended zero row when it fell past capacity (the
  reference's ``.at[slot].get(mode="fill")`` under ``where(valid)``); the
  ``k`` rows of a token are then weighted by their gates and summed over
  the choice axis.

Both gathers are exact copies, so the buffer and the gathered rows are
bitwise those of any other row copy on the same routing.  For CPU tensors
the row gather runs its plain version; on the card it launches the kernel
or raises.

**Backward: a row gather through the inverse map.**  The kernel writes
into a tensor autograd does not see, so both gathers go through
:class:`RowGather`, whose backward is again a row gather, on the same
kernel, of the incoming gradient (with a zero row appended) through the
inverse index map, then a sum over the ``fan`` rows each source row was
copied to, in a fixed order (choice ``j`` ascending):

* dispatch (``fan = k``): token ``t``'s gradient sums the buffer gradient
  at the slots of its ``k`` entries, read in (token, choice) order through
  the combine's map (the zero row for an entry past capacity);
* combine (``fan = 1``): slot ``s``'s gradient is the gradient of the one
  entry it fills (the zero row where no entry fills it).

No float ``index_add_`` / ``scatter_add_`` runs forward or backward: on
the card those use atomics and would make runs differ bitwise.  The
gradient with respect to the gates flows through ``rows * gates``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_dispatch.kernel import row_gather
from repro_torch.launch.sharding import take_rows
from repro_torch.models import params as pr


def init_moe(generator, cfg) -> dict:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt = cfg.param_dtype
    return {
        "router": pr.normal(generator, (d, e), ("embed", "router_experts"),
                            torch.float32),
        "w_gate": pr.normal(generator, (e, d, f),
                            ("experts", "embed", "expert_mlp"), dt),
        "w_up": pr.normal(generator, (e, d, f),
                          ("experts", "embed", "expert_mlp"), dt),
        "w_down": pr.normal(generator, (e, f, d),
                            ("experts", "expert_mlp", "embed"), dt),
    }


def _group_count(t: int, group_size: int) -> int:
    g = max(1, t // max(group_size, 1))
    while t % g:
        g -= 1
    return g


def _dispatch_indices(eidx: torch.Tensor, k: int, e: int, c: int):
    """Group-local sort-based dispatch indices.

    eidx (Tg, k) int32 -> (slot, token, order, valid), each (Tg*k,), in
    expert-sorted order.  slot == e*c marks dropped (out-of-capacity)
    entries.  The sort is stable, as ``jnp.argsort`` is: which entries of
    an expert fall past capacity depends on that order.
    """
    tg = eidx.shape[0]
    fe = eidx.reshape(-1)
    order = torch.argsort(fe, stable=True)   # Data Transfer: sort by expert
    se = fe[order]
    n = torch.arange(tg * k, dtype=torch.int32, device=eidx.device)
    tok = (n // k)[order]
    run_start = torch.searchsorted(se, se, side="left")
    pos = n - run_start.to(torch.int32)
    valid = pos < c
    slot = torch.where(valid, se * c + pos, e * c).to(torch.int32)
    return slot, tok, order, valid


def _with_zero_row(rows: torch.Tensor) -> torch.Tensor:
    return torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])


class RowGather(torch.autograd.Function):
    """``row_gather(src + zero row, ids)`` (R, D) whose gradient is
    ``row_gather(grad + zero row, back_ids)`` (T * fan, D) summed over
    groups of ``fan`` consecutive rows (``back_ids`` lists, for each row
    of ``src``, the ``fan`` output rows copied from it, or R where
    none)."""

    @staticmethod
    def forward(ctx, src, ids, back_ids, fan: int):
        ctx.save_for_backward(back_ids)
        ctx.fan = fan
        return row_gather(_with_zero_row(src), ids)

    @staticmethod
    def backward(ctx, grad):
        back_ids, = ctx.saved_tensors
        rows = row_gather(_with_zero_row(grad), back_ids)
        rows = rows.view(-1, ctx.fan, rows.shape[1])
        out = rows[:, 0]
        for j in range(1, ctx.fan):
            out = out + rows[:, j]
        return out, None, None, None


def _entry_slots(slot, order):
    """Each entry's slot (``e*c`` past capacity) in (token, choice)
    order."""
    return torch.empty_like(slot).scatter_(0, order, slot)


def _dispatch(xg, slot, tok, order, e: int, c: int):
    """(Tg, D) token rows -> (E*C, D) dispatch buffer via one row gather."""
    tg = xg.shape[0]
    # slot e*c collects every dropped entry and is cut off
    slot_src = torch.full((e * c + 1,), tg, dtype=torch.int32,
                          device=xg.device)
    slot_src.scatter_(0, slot.long(), tok)
    return RowGather.apply(xg, slot_src[:e * c], _entry_slots(slot, order),
                           slot.numel() // tg)


def _combine(flat, slot, order, gates):
    """(E*C, D) expert outputs -> (Tg, D): each token's k rows, gathered in
    (token, choice) order by one row gather, weighted and summed."""
    tg, k = gates.shape
    ec = flat.shape[0]
    # the entry filling each slot (the dropped entries' slot ec is cut off)
    slot_entry = torch.full((ec + 1,), tg * k, dtype=torch.int32,
                            device=flat.device)
    slot_entry.scatter_(0, slot.long(), order.to(torch.int32))
    rows = RowGather.apply(flat, _entry_slots(slot, order), slot_entry[:ec],
                           1).view(tg, k, -1)
    return (rows * gates.to(flat.dtype)[..., None]).sum(dim=1)


def moe(p, x: torch.Tensor, cfg, group_size: int | None = None):
    """x (B, S, D) -> (out (B, S, D), aux_metrics dict)."""
    ys, aux = moe_replicas([p], [x], cfg, group_size)
    return ys[0], aux


def moe_replicas(ps, xs, cfg, group_size: int | None = None):
    """The MoE layer over the rows of one global batch split over data
    replicas: ``xs[r]`` (B_r, S, D) replica ``r``'s rows, in order, on its
    device, ``ps[r]`` its copy of the layer's parameters.  -> (outputs,
    one per replica on its device, aux_metrics on the first replica's
    device).

    As in the reference, where GSPMD keeps the global semantics, the
    groups, their capacity and the load-balance statistics are those of
    the global batch: the router runs on each replica's own tokens
    (row-local); group ``g`` (global token rows ``[g Tg, (g + 1) Tg)``) is
    dispatched, run through the experts and combined on the replica that
    holds its first row, with that replica's weights, its rows from other
    replicas copied there and its outputs copied back; the expert choices
    and router probabilities of every replica come to the first replica's
    device for the aux loss.  Autograd carries the gradients back across
    the copies.  With one replica this is the single-device layer."""
    s, d = xs[0].shape[1:]
    sizes = [x.shape[0] * s for x in xs]
    offsets = [sum(sizes[:r]) for r in range(len(xs))]
    t = sum(sizes)
    e, k = cfg.num_experts, cfg.top_k
    g = _group_count(t, group_size or cfg.moe_group_size)
    tg = t // g
    c = max(1, int(np.ceil(tg * k / e * cfg.capacity_factor)))

    flat, probs, gates, eidx = [], [], [], []
    for p, x in zip(ps, xs):
        xf = x.reshape(-1, d)
        logits = torch.einsum("td,de->te", xf.float(), p["router"].float())
        pr_r = torch.softmax(logits, dim=-1)
        gt, ei = torch.topk(pr_r, k, dim=-1)      # (T_r, k)
        flat.append(xf)
        probs.append(pr_r)
        eidx.append(ei.to(torch.int32))
        gates.append(gt / torch.clamp(gt.sum(-1, keepdim=True), min=1e-9))

    weights = {}          # replica -> its expert weights in x's dtype
    ys, kept = [], []
    for gi in range(g):
        lo, hi = gi * tg, (gi + 1) * tg
        r = max(i for i, off in enumerate(offsets) if off <= lo)
        dev = xs[r].device
        if r not in weights:
            weights[r] = tuple(ps[r][w].to(xs[r].dtype)
                               for w in ("w_gate", "w_up", "w_down"))
        wg, wu, wd = weights[r]
        slot, tok, order, valid = _dispatch_indices(
            take_rows(eidx, offsets, lo, hi, dev), k, e, c)
        disp = _dispatch(take_rows(flat, offsets, lo, hi, dev), slot, tok,
                         order, e, c).view(e, c, d)
        # expert FFN (dense over the expert dim)
        h = F.silu(torch.einsum("ecd,edf->ecf", disp, wg)) * \
            torch.einsum("ecd,edf->ecf", disp, wu)
        out_e = torch.einsum("ecf,efd->ecd", h, wd)
        ys.append(_combine(out_e.reshape(e * c, d), slot, order,
                           take_rows(gates, offsets, lo, hi, dev)))
        kept.append(valid)
    group_offsets = [gi * tg for gi in range(g)]
    outs = [take_rows(ys, group_offsets, off, off + n, x.device).view(x.shape)
            for x, off, n in zip(xs, offsets, sizes)]

    # load-balance aux loss (Switch-style) + router stats, global
    dev0 = xs[0].device
    all_eidx = take_rows(eidx, offsets, 0, t, dev0)
    all_probs = take_rows(probs, offsets, 0, t, dev0).view(g, tg, e)
    choices = all_eidx.reshape(-1).long()     # counted exactly in int64,
    counts = torch.zeros(e, dtype=torch.int64,  # and on the meta device
                         device=dev0).scatter_add_(0, choices,
                                                   torch.ones_like(choices))
    frac_tokens = counts.float() / (t * k)
    mean_prob = all_probs.mean(dim=(0, 1))
    aux = {
        "moe_aux_loss": e * torch.sum(frac_tokens * mean_prob),
        "moe_dropped_frac": 1.0 - torch.stack(
            [v.to(dev0) for v in kept]).float().mean(),
    }
    return outs, aux


def dispatch_pattern_stats(eidx: np.ndarray, lane_width: int = 128) -> dict:
    """Paper-style L/S opportunity analysis of a routing trace: classify the
    *sorted* dispatch row-index stream with the feature table (Table 6 for
    MoE dispatch)."""
    from repro_torch.core import feature_table as ft
    fe = eidx.reshape(-1)
    order = np.argsort(fe, kind="stable")
    tok = (np.arange(fe.size) // eidx.shape[-1])[order]
    blocks = ft.pad_to_blocks(tok.astype(np.int64), lane_width,
                              fill=int(tok[-1]) if tok.size else 0)
    gf = ft.gather_features(blocks, lane_width)
    hist = {}
    for v in gf.num_windows:
        hist[int(v)] = hist.get(int(v), 0) + 1 / max(len(gf.num_windows), 1)
    return {"ls_hist": hist,
            "mean_windows": float(gf.num_windows.mean())}
