"""Shared layers: norms, projections, embeddings, RoPE (the JAX package's
``models/layers.py``).

The port places tensors explicitly (``repro_torch.launch.sharding``), so
the reference's ``shard`` activation constraints, layout hints to GSPMD
and identities on values, are left out.  :func:`embed_lookup_psum` is the
reference's decode lookup over a vocab-sharded table, its pieces gathered
by the hand-written row gather; over a mesh's model axis
(:func:`embed_lookup_pieces`) it is the lookup of training and serving
too, with a backward that adds each token's gradient into the rows of
the piece that holds it (a scatter-add: the reference has no kernel
there).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_dispatch.kernel import row_gather
from repro_torch.launch import tensor_parallel as tp
from repro_torch.models import params as pr


# -------------------------------------------------------------------- norms
def init_rmsnorm(generator, d, dtype) -> dict:
    return {"scale": pr.ones((d,), ("norm",), dtype, generator.device)}


def rmsnorm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + p["scale"].float())).to(dt)


def rmsnorm_pieces(g, scales, xs, eps: float, width: int) -> list:
    """:func:`rmsnorm` over an axis of ``width`` cut into the pieces'
    blocks: ``xs[j]`` piece ``j``'s block on its device, ``scales[j]`` the
    whole scale (a ``"norm"`` leaf) on that device.  The mean square is
    each piece's sum of squares summed over the pieces
    (:func:`~repro_torch.launch.tensor_parallel.norm_sum`); one piece is
    :func:`rmsnorm` itself."""
    if len(xs) == 1:
        return [rmsnorm({"scale": scales[0]}, xs[0], eps)]
    xfs = [x.float() for x in xs]
    totals = tp.norm_sum(g, [torch.sum(xf * xf, dim=-1, keepdim=True)
                             for xf in xfs])
    blocks = [s[slice(*tp.piece_range(j, x.shape[-1], width))]
              for j, (x, s) in enumerate(zip(xs, scales))]
    return [(xf * torch.rsqrt(t / width + eps) * (1.0 + s.float())).to(
        x.dtype) for x, xf, t, s in zip(xs, xfs, totals, blocks)]


def layernorm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p["scale"].float() + p["bias"].float()).to(dt)


# -------------------------------------------------------------- projections
def init_embedding(generator, vocab, d, dtype) -> pr.P:
    return pr.normal(generator, (vocab, d), ("vocab", "embed"), dtype,
                     scale=1.0)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    """Token-id gather of whole rows of the table."""
    return table[ids.long()].to(compute_dtype)


class PieceRows(torch.autograd.Function):
    """Rows ``ids - lo`` of a vocab piece ``table`` (rows ``[lo, lo +
    len(table))`` of the whole), gathered by the hand-written row gather
    at ``clip(ids - lo, 0, len(table) - 1)``, zero where ``ids`` lies
    outside the piece; backward, each token's gradient added into the row
    it read (``index_add_``; a token outside the piece adds a zero row,
    so the backward's shapes, and its launches, do not depend on the
    ids)."""

    @staticmethod
    def forward(ctx, table, ids, lo: int):
        rel = ids.long() - lo
        ok = (rel >= 0) & (rel < table.shape[0])
        rows = row_gather(table, rel.clamp(0, table.shape[0] - 1).to(
            torch.int32).reshape(-1)).view(*ids.shape, table.shape[1])
        ctx.save_for_backward(rel, ok)
        ctx.shape = table.shape
        return torch.where(ok[..., None], rows, 0)

    @staticmethod
    def backward(ctx, grad):
        rel, ok = ctx.saved_tensors
        out = torch.zeros(ctx.shape, dtype=grad.dtype, device=grad.device)
        out.index_add_(0, rel.clamp(0, ctx.shape[0] - 1).reshape(-1),
                       torch.where(ok[..., None], grad, 0).reshape(
                           -1, ctx.shape[1]))
        return out, None, None


def embed_lookup_pieces(g, ids: torch.Tensor, compute_dtype,
                        vocab: int) -> torch.Tensor:
    """The token lookup over a group of model pieces of the table
    (``g[j]`` piece ``j``'s rows; ``ids`` and the output on the lead):
    each piece gathers its rows (:class:`PieceRows`) and the pieces are
    reduced out.  A vocabulary the model axis does not divide is whole in
    every piece and is looked up on the lead."""
    v_loc = g.lead.shape[0]
    if v_loc == vocab:
        return embed_lookup(g.lead, ids, compute_dtype)
    return tp.reduce_out(g, [
        PieceRows.apply(t, ids.to(dev), j * v_loc).to(compute_dtype)
        for j, (t, dev) in enumerate(zip(g.trees, g.devices))])


def embed_lookup_psum(table: torch.Tensor, ids: torch.Tensor, compute_dtype,
                      shd) -> torch.Tensor:
    """Decode-path embedding lookup over a vocab-sharded table.

    The reference's Intelligent-Unroll move: rather than all-gather the
    table, every model-shard gathers only its local vocab slice (masked)
    and the shards psum the (B, S, D) result, a few hundred KB at decode.
    The table is split by the rules once (``shd.place``: on a simulated
    mesh the pieces are views).  Piece ``j`` of the model axis gathers its
    rows with the hand-written :func:`~repro_torch.kernels.moe_dispatch.
    kernel.row_gather` at ``clip(ids - lo, 0, v_loc - 1)``, zeroes the rows
    outside ``[lo, lo + v_loc)`` and the pieces are summed onto ``ids``'
    device (the psum); where the data axis cuts the embedding dimension
    its blocks are concatenated there.  A vocabulary the model axis does
    not divide, or ``rules["vocab"] != "model"``, takes
    :func:`embed_lookup`, as in the reference."""
    mesh = shd.mesh
    model_n = mesh.shape["model"]
    v, d = table.shape
    if v % model_n or shd.rules.get("vocab") != "model":
        return embed_lookup(table, ids, compute_dtype)
    v_loc = v // model_n
    placed = shd.place(table, ("vocab", "embed"))
    blocks = {}             # embedding-dim block -> the psum of its pieces
    for n, tab in enumerate(placed.pieces):
        rows, cols = placed.placement.block(n, placed.shape)
        lo = rows.start
        if (cols.start, rows.start) in blocks:
            continue        # a replica of a block already summed
        part = PieceRows.apply(tab, ids.to(tab.device), lo)
        blocks[(cols.start, lo)] = part.to(compute_dtype).to(ids.device)
    out = []
    for c in sorted({c for c, _ in blocks}):
        parts = [blocks[k] for k in sorted(blocks) if k[0] == c]
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        out.append(total)
    return out[0] if len(out) == 1 else torch.cat(out, dim=-1)


# --------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)                       # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, D), positions (B, S) int32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs               # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- misc
def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")
