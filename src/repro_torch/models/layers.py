"""Shared layers: norms, projections, embeddings, RoPE (the JAX package's
``models/layers.py``).

The port places tensors explicitly (``repro_torch.launch.sharding``), so
the reference's ``shard`` activation constraints, layout hints to GSPMD
and identities on values, are left out.  :func:`embed_lookup_psum` is the
reference's decode lookup over a vocab-sharded table, its pieces gathered
by the hand-written row gather.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_dispatch.kernel import row_gather
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
        rel = ids.to(tab.device).long() - lo
        ok = (rel >= 0) & (rel < v_loc)
        part = row_gather(tab, rel.clamp(0, v_loc - 1).to(
            torch.int32).reshape(-1)).view(*ids.shape, tab.shape[1])
        part = torch.where(ok[..., None], part, 0).to(compute_dtype)
        blocks[(cols.start, lo)] = part.to(ids.device)
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
