"""Shared layers: norms, projections, embeddings, RoPE (the JAX package's
``models/layers.py``).

The port runs on one device, so the reference's ``shard`` constraints
(identities there without a sharding spec) are left out, and so is
``embed_lookup_psum``, which only a vocab-sharded table reaches (ROADMAP
item 19).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
