"""Gated MLPs (SwiGLU / GeGLU), the JAX package's ``models/mlp.py``.

Over a mesh's model axis (:func:`mlp_pieces`) ``w_gate`` and ``w_up`` are
column-parallel over ``mlp`` and ``w_down`` row-parallel: each piece's
:func:`mlp` is a partial sum of the output, reduced out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch import tensor_parallel as tp
from repro_torch.models import layers as L
from repro_torch.models import params as pr


def init_mlp(generator, cfg, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    return {
        "w_gate": pr.normal(generator, (d, f), ("embed", "mlp"), dt),
        "w_up": pr.normal(generator, (d, f), ("embed", "mlp"), dt),
        "w_down": pr.normal(generator, (f, d), ("mlp", "embed"), dt),
    }


def mlp(p, x: torch.Tensor, cfg) -> torch.Tensor:
    act = F.silu if cfg.mlp_kind == "swiglu" else L.gelu
    g = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(x.dtype))
    u = torch.einsum("bsd,df->bsf", x, p["w_up"].to(x.dtype))
    return torch.einsum("bsf,fd->bsd", act(g) * u, p["w_down"].to(x.dtype))


def mlp_pieces(g, x: torch.Tensor, cfg) -> torch.Tensor:
    """:func:`mlp` over a group of model pieces (``x`` and the output on
    the lead); a hidden width the model axis does not divide is computed
    whole on the lead."""
    if g.lead["w_gate"].shape[1] == cfg.d_ff:
        return mlp(g.lead, x, cfg)
    return tp.reduce_out(g, [mlp(p, xj, cfg) for p, xj in
                             zip(g.trees, tp.copy_in(g, x))])
