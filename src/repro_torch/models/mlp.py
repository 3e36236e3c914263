"""Gated MLPs (SwiGLU / GeGLU), the JAX package's ``models/mlp.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
