"""AdamW, the JAX package's ``optim/adamw.py``, on the port's parameter
tree.

* moments stored float32 in the reference's stacked structure
  (:func:`repro_torch.models.params.stack_tree`): a layer leaf's moment
  is one ``(L, ...)`` tensor, so the state's paths and shapes, and a
  checkpoint of it, are the reference's;
* global-norm gradient clipping;
* decoupled weight decay, bias correction, warmup then cosine schedule;
* optional 8-bit moment quantization (block-wise absmax over the flat
  stacked leaf, as the reference's).

``update`` does the reference's arithmetic in float32 and casts each new
parameter back to its dtype, but in place, under ``torch.no_grad()``: at
full width a functional copy of the parameters would not fit beside the
moments.  The moments are updated in place too.  Each stacked leaf is
walked in chunks of at most :data:`CHUNK` elements cut at multiples of
``q_block`` (a chunk may span layers), so the float32 temporaries stay
small; every step is elementwise or block-wise, so the chunks do not
change the result.  ``torch.optim.AdamW`` is not used: it keeps the
moments in the parameters' dtype and has neither the clip nor the
schedule.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models import params as pr

CHUNK = 1 << 24      # elements of one chunk of a stacked leaf's update


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    quantize_moments: bool = False   # 8-bit block-wise moments
    q_block: int = 256


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (float32): linear warmup, then a
    cosine decay to ``min_lr_frac``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


# ---------------------------------------------------------- 8-bit moments
def _q8(x: torch.Tensor, block: int):
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.view(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dq8(q, scale, shape, block: int):
    n = math.prod(shape)
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def _parts(leaf) -> list:
    """The per-layer tensors of a stacked-structure leaf."""
    return leaf if isinstance(leaf, list) else [leaf]


def init(params, cfg: AdamWConfig) -> dict:
    """Zero moments, in the stacked structure, on the parameters'
    devices; ``step`` a 0-d int32 tensor."""
    def zeros(leaf):
        shape, dev = pr.stacked_shape(leaf), _parts(leaf)[0].device
        if cfg.quantize_moments:   # _q8 of zeros, without the float copy
            nb = -(-math.prod(shape) // cfg.q_block)
            return {"q": torch.zeros((nb, cfg.q_block), dtype=torch.int8,
                                     device=dev),
                    "s": torch.full((nb, 1), 1e-12, dtype=torch.float32,
                                    device=dev)}
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    stacked = pr.stack_tree(params)
    first = pr.leaves_like(stacked, stacked)[0]
    return {"step": torch.zeros((), dtype=torch.int32,
                                device=_parts(first)[0].device),
            "m": pr.stacked_map(zeros, stacked),
            "v": pr.stacked_map(zeros, stacked)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in float32."""
    stacked = pr.stack_tree(tree)
    total = 0
    for leaf in pr.leaves_like(stacked, stacked):
        for g in _parts(leaf):
            total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


# ------------------------------------------------------------- the update
def _pieces(parts, a: int, b: int):
    """Elements ``[a, b)`` of the flat concatenation of ``parts`` (each of
    one size) as flat views of the parts."""
    n = parts[0].numel()
    return [parts[i].view(-1)[max(a - i * n, 0):min(b - i * n, n)]
            for i in range(a // n, -(-b // n))]


def _read(parts, a: int, b: int) -> torch.Tensor:
    pieces = _pieces(parts, a, b)
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def _write(parts, a: int, b: int, values: torch.Tensor) -> None:
    off = 0
    for piece in _pieces(parts, a, b):
        piece.copy_(values[off:off + piece.numel()])
        off += piece.numel()


def _moment(mom, a: int, b: int, block: int) -> torch.Tensor:
    if isinstance(mom, dict):
        blocks = slice(a // block, -(-b // block))
        return _dq8(mom["q"][blocks], mom["s"][blocks], (b - a,), block)
    return mom.view(-1)[a:b]


def _store(mom, a: int, b: int, values: torch.Tensor, block: int) -> None:
    if isinstance(mom, dict):
        blocks = slice(a // block, -(-b // block))
        q, s = _q8(values, block)
        mom["q"][blocks] = q
        mom["s"][blocks] = s
    else:
        mom.view(-1)[a:b] = values


def _update_leaf(ps, gs, m, v, scale, lr, c1, c2, cfg) -> None:
    n = ps[0].numel() * len(ps)
    chunk = max(CHUNK // cfg.q_block, 1) * cfg.q_block
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        g = _read(gs, a, b).float() * scale
        p = _read(ps, a, b).float()
        m_f = cfg.b1 * _moment(m, a, b, cfg.q_block) + (1 - cfg.b1) * g
        v_f = cfg.b2 * _moment(v, a, b, cfg.q_block) + \
            (1 - cfg.b2) * g * g
        mh = m_f / c1
        vh = v_f / c2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p
        _write(ps, a, b, p - lr * delta)
        _store(m, a, b, m_f, cfg.q_block)
        _store(v, a, b, v_f, cfg.q_block)


@torch.no_grad()
def update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step on the parameter tree ``params`` (written in place)
    from the gradient tree ``grads`` (same structure) -> (new state,
    metrics ``{"grad_norm", "lr"}``).  ``state``'s moments are updated in
    place and returned in the new state with ``step + 1``."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    stepf = step.to(torch.float32)
    c1 = 1.0 - cfg.b1 ** stepf
    c2 = 1.0 - cfg.b2 ** stepf
    ps, gs = pr.stack_tree(params), pr.stack_tree(grads)
    for p, g, m, v in zip(pr.leaves_like(ps, ps), pr.leaves_like(ps, gs),
                          pr.leaves_like(ps, state["m"]),
                          pr.leaves_like(ps, state["v"])):
        _update_leaf(_parts(p), _parts(g), m, v, scale, lr, c1, c2, cfg)
    return ({"step": step, "m": state["m"], "v": state["v"]},
            {"grad_norm": gnorm, "lr": lr})
