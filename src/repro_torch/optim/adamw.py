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

Data-parallel training (``repro_torch.train.loop`` over a mesh) hands in
trees whose leaves are :class:`~repro_torch.launch.sharding.Sharded`
pieces: parameters and float32 gradients cut by the rules.  A float32
moment is then a ``Sharded`` of the stacked leaf, cut as its layers are,
and every piece is updated on its own device with the step's scalars
copied there; the gradient norm counts every logical element once (a
replicated leaf's first copy).  On a ``(data, model)`` mesh a leaf's
pieces may be cut in two dimensions (``data`` on ``embed``, ``model`` on
heads, mlp, experts or vocab); each moment piece is cut as its
parameter's.

8-bit moments under a mesh keep the reference's layout: ``q`` and ``s``
of the flat stacked leaf, their blocks' dim 0 cut over the ``"embed"``
rule (:func:`~repro_torch.launch.sharding.blocks_placement`: FSDP over
``data``, replicated where the devices do not divide the blocks).  A
device's run of blocks covers a contiguous range of the flattened stacked
leaf, across layers and every ``embed`` column, so its elements are not
those of its parameter piece.  For such a leaf ``update`` takes the
gradient in the same block placement (``DataParallel``'s reduce-scatter
in flat order) and, as the parameter, a ``Sharded`` over that placement
whose piece ``n`` is device ``n``'s whole copy of the stacked leaf (its
per-layer tensors: the data-parallel replica): each device updates its
blocks' elements there in place, and ``DataParallel.exchange`` copies
them into the parameter pieces.  On a model axis above 1 piece ``n`` is
an object that reads and writes device ``n``'s blocks' elements in flat
ranges (``read(a, b)``, ``write(a, b, values)``; ``DataParallel``'s reads
them from its data replica's model pieces and writes them into the
parameter pieces, the exchange).  The blocks are replicated over
``model``, so every model replica of a data index runs the same update
on the same elements.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.launch.sharding import Placement, Sharded, blocks_placement
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


def _sharded_zeros(leaf) -> Sharded:
    """Float32 zero moments of a stacked leaf of ``Sharded`` pieces: the
    layers' pieces stacked on each device."""
    first = _parts(leaf)[0]
    lead = (len(leaf),) if isinstance(leaf, list) else ()
    pieces = [torch.zeros(lead + tuple(p.shape), dtype=torch.float32,
                          device=p.device) for p in first.pieces]
    spec = (None,) * len(lead) + first.placement.spec
    return Sharded(Placement(first.placement.mesh, spec), pieces,
                   lead + first.shape)


def _q8_zeros(nb: int, block: int, dev) -> dict:
    """``_q8`` of ``nb`` blocks of zeros, without the float copy."""
    return {"q": torch.zeros((nb, block), dtype=torch.int8, device=dev),
            "s": torch.full((nb, 1), 1e-12, dtype=torch.float32, device=dev)}


def _sharded_q8_zeros(leaf, shd, block: int) -> dict:
    """8-bit zero moments of a stacked leaf of ``Sharded`` pieces: ``q``
    and ``s`` in :func:`blocks_placement`, each device's run of blocks on
    it."""
    if shd is None:
        raise ValueError("8-bit moments of Sharded parameters need shd= "
                         "(the rules that place their blocks)")
    nb = -(-math.prod(pr.stacked_shape(leaf)) // block)
    pl = blocks_placement(shd, nb, block)
    pieces = []
    for n, dev in enumerate(pl.mesh.devices):
        blocks = pl.block(n, (nb, block))[0]
        pieces.append(_q8_zeros(blocks.stop - blocks.start, block, dev))
    return {key: Sharded(pl, [p[key] for p in pieces], (nb, width))
            for key, width in (("q", block), ("s", 1))}


def init(params, cfg: AdamWConfig, shd=None) -> dict:
    """Zero moments, in the stacked structure, on the parameters'
    devices; ``step`` a 0-d int32 tensor.  8-bit moments of ``Sharded``
    parameters need ``shd`` (the mesh's rules), which places their
    blocks."""
    def zeros(leaf):
        if isinstance(_parts(leaf)[0], Sharded):
            if cfg.quantize_moments:
                return _sharded_q8_zeros(leaf, shd, cfg.q_block)
            return _sharded_zeros(leaf)
        shape, dev = pr.stacked_shape(leaf), _parts(leaf)[0].device
        if cfg.quantize_moments:
            return _q8_zeros(-(-math.prod(shape) // cfg.q_block),
                             cfg.q_block, dev)
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    stacked = pr.stack_tree(params)
    first = _parts(pr.leaves_like(stacked, stacked)[0])[0]
    if isinstance(first, Sharded):
        first = first.pieces[0]
    return {"step": torch.zeros((), dtype=torch.int32, device=first.device),
            "m": pr.stacked_map(zeros, stacked),
            "v": pr.stacked_map(zeros, stacked)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in float32.  A
    ``Sharded`` gradient counts the pieces of one copy of its blocks, each
    summed on its device; the sum is on the first piece's device."""
    stacked = pr.stack_tree(tree)
    total, dev = 0, None
    for leaf in pr.leaves_like(stacked, stacked):
        for g in _parts(leaf):
            if isinstance(g, Sharded):
                dev = dev or g.pieces[0].device
                for n in g.placement.owners():
                    total = total + torch.sum(torch.square(
                        g.pieces[n].float())).to(dev)
            else:
                total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


# ------------------------------------------------------------- the update
def _pieces(parts, a: int, b: int):
    """Elements ``[a, b)`` of the flat concatenation of ``parts`` (each of
    one size) as flat views of the parts."""
    n = parts[0].numel()
    return [parts[i].view(-1)[max(a - i * n, 0):min(b - i * n, n)]
            for i in range(a // n, -(-b // n))]


def read_range(parts, a: int, b: int) -> torch.Tensor:
    """Elements ``[a, b)`` of the flat concatenation of ``parts``: a view
    where one part holds them, else a copy."""
    pieces = _pieces(parts, a, b)
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def _write(parts, a: int, b: int, values: torch.Tensor) -> None:
    off = 0
    for piece in _pieces(parts, a, b):
        piece.copy_(values[off:off + piece.numel()])
        off += piece.numel()


class FlatParts:
    """A flat stacked leaf held by ``parts`` (the flat concatenation of
    tensors of one size), read and written in flat ranges of its
    elements (views where one part holds a range)."""

    def __init__(self, parts):
        self.parts = parts

    def numel(self) -> int:
        return sum(x.numel() for x in self.parts)

    def read(self, a: int, b: int) -> torch.Tensor:
        return read_range(self.parts, a, b)

    def write(self, a: int, b: int, values: torch.Tensor) -> None:
        _write(self.parts, a, b, values)


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


def _update_leaf(ps, gs, m, v, scale, lr, c1, c2, cfg, lo: int = 0,
                 hi: int | None = None) -> None:
    """Elements ``[lo, hi)`` (by default all) of the flat stacked leaf
    ``ps`` (a :class:`FlatParts`, or anything with its ``read`` and
    ``write``); the gradient parts ``gs`` and the moments hold them from
    their own element 0 (``lo`` is a multiple of ``q_block``)."""
    hi = ps.numel() if hi is None else hi
    chunk = max(CHUNK // cfg.q_block, 1) * cfg.q_block
    for a in range(lo, hi, chunk):
        b = min(a + chunk, hi)
        g = read_range(gs, a - lo, b - lo).float() * scale
        p = ps.read(a, b).float()
        m_f = cfg.b1 * _moment(m, a - lo, b - lo, cfg.q_block) + \
            (1 - cfg.b1) * g
        v_f = cfg.b2 * _moment(v, a - lo, b - lo, cfg.q_block) + \
            (1 - cfg.b2) * g * g
        mh = m_f / c1
        vh = v_f / c2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p
        ps.write(a, b, p - lr * delta)
        _store(m, a - lo, b - lo, m_f, cfg.q_block)
        _store(v, a - lo, b - lo, v_f, cfg.q_block)


def _update_blocks(p, g, m, v, scalars, cfg) -> None:
    """An 8-bit ``Sharded`` leaf (see the module docstring): device ``n``
    updates the elements of its run of blocks in ``p.pieces[n]`` (its copy
    of the stacked leaf, or what reads and writes them), from its
    gradient piece."""
    pl, shape = m["q"].placement, m["q"].shape
    if not (isinstance(p, Sharded) and isinstance(g, Sharded)
            and p.placement == pl == g.placement):
        raise ValueError("an 8-bit Sharded moment needs the parameter and "
                         "gradient in its block placement (DataParallel's "
                         "flat_params and reduce_scatter(q_block=))")
    n_el = math.prod(p.shape)
    for n, dev in enumerate(pl.mesh.devices):
        blocks = pl.block(n, shape)[0]
        src = p.pieces[n]
        _update_leaf(src if hasattr(src, "read") else
                     FlatParts(_parts(src)), [g.pieces[n]],
                     {k: m[k].pieces[n] for k in m},
                     {k: v[k].pieces[n] for k in v},
                     *(x.to(dev) for x in scalars), cfg,
                     lo=blocks.start * cfg.q_block,
                     hi=min(blocks.stop * cfg.q_block, n_el))


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
        if isinstance(m, dict) and isinstance(m["q"], Sharded):
            _update_blocks(p, g, m, v, (scale, lr, c1, c2), cfg)
            continue
        if not isinstance(m, Sharded):
            _update_leaf(p if hasattr(p, "read") else FlatParts(_parts(p)),
                         _parts(g), m, v, scale, lr, c1, c2, cfg)
            continue
        for n, (mn, vn) in enumerate(zip(m.pieces, v.pieces)):
            dev = mn.device
            _update_leaf(FlatParts([x.pieces[n] for x in _parts(p)]),
                         [x.pieces[n] for x in _parts(g)], mn, vn,
                         scale.to(dev), lr.to(dev), c1.to(dev), c2.to(dev),
                         cfg)
    return ({"step": step, "m": state["m"], "v": state["v"]},
            {"grad_norm": gnorm, "lr": lr})
