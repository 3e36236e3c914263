"""Top-level language model: init / forward / loss / decode for the
``dense`` and ``moe`` families (the JAX package's ``models/lm.py``).

The reference scans its layers over parameters stacked on a leading
"layers" axis; the port keeps one :class:`~repro_torch.models.blocks.
DenseLayer` per layer in an ``nn.ModuleList`` and loops over them in
Python, reading each layer's kind (gemma3's 5:1 local:global) on the host.
Under autograd each layer runs under ``cfg.remat``, as the reference's
``_remat`` wraps its scan body: ``"full"`` recomputes the whole layer in
the backward, ``"dots"`` keeps the matrix products' outputs and
recomputes the rest, ``"none"`` keeps everything.  The ``ssm``,
``hybrid``, ``encdec`` and ``vlm`` families raise, citing their ROADMAP
item.
"""
from __future__ import annotations

import functools
from typing import Mapping

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.core.engine import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import not_ported
from repro_torch.models import params as pr


# ------------------------------------------------------------------ helpers
def layer_kinds(cfg) -> np.ndarray:
    """Per-layer kind flags. dense/moe/vlm: 1 = local(swa) layer."""
    if cfg.attn_kind == "local_global":
        r = cfg.local_global_ratio
        return np.array([1 if (i % (r + 1)) < r else 0
                         for i in range(cfg.num_layers)], np.int32)
    if cfg.attn_kind == "swa":
        return np.ones(cfg.num_layers, np.int32)
    return np.zeros(cfg.num_layers, np.int32)


def layer_runs(kinds: np.ndarray) -> list[tuple[int, int, int, int]]:
    """Contiguous same-kind runs: (kind, layer_start, layer_stop,
    position_of_start_within_its_kind_stack)."""
    runs = []
    counts = {0: 0, 1: 0}
    i = 0
    while i < len(kinds):
        j = i
        while j < len(kinds) and kinds[j] == kinds[i]:
            j += 1
        k = int(kinds[i])
        runs.append((k, i, j, counts[k]))
        counts[k] += j - i
        i = j
    return runs


def check_family(cfg) -> None:
    if cfg.family not in ("dense", "moe"):
        raise not_ported(cfg.family)


# the matrix products whose outputs "dots" keeps (jax's checkpoint_dots)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS else \
        ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg):
    """``fn`` under the config's activation checkpointing, where autograd
    records (a forward without gradients runs ``fn`` as it is)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    if cfg.remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    raise ValueError(f"remat {cfg.remat!r} is not full, dots or none")


# --------------------------------------------------------------------- model
class LM(nn.Module):
    """The model's parameters: ``embed`` (V, D), ``final_norm``, ``layers``
    (one :class:`~repro_torch.models.blocks.DenseLayer` each) and, untied,
    ``lm_head`` (D, V)."""

    def __init__(self, cfg, values: Mapping, axes: Mapping | None = None):
        super().__init__()
        check_family(cfg)
        if len(values["layers"]) != cfg.num_layers:
            raise ValueError(f"{len(values['layers'])} layers given, "
                             f"{cfg.name} has {cfg.num_layers}")
        self.cfg = cfg
        self.axes = axes     # logical axes, stacked layout (None if unknown)
        self.embed = nn.Parameter(values["embed"], requires_grad=False)
        self.final_norm = pr.Tree(values["final_norm"])
        self.layers = nn.ModuleList(B.DenseLayer(v)
                                    for v in values["layers"])
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(values["lm_head"],
                                        requires_grad=False)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def forward(self, batch):
        return forward(self, self.cfg, batch)

    def tree(self) -> dict:
        """The parameters as the values tree the model was built from
        (``"layers"`` a list of per-layer trees; no copy)."""
        out = {"embed": self.embed, "final_norm": self.final_norm.tree(),
               "layers": [layer.tree() for layer in self.layers]}
        if not self.cfg.tie_embeddings:
            out["lm_head"] = self.lm_head
        return out


def init_model(cfg, *, generator: torch.Generator | None = None,
               device="cuda") -> LM:
    """A model with random weights drawn from ``generator`` (by default
    one on ``device`` seeded with 0), at the fan-in scale of the JAX
    package's ``params.normal``.  ``device`` defaults to ``"cuda"``, which
    raises when no CUDA device exists."""
    check_family(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    elif generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    g, pdt = generator, cfg.param_dtype
    ptree = {
        "embed": L.init_embedding(g, cfg.vocab_size, cfg.d_model, pdt),
        "final_norm": L.init_rmsnorm(g, cfg.d_model, pdt),
        "layers": [B.init_dense_layer(g, cfg)
                   for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        ptree["lm_head"] = pr.normal(g, (cfg.d_model, cfg.vocab_size),
                                     ("embed", "vocab"), pdt)
    values, axes = pr.split_ptree(ptree)
    axes["layers"] = pr.tree_map(lambda a: ("layers",) + a,
                                 axes["layers"][0])
    return LM(cfg, values, axes)


# ------------------------------------------------------------------ forward
def _embed_tokens(p, cfg, tokens):
    x = L.embed_lookup(p["embed"], tokens, cfg.compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=cfg.compute_dtype)
    return x


def _logits(p, cfg, x):
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, p["embed"].to(x.dtype))
    return torch.einsum("bsd,dv->bsv", x, p["lm_head"].to(x.dtype))


def positions_for(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)


def forward(p, cfg, batch):
    """Full-sequence forward -> (logits (B,S,V), aux dict).

    batch: tokens (B,S) int32."""
    check_family(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed_tokens(p, cfg, tokens)
    positions = positions_for(b, s, tokens.device)
    aux = {k: torch.zeros((), dtype=torch.float32, device=x.device)
           for k in ("moe_aux_loss", "moe_dropped_frac")}
    for layer, kind in zip(p["layers"], layer_kinds(cfg)):
        x, aux_i = _remat(layer, cfg)(x, cfg=cfg, kind_flag=int(kind),
                                      positions=positions)
        for k, v in aux_i.items():
            aux[k] = aux[k] + v
    x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return _logits(p, cfg, x), aux


# --------------------------------------------------------------------- loss
def loss_fn(p, cfg, batch, z_loss: float = 1e-4,
            moe_loss_weight: float = 1e-2):
    """Next-token cross entropy over ``batch["labels"]`` (masked by
    ``loss_mask`` where given) plus the z-loss and, for MoE, the
    load-balance loss -> (total, metrics).  ``ll`` is read with
    ``torch.gather`` on the labels, equal to the reference's one-hot
    product without a second (B, S, V) float32 tensor.  The metrics are
    detached."""
    logits, aux = forward(p, cfg, batch)
    labels = batch["labels"]
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(nll)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    zl = z_loss * ((lse ** 2) * mask).sum() / denom
    total = loss + zl
    metrics = {"nll": loss, "z_loss": zl}
    if cfg.family == "moe":
        moe_l = moe_loss_weight * aux["moe_aux_loss"] / cfg.num_layers
        total = total + moe_l
        metrics["moe_aux"] = aux["moe_aux_loss"] / cfg.num_layers
        metrics["moe_dropped"] = aux["moe_dropped_frac"] / cfg.num_layers
    metrics["loss"] = total
    return total, {k: v.detach() for k, v in metrics.items()}


# ------------------------------------------------------------------- decode
def init_cache(cfg, batch_size: int, max_len: int, dtype=None, *,
               device="cuda") -> dict:
    """Zeroed decode cache: ``k``/``v`` (global layers, L_g, B, max_len,
    Kh, Dh) and ``k_local``/``v_local`` (sliding-window layers: a RING
    buffer of ``min(window, max_len)`` slots — O(window) state regardless
    of context length)."""
    check_family(cfg)
    dtype = dtype or cfg.compute_dtype
    dev = resolve_device(device)
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    kinds = layer_kinds(cfg)
    n_local = int((kinds == 1).sum())
    n_global = cfg.num_layers - n_local
    cache = {}
    if n_local:
        w = min(cfg.window, max_len)
        for key in ("k_local", "v_local"):
            cache[key] = torch.zeros((n_local, batch_size, w, kh, hd),
                                     dtype=dtype, device=dev)
    if n_global:
        for key in ("k", "v"):
            cache[key] = torch.zeros((n_global, batch_size, max_len, kh, hd),
                                     dtype=dtype, device=dev)
    return cache


def decode_step(p, cfg, cache, tokens, cur_pos: int, prefix_len: int = 0):
    """One token for every sequence. tokens (B, 1) int32; cur_pos the
    current write position.  Writes the cache in place and returns
    (logits (B,1,V), cache)."""
    check_family(cfg)
    cur_pos = int(cur_pos)
    x = _embed_tokens(p, cfg, tokens)
    # interleaved runs: local layers hit the ring stack, global layers the
    # full stack (split caches, see init_cache)
    for kind, l0, l1, k0 in layer_runs(layer_kinds(cfg)):
        keys = ("k_local", "v_local") if kind == 1 else ("k", "v")
        for j in range(l1 - l0):
            layer_cache = {"k": cache[keys[0]][k0 + j],
                           "v": cache[keys[1]][k0 + j]}
            x, _ = p["layers"][l0 + j].decode(
                x, layer_cache, cfg=cfg, kind_flag=kind, cur_pos=cur_pos,
                prefix_len=prefix_len, ring=(kind == 1))
    x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return _logits(p, cfg, x), cache
