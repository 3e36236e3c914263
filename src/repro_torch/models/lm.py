"""Top-level language model: init / forward / loss / decode for every
family: ``dense``, ``moe``, ``ssm`` (rwkv6), ``hybrid`` (zamba2),
``encdec`` (whisper) and ``vlm`` (paligemma) (the JAX package's
``models/lm.py``).

The reference scans its layers over parameters stacked on a leading
"layers" axis; the port keeps one layer module per layer
(:class:`~repro_torch.models.blocks.DenseLayer`, ``RwkvLayer``,
``MambaLayer`` or ``DecoderLayer``) in an ``nn.ModuleList`` and loops over
them in Python, reading each layer's kind (gemma3's 5:1 local:global) on
the host.  The hybrid family's weight-tied ``SharedAttnBlock`` is one
module, ``shared``, beside ``embed`` and ``final_norm``, applied after
every ``shared_attn_every``-th layer; the encdec family's encoder is a
second list, ``enc_layers`` (``EncoderLayer``), and its ``enc_norm``.
Under autograd each layer runs under ``cfg.remat``, as the reference's
``_remat`` wraps its scan body (for hybrid the shared block inside it):
``"full"`` recomputes the whole layer in the backward, ``"dots"`` keeps
the matrix products' outputs and recomputes the rest, ``"none"`` keeps
everything.

The vlm family puts ``prefix_embeds`` (B, P, D), unscaled, in front of
the token embeddings; its layers attend with the prefix-LM mask (full
attention within the prefix) and the logits are those of the last ``S``
positions.  The encdec family runs the bidirectional encoder over
``enc_frames`` (B, T_enc, D) once; each decoder layer attends causally to
the tokens and, through ``cross_attention``, to the encoder's output.

The recurrent families carry states, not a growing KV cache: rwkv6 the
``wkv`` (L, B, H, K, K) float32 state and two token-shift carries; zamba2
the SSD state (L, B, H, P, N) float32, a causal-conv tail and one KV
history per application of the shared block.  ``decode_step`` runs every
layer, the ``num_layers % shared_attn_every`` trailing ones of a hybrid
model included (the reference's decode skips those; ROADMAP §3).
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
from repro_torch.models import mamba2 as M2
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


# family -> (layer init, layer class)
_LAYERS = {"dense": (B.init_dense_layer, B.DenseLayer),
           "moe": (B.init_dense_layer, B.DenseLayer),
           "vlm": (B.init_dense_layer, B.DenseLayer),
           "ssm": (B.init_rwkv_layer, B.RwkvLayer),
           "hybrid": (B.init_mamba_layer, B.MambaLayer),
           "encdec": (B.init_decoder_layer, B.DecoderLayer)}


def check_family(cfg) -> None:
    if cfg.family not in _LAYERS:
        raise ValueError(f"unknown model family {cfg.family!r}")


def _has_shared(cfg) -> bool:
    return cfg.family == "hybrid" and cfg.shared_attn_every > 0


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
    (one layer module of the family each), untied ``lm_head`` (D, V), for
    hybrid ``shared`` (the weight-tied attention block) and for encdec
    ``enc_layers`` (one ``EncoderLayer`` each) and ``enc_norm``."""

    def __init__(self, cfg, values: Mapping, axes: Mapping | None = None):
        super().__init__()
        check_family(cfg)
        for key, n in (("layers", cfg.num_layers),
                       ("enc_layers", cfg.enc_layers)):
            if key in values and len(values[key]) != n:
                raise ValueError(f"{len(values[key])} {key} given, "
                                 f"{cfg.name} has {n}")
        self.cfg = cfg
        self.axes = axes     # logical axes, stacked layout (None if unknown)
        self.embed = nn.Parameter(values["embed"], requires_grad=False)
        self.final_norm = pr.Tree(values["final_norm"])
        layer_cls = _LAYERS[cfg.family][1]
        self.layers = nn.ModuleList(layer_cls(v) for v in values["layers"])
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(values["lm_head"],
                                        requires_grad=False)
        if _has_shared(cfg):
            self.shared = B.SharedAttnBlock(values["shared"])
        if cfg.family == "encdec":
            self.enc_layers = nn.ModuleList(
                B.EncoderLayer(v) for v in values["enc_layers"])
            self.enc_norm = pr.Tree(values["enc_norm"])

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
        if _has_shared(self.cfg):
            out["shared"] = self.shared.tree()
        if self.cfg.family == "encdec":
            out["enc_layers"] = [layer.tree() for layer in self.enc_layers]
            out["enc_norm"] = self.enc_norm.tree()
        return out


def init_model(cfg, *, generator: torch.Generator | None = None,
               device="cuda") -> LM:
    """A model with random weights drawn from ``generator`` (by default
    one on ``device`` seeded with 0), at the fan-in scale of the JAX
    package's ``params.normal``.  ``device`` defaults to ``"cuda"``, which
    raises when no CUDA device exists; on ``"meta"`` nothing is drawn or
    allocated (:func:`repro_torch.models.params.abstract_init`)."""
    check_family(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = pr.MetaDraws() if dev.type == "meta" else \
            torch.Generator(dev).manual_seed(0)
    elif generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    g, pdt = generator, cfg.param_dtype
    ptree = {
        "embed": L.init_embedding(g, cfg.vocab_size, cfg.d_model, pdt),
        "final_norm": L.init_rmsnorm(g, cfg.d_model, pdt),
        "layers": [_LAYERS[cfg.family][0](g, cfg)
                   for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        ptree["lm_head"] = pr.normal(g, (cfg.d_model, cfg.vocab_size),
                                     ("embed", "vocab"), pdt)
    if _has_shared(cfg):
        ptree["shared"] = B.init_shared_attn_block(g, cfg)
    if cfg.family == "encdec":
        ptree["enc_layers"] = [B.init_encoder_layer(g, cfg)
                               for _ in range(cfg.enc_layers)]
        ptree["enc_norm"] = L.init_rmsnorm(g, cfg.d_model, pdt)
    values, axes = pr.split_ptree(ptree)
    for key in ("layers", "enc_layers"):
        if key in axes:
            axes[key] = pr.tree_map(lambda a: ("layers",) + a, axes[key][0])
    return LM(cfg, values, axes)


# ------------------------------------------------------------------ forward
def _embed_tokens(p, cfg, tokens, shd=None, decode=False):
    if decode and shd is not None and cfg.decode_embed == "psum":
        x = L.embed_lookup_psum(p["embed"], tokens, cfg.compute_dtype, shd)
    else:
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


def _rwkv_body(layer, x, cfg):
    return layer(x, cfg=cfg)[0]


def _hybrid_body(layer, shared, x, cfg, positions):
    """One Mamba2 layer and, after every ``shared_attn_every``-th layer,
    the shared block (``shared`` None elsewhere)."""
    x, _, _ = layer(x, cfg=cfg)
    if shared is not None:
        x = shared(x, cfg=cfg, positions=positions)
    return x


def shared_after(cfg, i: int) -> bool:
    """Whether the hybrid shared block runs after layer ``i``."""
    k = cfg.shared_attn_every if _has_shared(cfg) else 0
    return bool(k) and i % k == k - 1


def prefix_slots(cfg) -> int:
    """The positions in front of the tokens: vlm's ``num_prefix`` patch
    tokens, none for the other families.  A vlm cache holds them in its
    first slots, so decoding starts at ``prefix_slots + prompt``."""
    return cfg.num_prefix if cfg.family == "vlm" else 0


def embed_inputs(p, cfg, batch):
    """The first layer's input and its positions: the token embeddings
    and, for vlm, ``prefix_embeds`` (cast, not scaled) in front of them ->
    (x (B, P + S, D), positions, prefix_len P)."""
    tokens = batch["tokens"]
    x = _embed_tokens(p, cfg, tokens)
    prefix_len = 0
    if cfg.family == "vlm":
        prefix = batch["prefix_embeds"].to(cfg.compute_dtype)
        x = torch.cat([prefix, x], dim=1)
        prefix_len = prefix.shape[1]
    return x, positions_for(x.shape[0], x.shape[1], x.device), prefix_len


def encode(p, cfg, enc_frames):
    """The encdec encoder over ``enc_frames`` (B, T_enc, D): every layer
    (each under ``cfg.remat``) and ``enc_norm``."""
    e = enc_frames.to(cfg.compute_dtype)
    positions = positions_for(e.shape[0], e.shape[1], e.device)
    for layer in p["enc_layers"]:
        e = _remat(layer, cfg)(e, cfg=cfg, positions=positions)
    return L.rmsnorm(p["enc_norm"], e, cfg.norm_eps)


def forward(p, cfg, batch):
    """Full-sequence forward -> (logits (B,S,V), aux dict).

    batch: tokens (B,S) int32 [+ prefix_embeds (B,P,D) for vlm,
    enc_frames (B,T_enc,D) for encdec].  The MoE family is
    :func:`forward_replicas` of one replica."""
    check_family(cfg)
    if cfg.family == "moe":
        logits, aux = forward_replicas([p], cfg, [batch])
        return logits[0], aux
    x, positions, prefix_len = embed_inputs(p, cfg, batch)
    aux = {k: torch.zeros((), dtype=torch.float32, device=x.device)
           for k in ("moe_aux_loss", "moe_dropped_frac")}
    if cfg.family == "ssm":
        for layer in p["layers"]:
            x = _remat(_rwkv_body, cfg)(layer, x, cfg)
    elif cfg.family == "hybrid":
        for i, layer in enumerate(p["layers"]):
            shared = p["shared"] if shared_after(cfg, i) else None
            x = _remat(_hybrid_body, cfg)(layer, shared, x, cfg, positions)
    elif cfg.family == "encdec":
        enc_out = encode(p, cfg, batch["enc_frames"])
        for layer in p["layers"]:
            x = _remat(layer, cfg)(x, enc_out, cfg=cfg, positions=positions)
    else:
        for layer, kind in zip(p["layers"], layer_kinds(cfg)):
            x, aux_i = _remat(layer, cfg)(x, cfg=cfg, kind_flag=int(kind),
                                          positions=positions,
                                          prefix_len=prefix_len)
            for k, v in aux_i.items():
                aux[k] = aux[k] + v
    x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return _logits(p, cfg, x[:, prefix_len:]), aux


def forward_replicas(ps, cfg, batches):
    """:func:`forward` of one global batch whose rows are split over data
    replicas: ``batches[r]`` replica ``r``'s rows, in order, on the device
    of its parameters ``ps[r]`` -> (the replicas' logits, aux on the first
    replica's device).  Every layer is row-local except an MoE layer,
    whose groups and load-balance statistics span the global batch; so
    the MoE family runs the replicas layer by layer
    (:func:`~repro_torch.models.blocks.dense_layer_replicas`, each layer
    of all replicas under one ``cfg.remat`` checkpoint), the others each
    replica's whole :func:`forward` in turn.  The MoE family's one layer
    loop, for one replica as for many."""
    if cfg.family != "moe":
        outs = [forward(p, cfg, b) for p, b in zip(ps, batches)]
        return [o[0] for o in outs], outs[0][1]
    xs, positions = [], []
    for p, b in zip(ps, batches):
        x, pos, prefix_len = embed_inputs(p, cfg, b)
        xs.append(x)
        positions.append(pos)
    dev0 = xs[0].device
    aux = {k: torch.zeros((), dtype=torch.float32, device=dev0)
           for k in ("moe_aux_loss", "moe_dropped_frac")}
    for i, kind in enumerate(layer_kinds(cfg)):
        xs, aux_i = _remat(B.dense_layer_replicas, cfg)(
            [p["layers"][i] for p in ps], xs, cfg=cfg, kind_flag=int(kind),
            positions=positions, prefix_len=prefix_len)
        for k, v in aux_i.items():
            aux[k] = aux[k] + v
    logits = []
    for p, x in zip(ps, xs):
        x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
        logits.append(_logits(p, cfg, x[:, prefix_len:]))
    return logits, aux


# --------------------------------------------------------------------- loss
def loss_fn(p, cfg, batch, z_loss: float = 1e-4,
            moe_loss_weight: float = 1e-2):
    """Next-token cross entropy over ``batch["labels"]`` (masked by
    ``loss_mask`` where given) plus the z-loss and, for MoE, the
    load-balance loss -> (total, metrics).  ``ll`` is read with
    ``torch.gather`` on the labels, equal to the reference's one-hot
    product without a second (B, S, V) float32 tensor.  The metrics are
    detached."""
    return loss_fn_replicas([p], cfg, [batch], z_loss, moe_loss_weight)


def _token_sums(logits, batch):
    """(sum of the masked nll, of the masked lse², of the mask)."""
    labels = batch["labels"]
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(nll)
    return (nll * mask).sum(), ((lse ** 2) * mask).sum(), mask.sum()


def _global_sum(parts, device):
    total = parts[0].to(device)
    for x in parts[1:]:
        total = total + x.to(device)
    return total


def loss_fn_replicas(ps, cfg, batches, z_loss: float = 1e-4,
                     moe_loss_weight: float = 1e-2):
    """:func:`loss_fn` of one global batch split over data replicas (see
    :func:`forward_replicas`): each replica sums its own tokens' terms,
    the sums meet on the first replica's device and are divided by the
    global mask count, so the loss is the global batch's.  -> (total on
    the first replica's device, metrics)."""
    logits, aux = forward_replicas(ps, cfg, batches)
    sums = [_token_sums(lg, b) for lg, b in zip(logits, batches)]
    dev = logits[0].device
    nll, zsum, count = (_global_sum([x[i] for x in sums], dev)
                        for i in range(3))
    denom = torch.clamp(count, min=1.0)
    loss = nll / denom
    zl = z_loss * zsum / denom
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
    """Zeroed decode cache.  dense/moe: ``k``/``v`` (global layers, L_g,
    B, max_len, Kh, Dh) and ``k_local``/``v_local`` (sliding-window
    layers: a RING buffer of ``min(window, max_len)`` slots — O(window)
    state regardless of context length).  ssm: ``wkv`` (L, B, H, K, K)
    float32 and the token-shift carries ``xlt``/``xlc`` (L, B, D).
    hybrid: ``ssm`` (L, B, H, P, N) float32, ``conv`` (L, B, 3, C) and,
    with a shared block, ``shared_k``/``shared_v`` (one KV history per
    application: ``num_layers // shared_attn_every``, B, max_len, Kh,
    Dh).  vlm: as dense (the prefix takes the first ``num_prefix``
    slots).  encdec: ``k``/``v`` of the decoder layers and the encoder's
    ``cross_k``/``cross_v`` (L, B, enc_len, Kh, Dh)."""
    check_family(cfg)
    dtype = dtype or cfg.compute_dtype
    dev = resolve_device(device)
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    n_layers = cfg.num_layers

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    if cfg.family == "ssm":
        h, hk = cfg.rwkv_heads, cfg.rwkv_head_dim
        return {"wkv": zeros((n_layers, batch_size, h, hk, hk),
                             torch.float32),
                "xlt": zeros((n_layers, batch_size, cfg.d_model),
                             cfg.compute_dtype),
                "xlc": zeros((n_layers, batch_size, cfg.d_model),
                             cfg.compute_dtype)}
    if cfg.family == "hybrid":
        h, hp, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        conv_ch = cfg.d_inner + 2 * cfg.ssm_state
        cache = {"ssm": zeros((n_layers, batch_size, h, hp, n),
                              torch.float32),
                 "conv": zeros((n_layers, batch_size, M2.D_CONV - 1,
                                conv_ch))}
        if _has_shared(cfg):
            nseg = n_layers // cfg.shared_attn_every
            for key in ("shared_k", "shared_v"):
                cache[key] = zeros((nseg, batch_size, max_len, kh, hd))
        return cache
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
    if cfg.family == "encdec":
        for key in ("cross_k", "cross_v"):
            cache[key] = zeros((n_layers, batch_size, cfg.enc_len, kh, hd))
    return cache


CACHE_AXES = {
    "k": ("layers", "batch", None, "kv_heads", "head_dim"),
    "v": ("layers", "batch", None, "kv_heads", "head_dim"),
    "k_local": ("layers", "batch", None, "kv_heads", "head_dim"),
    "v_local": ("layers", "batch", None, "kv_heads", "head_dim"),
    "cross_k": ("layers", "batch", None, "kv_heads", "head_dim"),
    "cross_v": ("layers", "batch", None, "kv_heads", "head_dim"),
    "shared_k": ("layers", "batch", None, "kv_heads", "head_dim"),
    "shared_v": ("layers", "batch", None, "kv_heads", "head_dim"),
    "ssm": ("layers", "batch", "heads", None, None),
    "conv": ("layers", "batch", None, "mlp"),
    "wkv": ("layers", "batch", "heads", None, None),
    "xlt": ("layers", "batch", "embed_act"),
    "xlc": ("layers", "batch", "embed_act"),
}


def cache_axes(cache: dict) -> dict:
    """Logical axes for every cache leaf (the sharding rules place the
    decode cache by them)."""
    return {k: CACHE_AXES[k] for k in cache}


def decode_step(p, cfg, cache, tokens, cur_pos: int, prefix_len: int = 0,
                shd=None):
    """One token for every sequence. tokens (B, 1) int32; cur_pos the
    current write position (for vlm counted from the first prefix slot,
    ``prefix_len`` the prefix's length).  Writes the cache in place and
    returns (logits (B,1,V), cache).  With ``shd`` and
    ``cfg.decode_embed == "psum"`` the token embedding is
    :func:`~repro_torch.models.layers.embed_lookup_psum` over the table
    split by ``shd``'s rules; every other leaf stays whole on the
    parameters' device (tensor-parallel compute over the model axis is
    ROADMAP item 21).  ``shd`` follows ``prefix_len`` here, where the
    reference has it before (positional callers pass ``prefix_len``)."""
    check_family(cfg)
    cur_pos = int(cur_pos)
    x = _embed_tokens(p, cfg, tokens, shd=shd, decode=True)
    if cfg.family == "ssm":
        for i, layer in enumerate(p["layers"]):
            state = (cache["wkv"][i], cache["xlt"][i], cache["xlc"][i])
            x, new = layer(x, cfg=cfg, state=state)
            for old, t in zip(state, new):
                old.copy_(t)
    elif cfg.family == "hybrid":
        # every layer, the trailing num_layers % shared_attn_every too; the
        # shared block after each whole segment, with that application's
        # own KV history
        for i, layer in enumerate(p["layers"]):
            x, ssm, conv = layer(x, cfg=cfg, state=cache["ssm"][i],
                                 conv_state=cache["conv"][i])
            cache["ssm"][i].copy_(ssm)
            cache["conv"][i].copy_(conv)
            if shared_after(cfg, i):
                si = i // cfg.shared_attn_every
                x, _ = p["shared"].decode(
                    x, {"k": cache["shared_k"][si],
                        "v": cache["shared_v"][si]}, cfg=cfg,
                    cur_pos=cur_pos)
    elif cfg.family == "encdec":
        for i, layer in enumerate(p["layers"]):
            x, _ = layer.decode(
                x, {"k": cache["k"][i], "v": cache["v"][i]},
                {"k": cache["cross_k"][i], "v": cache["cross_v"][i]},
                cfg=cfg, cur_pos=cur_pos)
    else:
        x = _decode_attention_layers(p, cfg, cache, x, cur_pos, prefix_len)
    x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return _logits(p, cfg, x), cache


def _decode_attention_layers(p, cfg, cache, x, cur_pos, prefix_len):
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
    return x
