"""Batched LM serving engine: prefill + decode over the model's cache
(the JAX package's ``serve/engine.py``, for every family).

``prefill`` replays the forward's layer bodies: with ``return_kv=True`` so
each attention layer's k/v lands in the cache (for vlm the patch prefix's
too, in the first ``P`` slots; for encdec also each decoder layer's cross
k/v of the encoder's output, computed once), and for the recurrent
families each layer's final states (rwkv6's ``wkv`` and token-shift
carries, Mamba2's SSD state and conv tail; the KV of each application of
zamba2's shared block in its own history); ``decode_step``
(:mod:`repro_torch.models.lm`) is the single-token step, which the engine
loops for batched greedy or temperature generation.  Everything runs on the
device of the model and the tokens; the MoE layers' dispatch and combine
run on the hand-written row gather there.  ``shd`` (a
:class:`~repro_torch.launch.sharding.Shd`) reaches ``decode_step``, where
``cfg.decode_embed == "psum"`` looks the tokens up in the table split by
its rules (:func:`~repro_torch.models.layers.embed_lookup_psum`); the
prefill keeps the gather, as in the reference.

A model split over a mesh's model axis, :class:`~repro_torch.launch.
tensor_parallel.ModelPieces` (every family), serves over its pieces:
``generate(ModelPieces(model, shd), cfg, ...)``.  Each data replica runs
its rows of the batch (all of them where ``data`` does not divide it;
whisper's encoder frames and paligemma's patch prefix with them) through
its group of pieces, each piece filling its own cache
(:func:`~repro_torch.models.lm.init_cache_pieces`: its kv heads of the
self, cross and shared caches, its heads of the wkv and SSD states, its
channels of the conv tail); the last position's logits are gathered over
the vocab pieces to sample.  The ssm, hybrid and encdec families'
one-device prefill is the one-piece case of the same group prefill.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch import tensor_parallel as tp
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import lm


def prefill(p, cfg, batch, max_len: int, shd=None):
    """Run the prompt, returning (cache, last_logits (B, 1, V)).  ``shd``
    is accepted as the reference's is; the prefill's lookup is the
    gather.  ``p`` a ``ModelPieces`` runs over its pieces (its own rules;
    ``shd`` is not read)."""
    if isinstance(p, tp.ModelPieces):
        return _prefill_pieces(p, cfg, batch, max_len)
    if cfg.family in lm.GROUP_FAMILIES:
        dev = p["embed"].device
        cache = lm.init_cache(cfg, batch["tokens"].shape[0], max_len,
                              device=dev)
        x = _prefill_group(tp.Group.one(p, dev), cfg, batch, [cache])
        x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
        return cache, lm._logits(p, cfg, x[:, -1:, :])
    x, positions, prefix_len = lm.embed_inputs(p, cfg, batch)
    b, s = positions.shape
    cache = lm.init_cache(cfg, b, max_len, device=x.device)
    x = _prefill_attention_layers(p, cfg, cache, x, positions, prefix_len)
    x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return cache, lm._logits(p, cfg, x[:, -1:, :])


def _prefill_group(g, cfg, batch, caches):
    """The ssm, hybrid or encdec prompt through a group of model pieces
    (``batch`` on its lead), each piece filling its cache ``caches[j]`` ->
    the last hidden states on the lead."""
    x, positions, _ = lm.embed_inputs(g, cfg, batch)
    s = x.shape[1]
    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x, (wkv, xlt, xlc) = B.rwkv_layer_pieces(g["layers"][i], x,
                                                     cfg=cfg)
            for c, t in zip(caches, wkv):
                c["wkv"][i] = t
            for c in caches:
                c["xlt"][i] = xlt
                c["xlc"][i] = xlc
    elif cfg.family == "hybrid":
        for i in range(cfg.num_layers):
            x, ssm, conv = B.mamba_layer_pieces(g["layers"][i], x, cfg=cfg)
            for key, news in (("ssm", ssm), ("conv", conv)):
                for c, t in zip(caches, news):
                    c[key][i] = t
            if lm.shared_after(cfg, i):
                si = i // cfg.shared_attn_every
                x, kvs = B.shared_attn_block_pieces(
                    g["shared"], x, cfg=cfg, positions=positions,
                    return_kv=True)
                for c, (k, v) in zip(caches, kvs):
                    c["shared_k"][si, :, :s] = k
                    c["shared_v"][si, :, :s] = v
    else:
        encs = tp.copy_in(g, lm.encode(g, cfg, batch["enc_frames"]))
        for i in range(cfg.num_layers):
            x, (kvs, cross) = B.decoder_layer_pieces(
                g["layers"][i], x, encs, cfg=cfg, positions=positions,
                return_kv=True)
            for c, (k, v) in zip(caches, kvs):
                c["k"][i, :, :s] = k
                c["v"][i, :, :s] = v
            for c, (k, v) in zip(caches, cross):
                c["cross_k"][i] = k
                c["cross_v"][i] = v
    return x


def _ring(s: int, w: int, dev):
    """The prompt positions a ring of ``w`` slots holds after ``s``
    tokens -> (the position of each slot, whether it holds one)."""
    slot_pos = (s - 1) - ((s - 1 - np.arange(w)) % w)
    valid = torch.as_tensor(slot_pos >= 0, device=dev)[None, :, None, None]
    take = torch.as_tensor(np.where(slot_pos >= 0, slot_pos, 0), device=dev)
    return take, valid


def _prefill_attention_layers(p, cfg, cache, x, positions, prefix_len):
    s = x.shape[1]
    dev = x.device
    if "k_local" in cache:   # ring stacks (sliding-window layers)
        take, valid = _ring(s, cache["k_local"].shape[2], dev)
    seen = {0: 0, 1: 0}
    for layer, kind in zip(p["layers"], lm.layer_kinds(cfg)):
        kind = int(kind)
        x, _, (k, v) = layer(x, cfg=cfg, kind_flag=kind,
                             positions=positions, prefix_len=prefix_len,
                             return_kv=True)
        i = seen[kind]
        seen[kind] += 1
        if kind == 0:        # full-length stacks (global layers)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
        else:
            cache["k_local"][i] = k[:, take] * valid
            cache["v_local"][i] = v[:, take] * valid
    return x


def _prefill_pieces(mp, cfg, batch, max_len):
    b = batch["tokens"].shape[0]
    m = mp.model
    cache = lm.init_cache_pieces(mp, b, max_len)
    batches = [{k: v[r].to(g.devices[0]) for k, v in batch.items()}
               for g, r in zip(mp.groups, mp.rows(b))]
    if cfg.family in lm.GROUP_FAMILIES:
        xs = [_prefill_group(g, cfg, rb, lm.piece_caches(mp, cache, i))
              for i, (g, rb) in enumerate(zip(mp.groups, batches))]
        return cache, lm.pieces_logits(mp, cfg, [x[:, -1:, :] for x in xs],
                                       b)
    xs, positions = [], []
    for g, rb in zip(mp.groups, batches):
        x, pos, prefix_len = lm.embed_inputs(g, cfg, rb)
        xs.append(x)
        positions.append(pos)
    s = xs[0].shape[1]
    rings = {}
    seen = {0: 0, 1: 0}
    for i, kind in enumerate(lm.layer_kinds(cfg)):
        kind = int(kind)
        xs, _, kvs = B.dense_layer_groups(
            [g["layers"][i] for g in mp.groups], xs, cfg=cfg,
            kind_flag=kind, positions=positions, prefix_len=prefix_len,
            return_kv=True)
        li = seen[kind]
        seen[kind] += 1
        for r, pairs in enumerate(kvs):
            for j, (k, v) in enumerate(pairs):
                n = r * m + j
                if kind == 0:        # full-length stacks (global layers)
                    cache["k"].pieces[n][li, :, :s] = k
                    cache["v"].pieces[n][li, :, :s] = v
                    continue
                dst_k = cache["k_local"].pieces[n]
                if k.device not in rings:
                    rings[k.device] = _ring(s, dst_k.shape[2], k.device)
                take, valid = rings[k.device]
                dst_k[li] = k[:, take] * valid
                cache["v_local"].pieces[n][li] = v[:, take] * valid
    return cache, lm.pieces_logits(mp, cfg, [x[:, -1:, :] for x in xs], b)


def generate(p, cfg, batch, steps: int, max_len: int,
             temperature: float = 0.0,
             generator: torch.Generator | None = None, shd=None):
    """Batched generation. Returns (tokens (B, steps) int32, final cache).

    ``temperature == 0`` is greedy (``argmax``, the first of equal maxima);
    otherwise each token is drawn with ``torch.multinomial`` from the
    softmax of the logits over ``temperature``, using ``generator`` (on the
    tokens' device) when one is given.  For vlm, ``max_len`` counts the
    ``num_prefix`` patch slots too.  ``shd`` goes to every decode step
    (it follows ``generator`` here; the reference has it after
    ``max_len``).  ``p`` a ``ModelPieces`` serves over its pieces; the
    cache is then a dict of ``Sharded`` pieces."""
    s = batch["tokens"].shape[1]
    prefix_len = lm.prefix_slots(cfg)
    cache, last_logits = prefill(p, cfg, batch, max_len, shd)

    def sample(logits):
        last = logits[:, -1, :]
        if temperature == 0.0:
            return torch.argmax(last, dim=-1).to(torch.int32)
        probs = torch.softmax(last.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)

    tok = sample(last_logits)
    out = [tok]
    for i in range(steps - 1):
        logits, cache = lm.decode_step(p, cfg, cache, tok[:, None],
                                       s + prefix_len + i, prefix_len, shd)
        tok = sample(logits)
        out.append(tok)
    return torch.stack(out, dim=1), cache
