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
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import lm


def prefill(p, cfg, batch, max_len: int, shd=None):
    """Run the prompt, returning (cache, last_logits (B, 1, V)).  ``shd``
    is accepted as the reference's is; the prefill's lookup is the
    gather."""
    x, positions, prefix_len = lm.embed_inputs(p, cfg, batch)
    b, s = positions.shape
    cache = lm.init_cache(cfg, b, max_len, device=x.device)
    if cfg.family == "ssm":
        for i, layer in enumerate(p["layers"]):
            x, states = layer(x, cfg=cfg)
            for key, t in zip(("wkv", "xlt", "xlc"), states):
                cache[key][i] = t
    elif cfg.family == "hybrid":
        for i, layer in enumerate(p["layers"]):
            x, ssm, conv = layer(x, cfg=cfg)
            cache["ssm"][i] = ssm
            cache["conv"][i] = conv
            if lm.shared_after(cfg, i):
                si = i // cfg.shared_attn_every
                x, (k, v) = p["shared"](x, cfg=cfg, positions=positions,
                                        return_kv=True)
                cache["shared_k"][si, :, :s] = k
                cache["shared_v"][si, :, :s] = v
    elif cfg.family == "encdec":
        enc_out = lm.encode(p, cfg, batch["enc_frames"])
        for i, layer in enumerate(p["layers"]):
            x, (k, v, ck, cv) = layer(x, enc_out, cfg=cfg,
                                      positions=positions, return_kv=True)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
            cache["cross_k"][i] = ck
            cache["cross_v"][i] = cv
    else:
        x = _prefill_attention_layers(p, cfg, cache, x, positions,
                                      prefix_len)
    x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return cache, lm._logits(p, cfg, x[:, -1:, :])


def _prefill_attention_layers(p, cfg, cache, x, positions, prefix_len):
    s = x.shape[1]
    dev = x.device
    if "k_local" in cache:   # ring stacks (sliding-window layers)
        w = cache["k_local"].shape[2]
        slot_pos = (s - 1) - ((s - 1 - np.arange(w)) % w)
        valid = torch.as_tensor(slot_pos >= 0, device=dev)[None, :, None,
                                                           None]
        take = torch.as_tensor(np.where(slot_pos >= 0, slot_pos, 0),
                               device=dev)
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
    ``max_len``)."""
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
