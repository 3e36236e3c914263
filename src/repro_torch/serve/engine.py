"""Batched LM serving engine: prefill + decode over the model's KV cache
(the JAX package's ``serve/engine.py``, for the ``dense`` and ``moe``
families).

``prefill`` replays the forward's layer bodies with ``return_kv=True`` so
each layer's k/v lands in the cache; ``decode_step``
(:mod:`repro_torch.models.lm`) is the single-token step, which the engine
loops for batched greedy or temperature generation.  Everything runs on the
device of the model and the tokens; the MoE layers' dispatch and combine
run on the hand-written row gather there.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import lm


def prefill(p, cfg, batch, max_len: int):
    """Run the prompt, returning (cache, last_logits (B, 1, V))."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    x = lm._embed_tokens(p, cfg, tokens)
    positions = lm.positions_for(b, s, dev)
    cache = lm.init_cache(cfg, b, max_len, device=dev)
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
                             positions=positions, return_kv=True)
        i = seen[kind]
        seen[kind] += 1
        if kind == 0:        # full-length stacks (global layers)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
        else:
            cache["k_local"][i] = k[:, take] * valid
            cache["v_local"][i] = v[:, take] * valid
    x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return cache, lm._logits(p, cfg, x[:, -1:, :])


def generate(p, cfg, batch, steps: int, max_len: int,
             temperature: float = 0.0,
             generator: torch.Generator | None = None):
    """Batched generation. Returns (tokens (B, steps) int32, final cache).

    ``temperature == 0`` is greedy (``argmax``, the first of equal maxima);
    otherwise each token is drawn with ``torch.multinomial`` from the
    softmax of the logits over ``temperature``, using ``generator`` (on the
    tokens' device) when one is given."""
    s = batch["tokens"].shape[1]
    cache, last_logits = prefill(p, cfg, batch, max_len)

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
        logits, cache = lm.decode_step(p, cfg, cache, tok[:, None], s + i)
        tok = sample(logits)
        out.append(tok)
    return torch.stack(out, dim=1), cache
