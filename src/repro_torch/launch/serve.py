"""Serving launcher: batched generation with a randomly initialised model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --batch 4 --prompt-len 32 --steps 16

A port of the JAX package's ``launch/serve.py`` for every family (``--arch
rwkv6-3b``, ``zamba2-1.2b``, ``whisper-small``, ``paligemma-3b`` among
them), with the same flags and ``[serve]`` lines, plus ``--device``
(default ``cuda``, which raises where torch sees no CUDA device) and
``--seed`` (of the weights, the prompt and whisper's frames or
paligemma's patch embeddings, standard normal float32, as the
reference's stubbed frontends take them).  ``--reduced`` is
on by default, as there; ``--no-reduced`` serves the published widths.
``main(argv)`` returns the generated tokens.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.models import lm
from repro_torch.serve import engine


def frontend_inputs(cfg, batch: int, generator: torch.Generator) -> dict:
    """The stubbed frontends' inputs, standard normal float32 drawn from
    ``generator`` on its device: paligemma's patch embeddings
    ``prefix_embeds`` (batch, num_prefix, D), whisper's frame embeddings
    ``enc_frames`` (batch, enc_len, D); none for the text-only families."""
    shapes = {"vlm": ("prefix_embeds", cfg.num_prefix),
              "encdec": ("enc_frames", cfg.enc_len)}
    if cfg.family not in shapes:
        return {}
    key, n = shapes[cfg.family]
    return {key: torch.randn((batch, n, cfg.d_model), generator=generator,
                             device=generator.device, dtype=torch.float32)}


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    gen = torch.Generator(dev).manual_seed(args.seed)
    model = lm.init_model(cfg, generator=gen, device=dev)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
        device=dev, dtype=torch.int32)}
    batch.update(frontend_inputs(cfg, args.batch, gen))

    max_len = lm.prefix_slots(cfg) + args.prompt_len + args.steps + 4
    t0 = time.perf_counter()
    with torch.inference_mode():
        toks, _ = engine.generate(model, cfg, batch, steps=args.steps,
                                  max_len=max_len,
                                  temperature=args.temperature,
                                  generator=gen)
        toks = toks.cpu()
    dt = time.perf_counter() - t0
    total = args.batch * args.steps
    print(f"[serve] arch={cfg.name} batch={args.batch} "
          f"prompt={args.prompt_len} generated={args.steps}")
    print(f"[serve] tokens: {toks.numpy()[0][:12]}...")
    print(f"[serve] {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s incl. the first call)")
    return toks


if __name__ == "__main__":
    main()
