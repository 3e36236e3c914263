"""How far a planted fault in the model pieces moves the served logits.

A model served over model pieces (``launch/tensor_parallel.py``
``ModelPieces``) in bf16 rounds apart from the same model on one device,
so its logits are held against the same weights in float32: no farther
from them than a multiple of one device's bf16 logits are.  This tool
reads how far that check can see.  It serves the model on one device and
over a simulated ``(1, model)`` mesh, then again over the pieces with one
fault planted at a time: piece 1's share of one sum over the pieces
dropped (the lookup's, or one layer's attention or MLP output).  For the
prefill's last logits and the first decode step's it prints each run's
distance from the float32 logits over one device's bf16 distance (largest
element, mean, root mean square) and the share of rows whose top token
is float32's:

    PYTHONPATH=src python tools/tp_planted_faults.py --arch gemma-7b

The model is drawn from ``--seed`` at its published widths (``--layers``
cuts the depth); ``--device cpu`` serves the ``reduced()`` config.  The
whole gemma-7b takes ~17 GB in bf16 and ~34 GB in float32 on the card.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch import sharding as sh
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.mesh import ShardMesh
from repro_torch.models import lm
from repro_torch.serve import engine


def served_logits(p, cfg, batch, max_len, tok, drop=None) -> tuple:
    """The prefill's last logits and the first decode step's, as float32
    numpy; with ``drop``, that sum over the pieces (counted from 0 in each
    call: the lookup, then each layer's attention and MLP) takes piece
    0's share alone."""
    real, seen = tp.reduce_out, [0]

    def planted(group, parts):
        if seen[0] == drop:
            parts = [parts[0], *map(torch.zeros_like, parts[1:])]
        seen[0] += 1
        return real(group, parts)
    tp.reduce_out = planted
    try:
        with torch.inference_mode():
            cache, last = engine.prefill(p, cfg, batch, max_len)
            seen[0] = 0
            dec, _ = lm.decode_step(p, cfg, cache, tok,
                                    batch["tokens"].shape[1])
    finally:
        tp.reduce_out = real
    return last.float().cpu().numpy(), dec.float().cpu().numpy()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--model", type=int, default=2,
                    help="the model axis of the simulated mesh")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if dev.type == "cpu":
        cfg = cfg.reduced().replace(param_dtype=torch.bfloat16,
                                    compute_dtype=torch.bfloat16)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    n = cfg.num_layers
    gen = torch.Generator(dev).manual_seed(args.seed)
    model = lm.init_model(cfg, generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt),
                           generator=gen, device=dev, dtype=torch.int32)
    batch, max_len = {"tokens": tokens}, args.prompt + 4
    mesh = ShardMesh(devices=(dev,) * args.model, data=1, model=args.model,
                     simulated=True)
    pieces = tp.ModelPieces(model, sh.Shd(mesh, sh.default_rules(mesh)))
    with torch.inference_mode():
        _, last = engine.prefill(model, cfg, batch, max_len)
    tok = torch.argmax(last[:, -1], dim=-1).to(torch.int32)[:, None]
    one = served_logits(model, cfg, batch, max_len, tok)
    runs = {"no fault": served_logits(pieces, cfg, batch, max_len, tok),
            "lookup": served_logits(pieces, cfg, batch, max_len, tok, 0)}
    for layer in sorted({0, n // 2, n - 1}):
        for k, what in ((1, "attention"), (2, "MLP")):
            runs[f"layer {layer} {what}"] = served_logits(
                pieces, cfg, batch, max_len, tok, k + 2 * layer)
    del pieces
    f32 = cfg.replace(param_dtype=torch.float32, compute_dtype=torch.float32)
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.float()
    ref = served_logits(model, f32, batch, max_len, tok)
    print(f"{cfg.name} ({n} layers, {str(cfg.param_dtype)[6:]}) over "
          f"(1, {args.model}) pieces, batch {args.batch}, prompt "
          f"{args.prompt}: distance from float32 over one device's bf16 "
          "distance (max / mean / rms), top-1 agreement with float32")
    for k, what in ((0, "prefill"), (1, "first decode step")):
        y, z = one[k], ref[k]
        print(f"  {what}: one device lies {np.abs(y - z).max():.4g} (max) "
              f"/ {np.abs(y - z).mean():.4g} (mean) from float32; logits' "
              f"scale {np.abs(z).max():.1f}")
    for name, r in runs.items():
        cols = []
        for k, what in ((0, "prefill"), (1, "decode")):
            x, y, z = r[k], one[k], ref[k]
            cols.append(
                f"{what} {np.abs(x - z).max() / np.abs(y - z).max():.3f} / "
                f"{np.abs(x - z).mean() / np.abs(y - z).mean():.3f} / "
                f"{np.sqrt(((x - z) ** 2).mean() / ((y - z) ** 2).mean()):.3f}"
                f", top-1 {(x.argmax(-1) == z.argmax(-1)).mean():.2f}")
        print(f"  {name:>20}: " + "; ".join(cols))


if __name__ == "__main__":
    main()
