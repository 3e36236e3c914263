"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --preset tiny --steps 100

A port of the JAX package's ``launch/train.py`` for every family (``--arch
rwkv6-3b``, ``zamba2-1.2b``, ``whisper-small``, ``paligemma-3b`` among
them), with the same flags, ``PRESETS`` and ``[train]`` lines, plus
``--device`` (default ``cuda``, which raises where torch sees no CUDA
device).  Presets scale the architecture's family to a size trainable on
one device; ``--full`` uses the published config unchanged (granite-3-2b
fits one H100).  As in the reference, training runs on the local mesh
(every visible device of ``--device``'s type: every CUDA card, or the one
CPU) with ``default_rules``: data parallel over the cards, parameters and
moments FSDP-sharded over them; a mesh of one device (one card, or the
CPU) trains on the single-device step.  ``--production-mesh`` raises
(ROADMAP items 21 and 6), naming the dry run that reckons that mesh.  ``main(argv)`` returns the ``Trainer``'s output.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.optim import adamw
from repro_torch.train.loop import TrainConfig, Trainer

PRESETS = {
    # name: (layers, d_model, heads, kv, d_ff, vocab) approx params
    "tiny": dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                 head_dim=32, d_ff=512, vocab_size=2048),      # ~1M
    "25m": dict(num_layers=6, d_model=512, num_heads=8, num_kv_heads=4,
                head_dim=64, d_ff=1536, vocab_size=8192),      # ~25M
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 head_dim=64, d_ff=3072, vocab_size=32000),    # ~110M
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--full", action="store_true",
                    help="use the published config unchanged")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.production_mesh:
        raise NotImplementedError(
            "training on the 256/512-chip production mesh needs 256 cards "
            "(multi-card runs: ROADMAP item 6) and tensor-parallel compute "
            "over its model axis (ROADMAP item 21); a device's share of a "
            "step on that mesh is reckoned by python -m "
            "repro_torch.launch.dryrun --arch ... --shape ... --mesh pod")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        over = dict(PRESETS[args.preset])
        if cfg.family == "moe":
            over.update(num_experts=min(cfg.num_experts, 8), top_k=2,
                        moe_d_ff=over["d_ff"] // 4)
        if cfg.family in ("ssm", "hybrid"):
            over.update(ssm_state=min(cfg.ssm_state or 16, 32))
        over.update(param_dtype=torch.float32, compute_dtype=torch.float32,
                    remat="none", window=min(cfg.window, 64))
        cfg = cfg.replace(**over)

    mesh = make_local_mesh(device=dev)
    rules = sh.default_rules(mesh)
    print(f"[train] mesh {mesh.shape} over "
          f"{[str(d) for d in mesh.devices]}, default rules")
    tc = TrainConfig(
        steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        microbatches=args.microbatches,
        opt=adamw.AdamWConfig(lr=args.lr,
                              warmup_steps=min(50, args.steps // 10 + 1),
                              total_steps=args.steps))
    out = Trainer(cfg, tc, mesh=mesh, rules=rules).run()
    losses = [m.get("loss") for m in out["metrics"]]
    print(f"[train] done: {len(losses)} steps, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"stragglers={out['stragglers']}")
    return out


if __name__ == "__main__":
    main()
