"""Count the ATen ops a call dispatches: the host work that sets the pace
of a model whose device work is small.

On the card each counted op is about one kernel launch, and each costs the
host tens of microseconds, so the count predicts a host-bound step's time
before any card run.  Views and other ops that only change metadata are
not counted.  The count does not depend on the model's width or on the
device, so it is taken on the CPU at reduced width and the published
depth:

    PYTHONPATH=src python tools/count_dispatch.py --arch rwkv6-3b --seq 256

prints the ops of a prefill (batch 4, 128 tokens), a decode step and a
train step (``remat="full"``, AdamW, ``--seq`` tokens a row) of the arch.
"""
from __future__ import annotations

import argparse

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ops that return a view or a tensor with new metadata only: no kernel
VIEWS = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "slice",
    "select", "narrow", "transpose", "permute", "t", "unsqueeze", "squeeze",
    "alias", "detach", "as_strided", "split", "split_with_sizes", "chunk",
    "unbind", "diagonal", "lift_fresh"})


class DispatchCounter(TorchDispatchMode):
    """``with DispatchCounter() as c: ...`` counts, in ``c.ops``, the ATen
    ops dispatched inside the block, views excluded."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ not in VIEWS:
            self.ops += 1
        return func(*args, **(kwargs or {}))


def count_ops(fn) -> int:
    """The ops ``fn()`` dispatches."""
    with DispatchCounter() as c:
        fn()
    return c.ops


def main(argv=None) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.serve import engine
    from repro_torch.train import loop
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args(argv)

    full = get_config(args.arch)
    cfg = full.reduced().replace(num_layers=full.num_layers,
                                 ssm_chunk=full.ssm_chunk, remat="full")
    model = lm.init_model(cfg, device="cpu")
    prompt = 128
    tokens = torch.randint(0, cfg.vocab_size, (4, prompt), dtype=torch.int32)
    out = {}
    with torch.no_grad():
        out["prefill"] = count_ops(lambda: engine.prefill(
            model, cfg, {"tokens": tokens}, prompt + 8))
        cache, _ = engine.prefill(model, cfg, {"tokens": tokens},
                                  prompt + 8)
        out["decode step"] = count_ops(lambda: lm.decode_step(
            model, cfg, cache, tokens[:, :1], prompt))
    oc = adamw.AdamWConfig()
    state = adamw.init(model.tree(), oc)
    step = loop.make_train_step(cfg, oc)
    batch = {k: torch.as_tensor(v)
             for k, v in synth_batch(cfg, 2, args.seq, 0).items()}
    step(model, state, batch)          # the first step allocates moments
    out["train step"] = count_ops(lambda: step(model, state, batch))
    print(f"[dispatch] {full.name} ({cfg.num_layers} layers): "
          + ", ".join(f"{k} {v} ops" for k, v in out.items()))
    return out


if __name__ == "__main__":
    main()
