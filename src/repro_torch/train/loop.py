"""Fault-tolerant training loop (the JAX package's ``train/loop.py``).

Features, as the reference's, on one device:
  * a train step over the port's ``LM`` module: ``loss.backward()``
    through the model (the MoE row gathers included, see
    ``models/moe.py``), then the in-place AdamW update.
  * checkpoint/restart: atomic checkpoints every ``ckpt_every`` steps,
    resume from the latest valid one.
  * preemption handling: SIGTERM triggers a final checkpoint + clean exit.
  * straggler mitigation: per-step wall-time EWMA; steps exceeding
    ``straggler_factor`` x EWMA are logged and counted.
  * gradient accumulation (microbatching), in float32 as the reference's
    ``lax.scan``.

Data-parallel training over several devices needs the LM's logical-axis
sharding rules, which are not ported: a ``mesh`` of more than one device,
or ``rules``, raises (ROADMAP item 19).
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time

import torch

from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.engine import resolve_device
from repro_torch.data.pipeline import DataIterator
from repro_torch.models import lm
from repro_torch.models import params as pr
from repro_torch.optim import adamw

MULTI_DEVICE = ("data-parallel training needs the LM's logical-axis "
                "sharding rules, which are not ported yet: ROADMAP item 19")


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 128
    ckpt_every: int = 50
    # the reference's /tmp/repro_ckpt, under the temporary directory
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ckpt_keep: int = 3
    log_every: int = 10
    seed: int = 0
    microbatches: int = 1
    straggler_factor: float = 3.0
    async_ckpt: bool = True
    opt: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, microbatches: int = 1):
    """Build ``step(model, opt_state, batch) -> (opt_state, metrics)``:
    the model's parameters are updated in place."""

    def step(model, opt_state, batch):
        model.requires_grad_(True)
        params = model.tree()
        leaves = list(model.parameters())
        for p in leaves:
            p.grad = None
        if microbatches > 1:
            g = pr.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for i in range(microbatches):
                mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                   + v.shape[1:])[i] for k, v in batch.items()}
                l, _ = lm.loss_fn(model, cfg, mb)
                l.backward()
                pr.tree_map(_accumulate, params, g)
                loss += l.detach()
            g = pr.tree_map(lambda x: x / microbatches, g)
            metrics = {"loss": loss / microbatches}
        else:
            l, metrics = lm.loss_fn(model, cfg, batch)
            l.backward()
            g = pr.tree_map(lambda p: p.grad, params)
        opt_state, opt_metrics = adamw.update(params, g, opt_state, opt_cfg)
        for p in leaves:
            p.grad = None
        return opt_state, dict(metrics, **opt_metrics)

    return step


def _accumulate(p, acc) -> None:
    """Add a parameter's gradient into its float32 sum and drop it."""
    acc.add_(p.grad)
    p.grad = None


def train_state(model, opt_state) -> dict:
    """The checkpointed state, in the reference's stacked layout: the
    parameters stacked on the host, the AdamW state as it is."""
    return {"params": convert.host_stacked(pr.stack_tree(model.tree())),
            "opt": opt_state}


def _single_device(mesh):
    devs = set(mesh.devices)
    if len(devs) > 1:
        raise NotImplementedError(f"a mesh of {len(devs)} devices: "
                                  f"{MULTI_DEVICE}")
    if not devs:
        raise ValueError("the mesh holds no device")
    return devs.pop()


class Trainer:
    """``Trainer(model_cfg, tc).run()`` trains on ``device`` (default
    ``"cuda"``, which raises where torch sees no CUDA device), or on the
    one device of ``mesh``."""

    def __init__(self, model_cfg, tc: TrainConfig, mesh=None, rules=None,
                 device="cuda"):
        if rules is not None:
            raise NotImplementedError(f"sharding rules: {MULTI_DEVICE}")
        if mesh is not None:
            device = _single_device(mesh)
        lm.check_family(model_cfg)
        self.cfg = model_cfg
        self.tc = tc
        self.device = resolve_device(device)
        self._preempted = False
        self.metrics_log: list[dict] = []
        self.straggler_steps = 0

    def _install_signal_handlers(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # non-main thread (tests)

    # ------------------------------------------------------------------ run
    def run(self) -> dict:
        cfg, tc, dev = self.cfg, self.tc, self.device
        self._install_signal_handlers()
        gen = torch.Generator(dev).manual_seed(tc.seed)
        model = lm.init_model(cfg, generator=gen, device=dev)
        opt_state = adamw.init(model.tree(), tc.opt)
        start_step = 0

        # ---- checkpoint/restart
        last = ckpt.latest_step(tc.ckpt_dir)
        if last is not None:
            skeleton = {"params": pr.stacked_map(
                lambda _: None, pr.stack_tree(model.tree())),
                "opt": opt_state}
            restored = ckpt.restore(tc.ckpt_dir, last, skeleton)
            convert.load_stacked(model, restored["params"])
            pr.tree_map(torch.Tensor.copy_, opt_state, restored["opt"])
            start_step = last

        step_fn = make_train_step(cfg, tc.opt, microbatches=tc.microbatches)
        data = DataIterator(cfg, tc.batch, tc.seq, seed=tc.seed,
                            start_step=start_step, device=dev)

        ewma = None
        pending = None
        try:
            for step in range(start_step, tc.steps):
                t0 = time.perf_counter()
                batch = next(data)
                opt_state, metrics = step_fn(model, opt_state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                metrics.update(step=step, step_time=dt)
                # ---- straggler detection
                if ewma is not None and dt > tc.straggler_factor * ewma:
                    self.straggler_steps += 1
                    metrics["straggler"] = True
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
                self.metrics_log.append(metrics)
                if step % tc.log_every == 0:
                    print(f"[train] step={step} "
                          f"loss={metrics.get('loss', float('nan')):.4f} "
                          f"t={dt * 1e3:.1f}ms")
                if (step + 1) % tc.ckpt_every == 0 or self._preempted:
                    if pending is not None:
                        pending.join()
                    pending = ckpt.save(
                        tc.ckpt_dir, step + 1, train_state(model, opt_state),
                        axes_tree={"params": model.axes},
                        extra={"model": cfg.name},
                        keep=tc.ckpt_keep, block=not tc.async_ckpt)
                if self._preempted:
                    print("[train] preemption: checkpointed, exiting")
                    break
        finally:
            data.close()
            if pending is not None:
                pending.join()
        return {"params": model, "opt": opt_state,
                "metrics": self.metrics_log,
                "stragglers": self.straggler_steps}
