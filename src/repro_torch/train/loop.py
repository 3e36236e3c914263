"""Fault-tolerant training loop (the JAX package's ``train/loop.py``).

Features, as the reference's:
  * a train step over the port's ``LM`` module: ``loss.backward()``
    through the model (the MoE row gathers included, see
    ``models/moe.py``), then the in-place AdamW update.
  * data parallelism over a mesh (``mesh=``, ``rules=``; see below).
  * checkpoint/restart: atomic checkpoints every ``ckpt_every`` steps,
    resume from the latest valid one (elastic across mesh changes: the
    files hold whole leaves, whatever mesh wrote them).
  * preemption handling: SIGTERM triggers a final checkpoint + clean exit.
  * straggler mitigation: per-step wall-time EWMA; steps exceeding
    ``straggler_factor`` x EWMA are logged and counted.
  * gradient accumulation (microbatching), in float32 as the reference's
    ``lax.scan``.

**Data parallel.**  With a mesh, one process drives its devices, as the
sharded engine does (no ``torch.distributed``; a collective is a loop over
the devices and copies between them).  The parameters and the AdamW
moments are stored as :class:`~repro_torch.launch.sharding.Sharded`
pieces per ``params_shardings``: FSDP over ``data`` through the
``"embed"`` rule, so a device holds 1/k of them.  Each step
(:class:`DataParallel`) all-gathers the parameters into one ``LM``
replica per data index, refilled in place; runs the forward of every
replica on its rows of the global batch and one backward
(:func:`repro_torch.models.lm.loss_fn_replicas`: the loss's denominators,
and an MoE layer's groups and router statistics, are the global batch's);
reduce-scatters the gradients onto the pieces in float32; and updates the
pieces.  A batch (or microbatch) that the data axis does not divide is
replicated, as ``batch_sharding`` falls back: every replica computes the
whole of it and keeps its own gradient (nothing is summed k times).
Microbatch ``i`` is rows ``[i B/m, (i + 1) B/m)`` of the global batch, as
the reference's reshape makes it, its rows moved to the replicas that
compute them.  The parameters are gathered whole onto each replica at the
step's start, where the reference gathers them layer by layer inside its
scan.  A mesh whose model axis is above 1 raises: tensor-parallel compute
is ROADMAP item 21.
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
from repro_torch.launch import sharding as sh
from repro_torch.models import lm
from repro_torch.models import params as pr
from repro_torch.optim import adamw

TENSOR_PARALLEL = ("compute over the mesh's model axis (tensor, expert and "
                   "vocab parallel layers) is not ported: ROADMAP item 21")


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


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, shd=None,
                    microbatches: int = 1):
    """Build ``step(model, opt_state, batch) -> (opt_state, metrics)``:
    the model's parameters are updated in place.  With ``shd`` (a
    :class:`~repro_torch.launch.sharding.Shd` over a mesh) ``model`` is a
    :class:`DataParallel` and ``batch`` a dict of ``Sharded`` pieces (as
    ``DataIterator(shd=...)`` yields them) or of global tensors, which are
    placed by ``batch_sharding`` first."""
    if shd is not None:
        return _data_parallel_step(cfg, opt_cfg, shd, microbatches)

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
            g = pr.tree_map(_grad, params)
        opt_state, opt_metrics = adamw.update(params, g, opt_state, opt_cfg)
        for p in leaves:
            p.grad = None
        return opt_state, dict(metrics, **opt_metrics)

    return step


def _grad(p) -> torch.Tensor:
    """A parameter's gradient; zeros, as ``jax.grad`` gives, where the loss
    does not reach it (a hybrid model shallower than ``shared_attn_every``
    never applies its shared block)."""
    return torch.zeros_like(p) if p.grad is None else p.grad


def _accumulate(p, acc) -> None:
    """Add a parameter's gradient into its float32 sum and drop it."""
    if p.grad is not None:
        acc.add_(p.grad)
    p.grad = None


# ----------------------------------------------------------- data parallel
def _per_layer(placements, values):
    """The stacked layout's placements on the port's per-layer tree: a
    layer's tensor drops the leading ("layers" -> None) entry."""
    if isinstance(values, list):
        inner = pr.stacked_map(
            lambda pl: sh.Placement(pl.mesh, pl.spec[1:]), placements)
        return [_per_layer(inner, v) for v in values]
    if isinstance(values, dict):
        return {k: _per_layer(placements[k], v) for k, v in values.items()}
    return placements


class DataParallel:
    """The parameters of data-parallel training over ``shd``'s mesh (its
    model axis 1): ``params``, the ``Sharded`` pieces in the port's
    per-layer tree (what :meth:`tree` returns and AdamW updates), and
    ``models``, one ``LM`` replica per data index on its device (``model``
    itself the first), which :meth:`gather` refills."""

    def __init__(self, model, shd):
        mesh = shd.mesh
        if mesh.shape["model"] != 1:
            raise NotImplementedError(f"a mesh whose model axis is "
                                      f"{mesh.shape['model']}: "
                                      f"{TENSOR_PARALLEL}")
        if model.axes is None:
            raise ValueError("the model carries no logical axes (build it "
                             "with lm.init_model, or pass axes= to "
                             "convert.lm_params_from_numpy)")
        self.shd, self.cfg = shd, model.cfg
        self.devices = tuple(mesh.devices)
        values = model.tree()
        stacked = sh.params_shardings(shd, model.axes, pr.stack_tree(values))
        self.params = pr.tree_map(
            lambda t, pl: pl.split(t.detach(), copy=True), values,
            _per_layer(stacked, values))
        self.models = [model] + [lm.LM(model.cfg, pr.tree_map(
            lambda t, d=d: torch.empty_like(t, device=d), values),
            model.axes) for d in self.devices[1:]]

    def tree(self) -> dict:
        return self.params

    @torch.no_grad()
    def gather(self, replicas: int | None = None) -> None:
        """All-gather the pieces into the replicas (all, or the first
        ``replicas``), in place."""
        for m in self.models[:replicas]:
            pr.tree_map(lambda dst, x: x.join(out=dst), m.tree(),
                        self.params)

    def rows(self, batch: dict, lo: int, hi: int):
        """Rows ``[lo, hi)`` of the global batch for each replica -> (one
        dict per replica, on its device; split).  ``split``: the data axis
        divides the rows and replica ``r`` takes its ``r``-th share;
        otherwise every replica takes them all."""
        k, n = len(self.devices), hi - lo
        split = n % k == 0
        out = []
        for r, dev in enumerate(self.devices):
            a, b = (lo + r * n // k, lo + (r + 1) * n // k) if split \
                else (lo, hi)
            one = {}
            for key, x in batch.items():
                if x.placement.spec[0] is None:       # a replicated batch
                    one[key] = x.pieces[r][a:b]
                else:
                    per = x.shape[0] // k
                    one[key] = sh.take_rows(x.pieces, range(0, k * per, per),
                                            a, b, dev)
            out.append(one)
        return out, split

    @torch.no_grad()
    def reduce_scatter(self, split: bool, into=None):
        """The replicas' gradients onto the pieces, in float32: piece ``n``
        sums every replica's gradient over its block (``split``), or takes
        replica ``n``'s own (a replicated batch).  Each leaf's gradients
        are dropped once its pieces are made.  Returns the gradient tree
        of ``Sharded`` pieces, or adds it into ``into``."""
        def one(x, *ps):
            pieces = []
            for n, dev in enumerate(self.devices):
                sl = x.placement.block(n, x.shape)
                acc = None
                for p in (ps if split else (ps[n],)):
                    if p.grad is not None:
                        g = p.grad[sl].to(dev, torch.float32).contiguous()
                        acc = g if acc is None else acc + g
                if acc is None:                # the loss does not reach it
                    acc = torch.zeros(x.pieces[n].shape, dtype=torch.float32,
                                      device=dev)
                pieces.append(acc)
            for p in ps:
                p.grad = None
            return sh.Sharded(x.placement, pieces, x.shape)

        g = pr.tree_map(one, self.params, *(m.tree() for m in self.models))
        if into is not None:
            pr.tree_map(lambda acc, x: [a.add_(b) for a, b in
                                        zip(acc.pieces, x.pieces)], into, g)
        return g if into is None else into


def _replica_loss(models, cfg, batches, split: bool):
    """The global batch's loss over the replicas -> (what to backward,
    metrics).  Split rows: one loss over all replicas.  A replicated
    batch: each replica's own loss of the whole batch; their sum is
    backwarded (the replicas' graphs are disjoint, so each gradient is its
    own replica's) and the metrics are the first replica's."""
    if split:
        return lm.loss_fn_replicas(models, cfg, batches)
    out = [lm.loss_fn(m, cfg, b) for m, b in zip(models, batches)]
    total = out[0][0]
    for loss, _ in out[1:]:
        total = total + loss.to(total.device)
    return total, out[0][1]


def _data_parallel_step(cfg, opt_cfg, shd, microbatches: int):
    def step(dp, opt_state, batch):
        if not isinstance(next(iter(batch.values())), sh.Sharded):
            placements = sh.batch_sharding(shd, batch)
            batch = {k: placements[k].split(v) for k, v in batch.items()}
        dp.gather()
        for m in dp.models:
            m.requires_grad_(True)
            for p in m.parameters():
                p.grad = None
        n = next(iter(batch.values())).shape[0]
        if microbatches > 1:
            g = pr.tree_map(lambda x: sh.Sharded(x.placement, [
                torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in x.pieces], x.shape), dp.params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=dp.devices[0])
            for i in range(microbatches):
                mbs, split = dp.rows(batch, i * n // microbatches,
                                     (i + 1) * n // microbatches)
                l, mb_metrics = _replica_loss(dp.models, cfg, mbs, split)
                l.backward()
                dp.reduce_scatter(split, into=g)
                loss += mb_metrics["loss"]
            g = pr.tree_map(lambda x: sh.Sharded(
                x.placement, [p / microbatches for p in x.pieces], x.shape),
                g)
            metrics = {"loss": loss / microbatches}
        else:
            mbs, split = dp.rows(batch, 0, n)
            l, metrics = _replica_loss(dp.models, cfg, mbs, split)
            l.backward()
            g = dp.reduce_scatter(split)
        opt_state, opt_metrics = adamw.update(dp.params, g, opt_state,
                                              opt_cfg)
        return opt_state, dict(metrics, **opt_metrics)

    return step


def train_state(model, opt_state) -> dict:
    """The checkpointed state, in the reference's stacked layout: the
    parameters (of an ``LM`` or a :class:`DataParallel`) stacked on the
    host, the AdamW state as it is, ``Sharded`` moments joined on the
    host.  A checkpoint is the same file whatever mesh wrote it."""
    def host(x):
        return x.join(device="cpu") if isinstance(x, sh.Sharded) else x
    return {"params": convert.host_stacked(pr.stack_tree(model.tree())),
            "opt": {k: pr.stacked_map(host, v)
                    for k, v in opt_state.items()}}


class Trainer:
    """``Trainer(model_cfg, tc).run()`` trains on ``device`` (default
    ``"cuda"``, which raises where torch sees no CUDA device), or data
    parallel over ``mesh`` with ``rules`` (by default
    ``default_rules(mesh)``; ignored without a mesh, as in the
    reference).  A mesh of one device (what ``make_local_mesh()`` gives on
    a one-card machine) trains on the single-device step, as
    ``mesh=None`` on that device: no pieces, no replica, no collective."""

    def __init__(self, model_cfg, tc: TrainConfig, mesh=None, rules=None,
                 device="cuda"):
        lm.check_family(model_cfg)
        self.shd = None
        if mesh is not None:
            if mesh.shape["model"] > 1:
                raise NotImplementedError(
                    f"a mesh whose model axis is {mesh.shape['model']}: "
                    f"{TENSOR_PARALLEL}")
            if not mesh.devices:
                raise ValueError("the mesh holds no device")
            for d in set(mesh.devices):
                resolve_device(d)
            device = mesh.devices[0]
            if len(mesh.devices) > 1:
                self.shd = sh.Shd(mesh, rules or sh.default_rules(mesh))
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
        state = model if self.shd is None else DataParallel(model, self.shd)
        opt_state = adamw.init(state.tree(), tc.opt)
        start_step = 0

        # ---- checkpoint/restart (elastic: whole leaves, split as placed)
        last = ckpt.latest_step(tc.ckpt_dir)
        if last is not None:
            skeleton = {"params": pr.stacked_map(
                lambda _: None, pr.stack_tree(model.tree())),
                "opt": opt_state}
            restored = ckpt.restore(tc.ckpt_dir, last, skeleton)
            convert.load_stacked(state, restored["params"])
            pr.tree_map(convert.assign, opt_state, restored["opt"])
            start_step = last

        step_fn = make_train_step(cfg, tc.opt, shd=self.shd,
                                  microbatches=tc.microbatches)
        data = DataIterator(cfg, tc.batch, tc.seq, seed=tc.seed,
                            start_step=start_step, device=dev, shd=self.shd)

        ewma = None
        pending = None
        try:
            for step in range(start_step, tc.steps):
                t0 = time.perf_counter()
                batch = next(data)
                opt_state, metrics = step_fn(state, opt_state, batch)
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
                        tc.ckpt_dir, step + 1, train_state(state, opt_state),
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
        if state is not model:          # the final parameters, whole
            state.gather(replicas=1)
        return {"params": model, "opt": opt_state,
                "metrics": self.metrics_log,
                "stragglers": self.straggler_steps,
                "data_parallel": None if state is model else state}
