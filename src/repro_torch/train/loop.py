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
pieces.  With 8-bit moments (``AdamWConfig(quantize_moments=True)``)
the moments' blocks are cut along the flattened stacked leaf
(``sharding.blocks_placement``), so the gradients are reduce-scattered in
that flat order instead, each device updates its blocks' elements in its
replica's copy of the parameters, and an exchange copies the new values
into the parameter pieces (``optim/adamw.py``).  ``DataParallel``
counts the bytes of these collectives in the reference's unit (the
output's bytes on one device, ``collectives``).  A batch (or microbatch)
that the data axis does not divide is
replicated, as ``batch_sharding`` falls back: every replica computes the
whole of it and keeps its own gradient (nothing is summed k times).
Microbatch ``i`` is rows ``[i B/m, (i + 1) B/m)`` of the global batch, as
the reference's reshape makes it, its rows moved to the replicas that
compute them.  The parameters are gathered whole onto each replica at the
step's start, where the reference gathers them layer by layer inside its
scan.

**Tensor and expert parallel.**  On a ``(data, model)`` mesh whose model
axis is above 1 (every family) the pieces are cut over ``model`` too, by
the ``heads``, ``heads_flat``, ``kv_heads``, ``mlp``, ``experts``,
``router_experts`` and ``vocab`` rules: device ``(i, j)`` holds its data
block of its model block.  ``DataParallel`` keeps one ``LM`` piece per
device, the model block whole over ``data``: :meth:`DataParallel.gather`
all-gathers over ``data`` only, and data replica ``i``'s pieces form a
:class:`~repro_torch.launch.tensor_parallel.Group` that computes its rows
piece by piece (``launch/tensor_parallel.py``: Megatron attention and
MLP, the rwkv6 mixes and the Mamba2 SSD by heads, expert-parallel MoE,
vocab-parallel lookup, logits and loss), its sums over the pieces
counted in ``collectives``.  The gradients are reduce-scattered over
``data`` within each model piece; a leaf whole in every model piece that
several pieces compute with (kv heads the model axis does not divide,
rwkv6's ``mu`` and ``w_lora_a``, a norm's scale cut by the pieces' use)
sums their gradients first.  The program is the
reference's global one: its single-device result is what the pieces
compute.  With 8-bit moments the blocks stay cut over ``data`` alone (the
reference's layout), so every model replica of a data index holds the
same run of blocks: its flat run of the gradient is summed over ``data``
and assembled from the data replica's model pieces, and each model
replica updates that run identically, reading the parameters from the
data replica's model blocks and writing the new values straight into the
pieces cut over ``data`` and ``model`` (:class:`FlatRun`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
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
from repro_torch.launch import tensor_parallel as tp
from repro_torch.models import lm
from repro_torch.models import params as pr
from repro_torch.optim import adamw

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
def flat_boxes(lo: int, hi: int, *shape: int) -> list:
    """The flat range ``[lo, hi)`` of a C-ordered array of ``shape`` as at
    most ``2 len(shape) - 1`` boxes, each the ``(start, stop)`` of every
    dimension in turn."""
    if lo >= hi:
        return []
    if len(shape) == 1:
        return [(lo, hi)]
    inner, rest = math.prod(shape[1:]), shape[1:]
    r0, r1 = lo // inner, hi // inner
    if r0 == (hi - 1) // inner:                 # within one row
        return [(r0, r0 + 1) + b for b in
                flat_boxes(lo - r0 * inner, hi - r0 * inner, *rest)]
    boxes = []
    if lo % inner:                              # the rest of a row
        boxes += [(r0, r0 + 1) + b for b in
                  flat_boxes(lo % inner, inner, *rest)]
        r0 += 1
    if r1 > r0:                                 # whole rows
        boxes.append((r0, r1) + tuple(x for n in rest for x in (0, n)))
    if hi % inner:                              # part of a row
        boxes += [(r1, r1 + 1) + b for b in flat_boxes(0, hi % inner,
                                                         *rest)]
    return boxes


def _range_boxes(shape, block: tuple, lo: int, hi: int):
    """The elements at flat indices ``[lo, hi)`` of a tensor of ``shape``
    that lie in ``block`` (slices, cut in any dimensions), as boxes of
    slices of the tensor."""
    for box in flat_boxes(lo, hi, *shape):
        sl = tuple(slice(max(box[2 * i], b.start), min(box[2 * i + 1],
                                                        b.stop))
                   for i, b in enumerate(block))
        if all(x.start < x.stop for x in sl):
            yield sl


def _run_box(run: torch.Tensor, base: int, shape, box: tuple):
    """The elements ``box`` (slices of a C-ordered tensor of ``shape``) in
    ``run``, a flat contiguous tensor holding that tensor's elements from
    flat index ``base``, as a strided view."""
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    start = sum(x.start * st for x, st in zip(box, strides)) - base
    return run.as_strided(tuple(x.stop - x.start for x in box), strides,
                          run.storage_offset() + start)


def copy_flat_range(dst: torch.Tensor, src: torch.Tensor, block: tuple,
                    lo: int, hi: int, shape=None, base: int = 0) -> None:
    """Copy the elements at flat indices ``[lo, hi)`` of a tensor of
    ``shape`` that lie in ``block`` (slices, cut in any dimensions: a
    parameter piece cut over ``data`` and ``model``) into ``dst``, the
    block-shaped piece.  ``src`` is the whole tensor (``shape`` None), or
    a flat run of it holding its elements from flat index ``base``."""
    whole = shape is None
    shape = tuple(src.shape) if whole else tuple(shape)
    for box in _range_boxes(shape, block, lo, hi):
        dst[sh.relative(box, block)].copy_(
            src[box] if whole else _run_box(src, base, shape, box))


def _into_run(run, base: int, shape, src, region: tuple, lo: int,
              hi: int, add: bool) -> None:
    """Write (or add) the elements of ``src``, the ``region``-shaped
    block of a tensor of ``shape``, at flat indices ``[lo, hi)`` into
    ``run`` (a flat run of that tensor from flat index ``base``)."""
    for box in _range_boxes(shape, region, lo, hi):
        out = _run_box(run, base, shape, box)
        part = src[sh.relative(box, region)]
        if add:
            out.add_(part.to(out.device, torch.float32))
        else:
            out.copy_(part)


def _layer_span(lo: int, hi: int, layer_n: int, layers: int) -> range:
    """The layers of a stacked leaf that the flat range ``[lo, hi)``
    touches."""
    return range(lo // layer_n, min(-(-hi // layer_n), layers))


def _block_shape(block: tuple) -> tuple:
    return tuple(b.stop - b.start for b in block)


def _layer_grads(parts) -> list:
    """The gradients of a stacked leaf's per-layer tensors (zeros where
    the loss does not reach one)."""
    return [torch.zeros_like(p) if p.grad is None else p.grad
            for p in parts]


class FlatRun:
    """Device ``n``'s run ``[lo, hi)`` of blocks of a flat stacked leaf on a
    model axis above 1, as AdamW reads and writes it
    (``adamw.FlatParts``' protocol, in flat indices of the leaf): read
    from the model blocks of device ``n``'s data replica (``reps``, the
    models' stacked leaves; ``regions``, their per-layer model-only
    placements), gathered at the step's start; written into the parameter
    pieces on device ``n``'s model index that hold the elements (``x``,
    the leaf's per-layer ``Sharded`` pieces; where the blocks are not cut
    over ``data``, device ``n``'s own piece alone)."""

    def __init__(self, dp, n: int, x, regions, reps, run, cut_data: bool):
        m = dp.model
        self.layers = x if isinstance(x, list) else [x]
        self.regions = regions if isinstance(regions, list) else [regions]
        self.shape = tuple(self.layers[0].shape)
        self.layer_n = math.prod(self.shape)
        self.cut = bool(sh.axes_of(self.regions[0]))
        first = n - n % m
        # the model blocks holding the run: every piece's where the leaf is
        # cut over model, else device n's own (each holds it whole)
        self.sources = [(r, reps[r] if isinstance(reps[r], list) else
                         [reps[r]]) for r in (range(first, first + m)
                                              if self.cut else (n,))]
        self.targets = range(n % m, len(dp.devices), m) if cut_data \
            else (n,)
        self.device, self.lo, self.hi = dp.devices[n], *run
        self.dtype = self.sources[0][1][0].dtype

    def _span(self, a: int, b: int):
        for i in _layer_span(a, b, self.layer_n, len(self.layers)):
            yield i, a - i * self.layer_n, max(a - i * self.layer_n, 0), \
                min(b - i * self.layer_n, self.layer_n)

    @torch.no_grad()
    def read(self, a: int, b: int) -> torch.Tensor:
        out = torch.empty(b - a, dtype=self.dtype, device=self.device)
        for i, base, lo, hi in self._span(a, b):
            for r, parts in self.sources:
                _into_run(out, base, self.shape, parts[i],
                          self.regions[i].block(r, self.shape), lo, hi,
                          False)
        return out

    @torch.no_grad()
    def write(self, a: int, b: int, values: torch.Tensor) -> None:
        for i, base, lo, hi in self._span(a, b):
            xi = self.layers[i]
            for t in self.targets:
                copy_flat_range(xi.pieces[t], values, xi.placement.block(
                    t, xi.shape), lo, hi, self.shape, base)


class DataParallel:
    """The parameters of data-parallel training over ``shd``'s mesh:
    ``params``, the ``Sharded`` pieces in the port's per-layer tree (what
    :meth:`tree` returns and AdamW updates), and ``models``, one ``LM``
    per device (``models[i * model + j]`` on device ``(i, j)``), which
    :meth:`gather` refills.  With a model axis of 1 these are whole
    replicas, ``model`` itself the first.  With a model axis above 1 each
    is device ``(i, j)``'s model block of every leaf, whole over ``data``
    (the model's own parameters are released meanwhile; :meth:`whole`
    gathers them back), and ``groups[i]`` is data replica ``i``'s
    :class:`~repro_torch.launch.tensor_parallel.Group` of them.
    :attr:`replicas` is what the loss runs over: the models, or the
    groups.  ``collectives`` counts, by kind, the collectives the steps
    ran and their bytes on one device (the output's: a gathered tensor, a
    float32 gradient piece, a parameter piece filled by the exchange, a
    sum over the model pieces), as the reference's dry run counts them in
    a device's program: the data axis's, and the model axis's of data
    replica 0's group (``groups[0]`` alone carries the counter);
    :meth:`reset_collectives` zeroes it."""

    def __init__(self, model, shd):
        """Split ``model`` over ``shd``'s mesh.  With a model axis above 1
        this empties ``model``'s own parameters (each becomes an empty
        tensor, so the card holds the pieces alone): read the model
        through :meth:`whole`, which gathers them back, not directly."""
        mesh = shd.mesh
        if model.axes is None:
            raise ValueError("the model carries no logical axes (build it "
                             "with lm.init_model, or pass axes= to "
                             "convert.lm_params_from_numpy)")
        self.shd, self.cfg = shd, model.cfg
        self.collectives = tp.zero_collectives()
        self.devices = tuple(mesh.devices)
        self.data, self.model = mesh.shape["data"], tp.model_axis(mesh)
        self.whole_model = model
        values = model.tree()
        placements = sh.per_layer(sh.params_shardings(
            shd, model.axes, pr.stack_tree(values)), values)
        self.params = pr.tree_map(
            lambda t, pl: pl.split(t.detach(), copy=True), values,
            placements)
        m = self.model
        if m == 1:
            self.blocks = None
            self.models = [model] + [lm.LM(model.cfg, pr.tree_map(
                lambda t, d=d: torch.empty_like(t, device=d), values),
                model.axes) for d in self.devices[1:]]
            self.groups = None
        else:
            self.blocks = pr.tree_map(sh.model_only, placements)
            self.models = [lm.LM(model.cfg, pr.tree_map(
                lambda t, pl, n=n, d=d: torch.empty(
                    _block_shape(pl.block(n, t.shape)), dtype=t.dtype,
                    device=d), values, self.blocks), model.axes)
                for n, d in enumerate(self.devices)]
            count = functools.partial(tp.count_into, self.collectives)
            self.groups = [tp.Group(self.models[i * m:(i + 1) * m],
                                    self.devices[i * m:(i + 1) * m],
                                    count if i == 0 else None)
                           for i in range(self.data)]
            with torch.no_grad():
                for p in model.parameters():
                    p.data = p.data.new_empty(0)

    @property
    def replicas(self) -> list:
        return self.models if self.groups is None else self.groups

    def _region(self, n: int, leaf_blocks, shape):
        """Device ``n``'s model block of a leaf (None: the whole)."""
        return None if leaf_blocks is None else leaf_blocks.block(n, shape)

    def tree(self) -> dict:
        return self.params

    def reset_collectives(self) -> None:
        tp.zero_collectives(self.collectives)

    def _count(self, kind: str, nbytes: int) -> None:
        tp.count_into(self.collectives, kind, nbytes)

    @torch.no_grad()
    def gather(self, replicas: int | None = None) -> None:
        """All-gather the pieces over ``data`` into the models (all, or
        those of the first ``replicas`` data replicas), in place."""
        def one(x):
            cut = sh.data_cut(x.placement)
            if cut > 1:
                self._count("all-gather", x.pieces[0].numel() * cut *
                            x.pieces[0].element_size())
        pr.tree_map(one, self.params)
        last = None if replicas is None else replicas * self.model
        for n, m in enumerate(self.models[:last]):
            if self.blocks is None:
                pr.tree_map(lambda dst, x: x.join(out=dst), m.tree(),
                            self.params)
            else:
                pr.tree_map(lambda dst, x, b, n=n: x.join(
                    out=dst, region=b.block(n, x.shape)), m.tree(),
                    self.params, self.blocks)

    @torch.no_grad()
    def whole(self):
        """The model this was built from, holding the whole parameters
        gathered from the pieces."""
        if self.blocks is None:
            self.gather(replicas=1)
            return self.models[0]

        def one(p, x):
            p.data = x.join(device=self.devices[0])
        pr.tree_map(one, self.whole_model.tree(), self.params)
        return self.whole_model

    def _stacked(self):
        """The pieces' and the replicas' trees in the stacked structure."""
        return (pr.stack_tree(self.params),
                *(pr.stack_tree(m.tree()) for m in self.models))

    def _blocks(self, leaf, q_block: int) -> sh.Placement:
        nb = -(-math.prod(pr.stacked_shape(leaf)) // q_block)
        return sh.blocks_placement(self.shd, nb, q_block)

    def _run(self, n: int, pl: sh.Placement, nb: int, q_block: int,
             n_el: int) -> tuple[int, int]:
        """Device ``n``'s run ``[lo, hi)`` of a flat stacked leaf of
        ``n_el`` elements in ``nb`` blocks placed by ``pl``."""
        bs = pl.block(n, (nb, q_block))[0]
        return bs.start * q_block, min(bs.stop * q_block, n_el)

    def flat_params(self, q_block: int) -> dict:
        """The parameters as AdamW takes them beside 8-bit moments: the
        stacked tree, each leaf a ``Sharded`` over its moments' block
        placement.  With a model axis of 1 its piece ``n`` is replica
        ``n``'s per-layer tensors of the leaf (device ``n``'s whole copy,
        refilled by :meth:`gather`; no copy is made), and :meth:`exchange`
        puts the new values into the pieces.  Above 1 it is a
        :class:`FlatRun` of device ``n``'s run of blocks, which reads them
        from its data replica's model blocks (an all-gather over
        ``model`` where the leaf is cut over it) and writes the new values
        straight into the parameter pieces (the exchange, an all-to-all
        over ``data`` where the blocks are cut over it)."""
        if self.blocks is None:
            return pr.stacked_map(
                lambda x, *reps: sh.Sharded(
                    self._blocks(x, q_block),
                    [r if isinstance(r, list) else [r] for r in reps],
                    pr.stacked_shape(x)), *self._stacked())

        def one(x, regions, *reps):
            pl, shape = self._blocks(x, q_block), pr.stacked_shape(x)
            nb, n_el = -(-math.prod(shape) // q_block), math.prod(shape)
            cut = sh.data_cut(pl) > 1
            runs = [FlatRun(self, n, x, regions, reps,
                            self._run(n, pl, nb, q_block, n_el), cut)
                    for n in range(len(self.devices))]
            first = runs[0]
            if first.cut:
                self._count("all-gather", (first.hi - first.lo) *
                            first.dtype.itemsize)
            if cut:
                for xi in first.layers:
                    self._count("all-to-all", xi.pieces[0].numel() *
                                xi.pieces[0].element_size())
            return sh.Sharded(pl, runs, shape)
        return pr.stacked_map(one, pr.stack_tree(self.params),
                              pr.stack_tree(self.blocks),
                              *(pr.stack_tree(x.tree()) for x in self.models))

    @torch.no_grad()
    def exchange(self, flat: dict, q_block: int) -> None:
        """After AdamW's update of :meth:`flat_params` (a model axis of
        1): copy each device's blocks' new elements from its replica into
        the parameter pieces that hold them (an all-to-all; where the
        blocks are replicated, each piece from its own device's copy)."""
        def one(x, fp):
            parts = x if isinstance(x, list) else [x]
            pl, layer_n = fp.placement, math.prod(parts[0].shape)
            nb = -(-math.prod(fp.shape) // q_block)
            cut = sh.data_cut(pl) > 1
            for i, xi in enumerate(parts):
                for m, dst in enumerate(xi.pieces):
                    block = xi.placement.block(m, xi.shape)
                    for n in (range(len(self.devices)) if cut else (m,)):
                        bs = pl.block(n, (nb, q_block))[0]
                        lo = max(bs.start * q_block - i * layer_n, 0)
                        hi = min(bs.stop * q_block - i * layer_n, layer_n)
                        if lo < hi:
                            copy_flat_range(dst, fp.pieces[n][i], block,
                                            lo, hi)
                if cut:
                    self._count("all-to-all", xi.pieces[0].numel() *
                                xi.pieces[0].element_size())
        pr.stacked_map(one, pr.stack_tree(self.params), flat)

    def rows(self, batch: dict, lo: int, hi: int):
        """Rows ``[lo, hi)`` of the global batch for each data replica ->
        (one dict per replica, on its (lead) device; split).  ``split``:
        the data axis divides the rows and replica ``r`` takes its
        ``r``-th share; otherwise every replica takes them all."""
        k, m, n = self.data, self.model, hi - lo
        split = n % k == 0
        out = []
        for r, dev in enumerate(self.devices[::m]):
            a, b = (lo + r * n // k, lo + (r + 1) * n // k) if split \
                else (lo, hi)
            one = {}
            for key, x in batch.items():
                if x.placement.spec[0] is None:       # a replicated batch
                    one[key] = x.pieces[r * m][a:b]
                else:
                    per = x.shape[0] // k
                    one[key] = sh.take_rows(x.pieces[::m],
                                            range(0, k * per, per), a, b,
                                            dev)
            out.append(one)
        return out, split

    @torch.no_grad()
    def reduce_scatter(self, split: bool, into=None,
                       q_block: int | None = None):
        """The replicas' gradients onto the pieces, in float32: piece ``n``
        sums every replica's gradient over its block (``split``), or takes
        replica ``n``'s own (a replicated batch).  Each leaf's gradients
        are dropped once its pieces are made.  Returns the gradient tree
        of ``Sharded`` pieces, or adds it into ``into``.  With ``q_block``
        (8-bit moments) the tree is the stacked one and each piece holds
        its device's run of ``(nblocks, q_block)`` blocks of the flat
        stacked gradient (zero past its end): with a model axis above 1,
        summed over ``data`` and assembled from its data replica's model
        pieces (an all-gather over ``model`` where the leaf is cut over
        it, an all-reduce where several pieces computed with a whole
        leaf)."""
        def count(pl, numel):
            if split and self.data > 1:
                self._count("reduce-scatter" if sh.data_cut(pl) > 1
                            else "all-reduce", numel * 4)

        def one(x, *ps, blocks=None):
            m, pieces = self.model, []
            for n, dev in enumerate(self.devices):
                sl = x.placement.block(n, x.shape)
                acc = None
                for i in (range(self.data) if split else (n // m,)):
                    for j in range(m):
                        p = ps[i * m + j]
                        region = self._region(i * m + j, blocks, x.shape)
                        if p.grad is None or (
                                region is not None and
                                not sh.inside(sl, region)):
                            continue
                        g = p.grad[sl if region is None else
                                   sh.relative(sl, region)]
                        g = g.to(dev, torch.float32).contiguous()
                        acc = g if acc is None else acc + g
                if acc is None:                # the loss does not reach it
                    acc = torch.zeros(x.pieces[n].shape, dtype=torch.float32,
                                      device=dev)
                pieces.append(acc)
            if blocks is not None and not sh.axes_of(blocks) and sum(
                    p.grad is not None for p in ps[:m]) > 1:
                # a leaf whole in every model piece, computed with by several
                self._count("all-reduce", math.prod(x.shape) * 4)
            for p in ps:
                p.grad = None
            count(x.placement, pieces[0].numel())
            return sh.Sharded(x.placement, pieces, x.shape)

        def flat(x, *reps, regions=None):
            pl = self._blocks(x, q_block)
            parts = [r if isinstance(r, list) else [r] for r in reps]
            n_el, pieces = math.prod(pr.stacked_shape(x)), []
            nb, m = -(-n_el // q_block), self.model
            layer = tuple((x[0] if isinstance(x, list) else x).shape)
            layer_n = math.prod(layer)
            for n, dev in enumerate(self.devices):
                lo, hi = self._run(n, pl, nb, q_block, n_el)
                acc = torch.zeros((-(-(hi - lo) // q_block), q_block),
                                  dtype=torch.float32, device=dev)
                run = acc.view(-1)[:hi - lo]
                if regions is None:
                    for r in (range(len(parts)) if split else (n,)):
                        g = adamw.read_range(_layer_grads(parts[r]), lo, hi)
                        run.add_(g.to(dev, torch.float32))
                for r in (() if regions is None else
                          range(len(parts)) if split else
                          range(n - n % m, n - n % m + m)):
                    for i in _layer_span(lo, hi, layer_n, len(parts[r])):
                        p = parts[r][i]
                        if p.grad is not None:
                            _into_run(run, lo - i * layer_n, layer, p.grad,
                                      regions[i].block(r, layer),
                                      max(lo - i * layer_n, 0),
                                      min(hi - i * layer_n, layer_n), True)
                pieces.append(acc)
            if regions is not None:
                if sh.axes_of(regions[0]):
                    self._count("all-gather", pieces[0].numel() * 4)
                elif sum(parts[j][0].grad is not None for j in range(m)) > 1:
                    self._count("all-reduce", pieces[0].numel() * 4)
            for ps in parts:
                for p in ps:
                    p.grad = None
            count(pl, pieces[0].numel())
            return sh.Sharded(pl, pieces, (nb, q_block))

        if q_block is None and self.blocks is not None:
            g = pr.tree_map(lambda x, b, *ps: one(x, *ps, blocks=b),
                            self.params, self.blocks,
                            *(m.tree() for m in self.models))
        elif q_block is None:
            g = pr.tree_map(one, self.params,
                            *(m.tree() for m in self.models))
        elif self.blocks is None:
            g = pr.stacked_map(flat, *self._stacked())
        else:
            g = pr.stacked_map(
                lambda x, b, *reps: flat(
                    x, *reps, regions=b if isinstance(b, list) else [b]),
                pr.stack_tree(self.params), pr.stack_tree(self.blocks),
                *self._stacked()[1:])
        if into is not None:
            pr.tree_map(lambda acc, x: [a.add_(b) for a, b in
                                        zip(acc.pieces, x.pieces)], into, g)
        return g if into is None else into

    def zero_grads(self, q_block: int | None = None):
        """Float32 zeros in :meth:`reduce_scatter`'s layout, to sum
        microbatches into."""
        def zeros(x):
            return sh.Sharded(x.placement, [
                torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in x.pieces], x.shape)

        def flat(x):
            nb = -(-math.prod(pr.stacked_shape(x)) // q_block)
            pl = self._blocks(x, q_block)
            pieces = []
            for n, dev in enumerate(self.devices):
                bs = pl.block(n, (nb, q_block))[0]
                pieces.append(torch.zeros((bs.stop - bs.start, q_block),
                                          dtype=torch.float32, device=dev))
            return sh.Sharded(pl, pieces, (nb, q_block))
        if q_block is None:
            return pr.tree_map(zeros, self.params)
        return pr.stacked_map(flat, pr.stack_tree(self.params))


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
    q = opt_cfg.q_block if opt_cfg.quantize_moments else None

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
            g = dp.zero_grads(q)
            loss = torch.zeros((), dtype=torch.float32,
                               device=dp.devices[0])
            for i in range(microbatches):
                mbs, split = dp.rows(batch, i * n // microbatches,
                                     (i + 1) * n // microbatches)
                l, mb_metrics = _replica_loss(dp.replicas, cfg, mbs, split)
                l.backward()
                dp.reduce_scatter(split, into=g, q_block=q)
                loss += mb_metrics["loss"]
            g = pr.tree_map(lambda x: sh.Sharded(
                x.placement, [p / microbatches for p in x.pieces], x.shape),
                g)
            metrics = {"loss": loss / microbatches}
        else:
            mbs, split = dp.rows(batch, 0, n)
            l, metrics = _replica_loss(dp.replicas, cfg, mbs, split)
            l.backward()
            g = dp.reduce_scatter(split, q_block=q)
        params = dp.params if q is None else dp.flat_params(q)
        opt_state, opt_metrics = adamw.update(params, g, opt_state, opt_cfg)
        if q is not None and dp.blocks is None:
            dp.exchange(params, q)
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
    ``"cuda"``, which raises where torch sees no CUDA device), or over
    ``mesh`` with ``rules`` (by default ``default_rules(mesh)``; ignored
    without a mesh, as in the reference): data parallel over ``data``,
    and tensor and expert parallel over ``model`` (see the module
    docstring).  A mesh of one device (what ``make_local_mesh()`` gives
    on a one-card machine) trains on the single-device step, as
    ``mesh=None`` on that device: no pieces, no replica, no
    collective."""

    def __init__(self, model_cfg, tc: TrainConfig, mesh=None, rules=None,
                 device="cuda"):
        lm.check_family(model_cfg)
        self.shd = None
        if mesh is not None:
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
        opt_state = adamw.init(state.tree(), tc.opt, shd=self.shd)
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
            state.whole()
        return {"params": model, "opt": opt_state,
                "metrics": self.metrics_log,
                "stragglers": self.straggler_steps,
                "data_parallel": None if state is model else state}
