"""Multi-pod dry run: reckon every (arch x shape x mesh) cell's share of a
device, the port's counterpart of the JAX package's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Results land in ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``
(``__<variant>`` appended for a variant; cached, ``--force`` recomputes).
Nothing here touches a device: the placements' bytes come from ``meta``
tensors (``params.abstract_init``, ``lm.init_cache``), the trace runs on
fake CPU tensors, and the mesh is its shape alone
(``mesh.production_mesh``: 16 x 16 ``("data", "model")``, or 2 x 16 x 16
with ``"pod"``).

A cell traces the port's own step (``step_analysis.analyze_step``): the
train step (loss, backward, AdamW), ``engine.prefill`` or
``lm.decode_step`` at the last slot of a full cache.  On a mesh whose
model axis is 1 that is the single-device step at the cell's global
shape.  Above 1 it is one device's tensor-parallel program: one data
replica's model pieces (``tensor_parallel.ModelPieces``, each on a fake
device of its own, :class:`TraceMesh`) at the replica's rows (the global
batch over the data axes where they divide it), the train step as
``train.loop.DataParallel`` runs it (loss and backward over the pieces,
the gradients' assembly, each piece's AdamW update of what its device
holds).  What it records:

* ``devices``, ``seq_len``, ``global_batch``, ``kind``, ``trace_s``;
* ``memory``: ``argument_bytes``, one device's pieces of the step's
  arguments under the rules (``Shd.spec`` with its divisibility fallback:
  parameters, AdamW state (float32 moments placed as their parameters,
  8-bit moments by ``sharding.blocks_placement``), batch, or cache, token
  and position), split out in ``arguments``; ``output_bytes``, the same
  for the outputs (new parameters and state and the metrics; the cache and
  the last logits); ``temp_bytes``, the traced step's peak of live bytes
  beside its arguments, per device by the rule below;
* ``cost``: ``flops`` and ``bytes_accessed`` per device, and ``analysis``
  (``flops``, ``memory_bytes``, ``collectives``), the keys of the
  reference's ``analyze_hlo``;
* ``collectives``: per device, ``step_analysis.reckon_collectives`` on
  the cell's placements (the data axes': the all-gather of every FSDP
  piece; for a train step the gradients' reduce-scatter and, under
  ``opt_8bit``, the flat reduce-scatter and the all-to-all), plus on a
  model axis above 1 the model axis's, counted by the traced program's
  own hooks (``tensor_parallel.Group.count``: the sums and gathers of
  the pieces, and the gradients' assembly over them) as
  ``DataParallel`` and ``ModelPieces`` count them; without ``trace``
  the data axes' alone;
* ``traced``: the whole trace's numbers, and the divisor (model axis 1)
  or each traced device's numbers, ``model_collectives`` and
  ``mesh_flops`` (above 1).

**Per-device rule.**  On a model axis of 1 a device's flops, bytes
accessed and temporaries are the single-device step's divided by the
product of the data-parallel axes (``pod``, ``data``) where they divide
the global batch (else 1: the batch is replicated, as
``batch_sharding`` falls back).  Above 1 they are device ``(0, 0)``'s:
the ops the trace ran on model piece 0's fake device (the lead's, which
also holds the activations between the layers' pieces and the sums over
them).  Every data replica runs the same program, so one is traced,
unless an MoE layer's dispatch groups (the global batch's) do not fall
on the replicas' rows; then every replica is traced
(:func:`traced_replicas`).  Tracing 16 pieces costs up to 16 times the
single-device trace's ops, so a model deeper than :data:`TRACE_LAYERS`
whose layers repeat is traced at two cut depths a period apart and
extrapolated (:func:`trace_depths`: flops, bytes accessed, device 0's
peak of temporaries and the collectives as the whole trace gives them,
but for the rounding of the 8-bit update's chunks and blocks), and
``--jobs N`` traces ``N`` cells at once, each in a process of its own.

Keys of the reference with no PyTorch meaning are left out, not written
as 0: ``compile_s``, ``generated_code_bytes``, ``hlo_ops``, and the
``transcendentals`` of XLA's cost analysis.  A cell that raises records
``status: "error"`` with the message, as the reference does.  The
``embed_psum`` variants trace the gather lookup: the port's psum lookup
splits the table onto the mesh's devices, which a mesh shape has none of.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import functools
import json
import math
import multiprocessing
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.data.pipeline import batch_struct
from repro_torch.launch import sharding as sh
from repro_torch.launch import step_analysis as sa
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.mesh import dp_axes, production_mesh
from repro_torch.models import lm
from repro_torch.models import moe
from repro_torch.models import params as pr
from repro_torch.optim import adamw
from repro_torch.serve import engine
from repro_torch.train import loop

MESHES = ("pod", "multipod")

# ---- the reference's hillclimb variants: named sets of config / rules /
# optimizer overrides applied on top of the baseline
VARIANTS = {
    "baseline": {},
    "embed_psum": {"cfg": {"decode_embed": "psum"}},
    "remat_dots": {"cfg": {"remat": "dots"}},
    "remat_none": {"cfg": {"remat": "none"}},
    "seq_par": {"rules": {"embed_act": "model"}},
    "moe_group_32k": {"cfg": {"moe_group_size": 32768}},
    "moe_group_2k": {"cfg": {"moe_group_size": 2048}},
    "cap_10": {"cfg": {"capacity_factor": 1.0}},
    "opt_8bit": {"opt": {"quantize_moments": True}},
    "router_rep": {"rules": {"router_experts": None}},
    # serving rules: params pure-TP (no FSDP): weights stay resident, no
    # per-step parameter all-gather; only valid for inference shapes
    "serve_tp": {"rules": {"embed": None}},
    "serve_tp_psum": {"rules": {"embed": None},
                      "cfg": {"decode_embed": "psum"}},
}


def should_skip(arch: str, shape_name: str) -> str | None:
    cfg = get_config(arch)
    if shape_name == "long_500k":
        if not cfg.sub_quadratic:
            return ("pure full-attention arch: no sub-quadratic path at "
                    "524k context (DESIGN.md §Arch-applicability)")
        if cfg.family == "encdec":
            return "whisper decoder context is 448 by construction"
    return None


def _bytes(items) -> int:
    """One device's bytes of ``(shape, dtype, placement)`` items."""
    return sum(sa.piece_numel(pl, shape) *
               torch.empty((), dtype=dt).element_size()
               for shape, dt, pl in items)


def _moment_items(shd, leaves, opt_cfg) -> list:
    items = []
    for shape, _, dtype, axes in leaves:
        if opt_cfg.quantize_moments:
            nb = -(-math.prod(shape) // opt_cfg.q_block)
            pl = sh.blocks_placement(shd, nb, opt_cfg.q_block)
            items += [((nb, opt_cfg.q_block), torch.int8, pl),
                      ((nb, 1), torch.float32, pl)]
        else:
            items.append((shape, torch.float32, shd.named(axes, shape)))
    return 2 * items


def _batch(cfg, b: int, s: int, kind: str, device="cpu") -> dict:
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in batch_struct(cfg, b, s).items()
            if kind == "train" or k not in ("labels", "loss_mask")}


def abstract_state(cfg, kind: str, shape: dict, mesh, rules,
                   opt_over: dict | None = None) -> dict:
    """The cell, allocating nothing: ``arguments`` / ``outputs``
    (``(shape, dtype, placement)`` items by part, from the ``meta``
    parameters of ``params.abstract_init`` and the shapes of the batch and
    cache), ``leaves`` (``step_analysis.stacked_leaves`` of the
    parameters), ``shd``, ``q_block`` (8-bit moments) and ``build``, which
    makes the step's inputs inside ``step_analysis.analyze_step``'s fake
    mode and returns ``(step, arguments)``."""
    shd = sh.Shd(mesh, rules)
    values, axes = pr.abstract_init(cfg)
    leaves = sa.stacked_leaves(values, axes)
    pieces = tp.model_axis(mesh) > 1
    params = [(s_, dt, shd.named(ax, s_)) for s_, _, dt, ax in leaves]
    b, s = shape["global_batch"], shape["seq_len"]
    scalar = [((), torch.int32, shd.named(()))]
    batch = _batch(cfg, b, s, kind, "meta")
    out = {"shd": shd, "leaves": leaves, "q_block": None,
           "values": values, "axes": axes,
           "held": {"counted": tp.zero_collectives(), "several": None}}

    def model():
        return lm.init_model(cfg, device="cpu")

    if kind == "train":
        opt_cfg = adamw.AdamWConfig(**(opt_over or {}))
        opt = scalar + _moment_items(shd, leaves, opt_cfg)

        def build():
            if pieces:
                return _group_train(cfg, shape, shd, opt_cfg, out["held"])
            m, data = model(), _batch(cfg, b, s, kind)
            state = adamw.init(m.tree(), opt_cfg)
            step_fn = loop.make_train_step(cfg, opt_cfg)
            return (lambda: step_fn(m, state, data),
                    list(m.parameters()) + sa._tensors((data, state)))
        out.update(
            build=build,
            arguments={"params": params, "opt": opt,
                       "batch": _batch_items(shd, batch)},
            outputs={"params": params, "opt": opt,
                     # the step's scalars: loss, nll, z_loss, grad norm,
                     # lr, and for MoE the router's two
                     "metrics": scalar * (7 if cfg.family == "moe" else 5)},
            q_block=opt_cfg.q_block if opt_cfg.quantize_moments else None)
        return out

    max_len = s + (lm.prefix_slots(cfg) if kind == "prefill" else 0)
    cache = lm.init_cache(cfg, b, max_len, device="meta")
    cache_items = [(tuple(t.shape), t.dtype,
                    shd.named(lm.CACHE_AXES[k], tuple(t.shape)))
                   for k, t in sorted(cache.items())]
    logits = [((b, 1, cfg.vocab_size), cfg.compute_dtype,
               shd.named(("batch", None, "vocab"), (b, 1, cfg.vocab_size)))]
    out["outputs"] = {"cache": cache_items, "logits": logits}
    if kind == "prefill":
        def build():
            if pieces:
                return _group_serve(cfg, kind, shape, shd, out["held"])
            m, data = model(), _batch(cfg, b, s, kind)

            def step():
                with torch.no_grad():
                    return engine.prefill(m, cfg, data, max_len=max_len)
            return step, list(m.parameters()) + sa._tensors(data)
        out.update(build=build, arguments={
            "params": params, "batch": _batch_items(shd, batch)})
        return out

    if kind == "decode":
        def build():
            if pieces:
                return _group_serve(cfg, kind, shape, shd, out["held"])
            m = model()
            c = lm.init_cache(cfg, b, s, device="cpu")
            tokens = torch.zeros((b, 1), dtype=torch.int32)

            def step():
                with torch.no_grad():
                    return lm.decode_step(m, cfg, c, tokens, s - 1,
                                          prefix_len=lm.prefix_slots(cfg))
            return step, list(m.parameters()) + sa._tensors((c, tokens))
        tok = [((b, 1), torch.int32, shd.named(("batch", None), (b, 1)))]
        out.update(build=build, arguments={
            "params": params, "cache": cache_items, "tokens": tok + scalar})
        return out
    raise ValueError(kind)


# ------------------------------------------- one device's program over pieces
@dataclasses.dataclass(frozen=True)
class TraceMesh:
    """The devices a trace of one data replica's tensor-parallel program
    runs on: the mesh's axes with its data axes cut to ``replicas`` (on
    the last of them), each device a fake CPU device of its own
    (``cpu:n``, row-major), so that every traced op falls to the piece
    whose tensors it reads."""

    axis_names: tuple
    sizes: tuple
    devices: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def trace_mesh(mesh, replicas: int) -> TraceMesh:
    last = dp_axes(mesh)[-1]
    sizes = tuple(replicas if a == last else 1 if a in dp_axes(mesh)
                  else mesh.shape[a] for a in mesh.axis_names)
    return TraceMesh(tuple(mesh.axis_names), sizes, tuple(
        torch.device("cpu", n) for n in range(math.prod(sizes))))


def traced_replicas(cfg, kind: str, b: int, s: int, dp: int) -> int:
    """The data replicas a trace runs: one, which every replica's program
    equals, unless an MoE layer's dispatch groups (the global batch's)
    do not fall on the replicas' rows, so that replica 0 dispatches rows
    of others; then all of them."""
    split = b % dp == 0
    if cfg.family != "moe" or dp == 1 or (kind == "train" and not split):
        return 1
    t = b * (1 if kind == "decode" else s)
    tg = t // moe._group_count(t, cfg.moe_group_size)
    mine = t // dp
    if split and mine % tg == 0 and \
            moe._group_count(mine, cfg.moe_group_size) * tg == mine:
        return 1
    return dp


def _pieces(cfg, kind: str, shape: dict, shd):
    """The model pieces of the traced replicas on their fake devices ->
    (``ModelPieces``, the whole model's per-layer values, each replica's
    rows, whether the data axes split the batch)."""
    b, s = shape["global_batch"], shape["seq_len"]
    dp = math.prod(shd.mesh.shape[a] for a in dp_axes(shd.mesh))
    k = traced_replicas(cfg, kind, b, s, dp)
    split = b % dp == 0
    whole = lm.init_model(cfg, device="cpu")
    mp = tp.ModelPieces(whole, sh.Shd(trace_mesh(shd.mesh, k), shd.rules))
    return mp, whole, (b // dp * k if split else b), split


def _counted(mp, counted: dict) -> None:
    for kind, v in mp.collectives.items():
        counted[kind] = dict(v)


def _several(mp) -> list:
    """Per stacked leaf, keys sorted: whether several of data replica 0's
    pieces computed with it (the traced backward left them a gradient)."""
    stacked = [pr.stack_tree(t) for t in mp.groups[0].trees]
    out = []
    for parts in zip(*(pr.leaves_like(st, st) for st in stacked)):
        out.append(sum((p[0] if isinstance(p, list) else p).grad is not None
                       for p in parts) > 1)
    return out


def assembly_collectives(shd, values, axes, opt_cfg, several) -> dict:
    """The model axis's sums of a train step's gradient assembly on
    device 0, as ``DataParallel.reduce_scatter`` (and, with 8-bit
    moments, ``flat_params``) counts them: float32 moments, an all-reduce
    of each layer of a leaf whole in every piece that ``several`` pieces
    compute with; 8-bit, per stacked leaf cut over ``model`` the
    all-gathers of device 0's float32 gradient run and parameter run,
    per leaf whole that several pieces compute with the all-reduce of its
    gradient run."""
    out = tp.zero_collectives()
    stacked = pr.stack_tree(values)
    blocks = pr.stack_tree(tp.piece_placements(shd, axes, values))
    q = opt_cfg.q_block if opt_cfg.quantize_moments else None
    for x, pl, many in zip(pr.leaves_like(stacked, stacked),
                           pr.leaves_like(stacked, blocks), several):
        pls = pl if isinstance(pl, list) else [pl]
        cut = bool(sh.axes_of(pls[0]))
        first = x[0] if isinstance(x, list) else x
        if q is None:
            if not cut and many:
                for _ in pls:
                    tp.count_into(out, "all-reduce",
                                  math.prod(first.shape) * 4)
            continue
        n_el = math.prod(pr.stacked_shape(x))
        nb = -(-n_el // q)
        acc = sa.piece_numel(sh.blocks_placement(shd, nb, q), (nb, q))
        if cut:
            tp.count_into(out, "all-gather", acc * 4)
            tp.count_into(out, "all-gather",
                          min(acc, n_el) * first.element_size())
        elif many:
            tp.count_into(out, "all-reduce", acc * 4)
    return out


class _TracedRun:
    """A device's run of a flat stacked leaf as AdamW reads and writes it
    over model pieces (``train.loop.FlatRun``): a chunk read is a new
    tensor, a chunk written is cast to the parameters' dtype."""

    def __init__(self, n: int, dtype, device):
        self.n, self.dtype, self.device = n, dtype, device

    def numel(self) -> int:
        return self.n

    def read(self, a: int, b: int) -> torch.Tensor:
        return torch.zeros(b - a, dtype=self.dtype, device=self.device)

    def write(self, a: int, b: int, values: torch.Tensor) -> None:
        values.to(self.dtype)


def _device_update(shd, values, axes, opt_cfg, j: int, dev):
    """Device ``j`` of data replica 0's part of the AdamW update: ->
    (its parameter tree, its state, a function making its parameters and
    gradients).  Float32 moments: its pieces of every leaf, cut over
    ``data`` and ``model``.  8-bit: its run of each flat stacked leaf,
    read and written in chunks (:class:`_TracedRun`)."""
    stacked = pr.stack_tree(values)
    if not opt_cfg.quantize_moments:
        pls = sh.per_layer(sh.params_shardings(shd, axes, stacked), values)
        tree = pr.tree_map(lambda t, pl: torch.empty(
            tuple(x.stop - x.start for x in pl.block(j, t.shape)),
            dtype=t.dtype, device=dev), values, pls)
        return tree, adamw.init(tree, opt_cfg), lambda: (tree, pr.tree_map(
            lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                  device=dev), tree))
    q, runs = opt_cfg.q_block, {}
    for i, leaf in enumerate(pr.leaves_like(stacked, stacked)):
        n_el = math.prod(pr.stacked_shape(leaf))
        nb = -(-n_el // q)
        bs = sh.blocks_placement(shd, nb, q).block(j, (nb, q))[0]
        first = leaf[0] if isinstance(leaf, list) else leaf
        runs[str(i)] = (min(bs.stop * q, n_el) - bs.start * q, first.dtype)
    tree = {k: torch.empty(n, dtype=dt, device=dev)
            for k, (n, dt) in runs.items()}
    state = adamw.init(tree, opt_cfg)

    def make():
        return ({k: _TracedRun(n, dt, dev) for k, (n, dt) in runs.items()},
                {k: torch.zeros(n, dtype=torch.float32, device=dev)
                 for k, (n, _) in runs.items()})
    return None, state, make


def _group_train(cfg, shape: dict, shd, opt_cfg, held: dict):
    """One data replica's train step over its model pieces (as
    ``train.loop.DataParallel`` runs it): the loss and backward over the
    pieces at the replica's rows (which leaves several pieces computed
    with, for the assembly's sums, kept in ``held``), then each model
    piece's AdamW update of what device ``(0, j)`` holds."""
    mp, whole, rows, split = _pieces(cfg, "train", shape, shd)
    values = whole.tree()
    params = sa._tensors([g.trees for g in mp.groups])
    for t in params:
        t.requires_grad_(True)
    k = len(mp.groups)
    data = _batch(cfg, rows, shape["seq_len"], "train", mp.groups[0].devices[0])
    batches = [{key: v[r * rows // k:(r + 1) * rows // k].to(g.devices[0])
                for key, v in data.items()} if split else
               {key: v.to(g.devices[0]) for key, v in data.items()}
               for r, g in enumerate(mp.groups)]
    updates = [_device_update(shd, values, whole.axes, opt_cfg, j, dev)
               for j, dev in enumerate(mp.groups[0].devices)]

    def step():
        loss, _ = loop._replica_loss(mp.groups, cfg, batches, split)
        loss.backward()
        held["several"] = _several(mp)
        for t in params:
            t.grad = None
        for _, state, make in updates:
            adamw.update(*make(), state, opt_cfg)
        _counted(mp, held["counted"])
    return step, params + sa._tensors((data, batches, [
        (tree, state) for tree, state, _ in updates]))


def _group_serve(cfg, kind: str, shape: dict, shd, held: dict):
    """One data replica's prefill (``engine.prefill``) or decode step
    (``lm.decode_step`` at the last slot of a full cache) over its model
    pieces, at the replica's rows."""
    mp, _, rows, _ = _pieces(cfg, kind, shape, shd)
    s, lead = shape["seq_len"], mp.groups[0].devices[0]
    params = sa._tensors([g.trees for g in mp.groups])
    if kind == "prefill":
        data = _batch(cfg, rows, s, kind, lead)
        max_len = s + lm.prefix_slots(cfg)

        def step():
            with torch.no_grad():
                engine.prefill(mp, cfg, data, max_len=max_len)
            _counted(mp, held["counted"])
        return step, params + sa._tensors(data)
    cache = lm.init_cache_pieces(mp, rows, s)
    tokens = torch.zeros((rows, 1), dtype=torch.int32, device=lead)

    def step():
        with torch.no_grad():
            lm.decode_step(mp, cfg, cache, tokens, s - 1,
                           prefix_len=lm.prefix_slots(cfg))
        _counted(mp, held["counted"])
    return step, params + sa._tensors((cache, tokens))


def _batch_items(shd, batch) -> list:
    placements = sh.batch_sharding(shd, batch)
    return [(tuple(v.shape), v.dtype, placements[k])
            for k, v in sorted(batch.items())]


def reckon(cfg, kind: str, shape: dict, mesh, rules,
           opt_over: dict | None = None, trace: bool = True) -> dict:
    """A cell's record fields (see the module docstring) for any mesh
    with ``shape`` and ``axis_names`` (a ``ShardMesh`` too): the
    placements' bytes and collectives, and with ``trace`` the traced
    step's per-device cost."""
    st = abstract_state(cfg, kind, shape, mesh, rules, opt_over)
    b = shape["global_batch"]
    dp = math.prod(mesh.shape[a] for a in dp_axes(mesh))
    split = b % dp == 0          # else the batch is replicated
    coll = sa.reckon_collectives(st["shd"], st["leaves"], kind,
                                 q_block=st["q_block"], split=split)
    args = {k: _bytes(v) for k, v in st["arguments"].items()}
    rec = dict(
        devices=math.prod(mesh.shape.values()), seq_len=shape["seq_len"],
        global_batch=b, kind=kind,
        memory={"argument_bytes": sum(args.values()),
                "output_bytes": sum(_bytes(v)
                                    for v in st["outputs"].values())},
        arguments=args, collectives=coll)
    if not trace:
        return rec
    if tp.model_axis(mesh) > 1:
        return _group_record(rec, trace_pieces(cfg, kind, shape, mesh,
                                               rules, opt_over))
    t0 = time.time()
    res = sa.analyze_step(st["build"])
    traced = {k: res[k] for k in ("flops", "memory_bytes", "peak_bytes")}
    traced["trace_s"] = round(time.time() - t0, 2)
    # the per-device rule (see the module docstring)
    div = (dp if split else 1) * mesh.shape.get("model", 1)
    per = {k: traced[k] // div for k in ("flops", "memory_bytes",
                                         "peak_bytes")}
    rec["memory"]["temp_bytes"] = per["peak_bytes"]
    rec.update(trace_s=traced["trace_s"],
               cost={"flops": per["flops"],
                     "bytes_accessed": per["memory_bytes"]},
               analysis={"flops": per["flops"],
                         "memory_bytes": per["memory_bytes"],
                         "collectives": coll},
               traced=dict(traced, divisor=div))
    return rec


TRACE_LAYERS = 8     # deeper models are traced at two cut depths


def _cut(cfg, layers: int):
    cfg = cfg.replace(num_layers=layers)
    return cfg.replace(enc_layers=layers) if cfg.family == "encdec" else cfg


def _signature(cfg) -> list:
    """Each layer's kind and whether the hybrid shared block follows it."""
    kinds = lm.layer_kinds(cfg)
    return [(int(kinds[i]), lm.shared_after(cfg, i))
            for i in range(cfg.num_layers)]


def trace_depths(cfg):
    """Where a model is deeper than :data:`TRACE_LAYERS` and its layers
    repeat with a period ``P`` (their kinds, the hybrid shared block; an
    encoder-decoder's encoder as deep as its decoder, the two cut
    together): ``(d1, d2, periods)``, two cut depths ``R + P`` and ``R +
    2 P`` (``R`` the layers past the last whole period; a period more
    where that leaves one layer, so that a stacked leaf's update reads
    several layers at both) whose layers are the model's first, and the
    periods the whole model has beyond ``d1``.  Else None: the model is
    traced whole."""
    n = cfg.num_layers
    if n <= TRACE_LAYERS or (cfg.family == "encdec" and
                             cfg.enc_layers != n):
        return None
    sig = _signature(cfg)
    period = next(p for p in range(1, n + 1)
                  if all(sig[i] == sig[i % p] for i in range(n)))
    d1 = n % period + period
    d1 += period if d1 == 1 else 0
    d2 = d1 + period
    if d2 >= n or any(_signature(_cut(cfg, d)) != sig[:d] for d in (d1, d2)):
        return None
    return d1, d2, (n - d1) // period


def _extrapolate(a, b, periods: int):
    """``a + periods (b - a)`` through dicts of numbers (a key one side
    lacks is 0 there)."""
    if isinstance(a, dict) or isinstance(b, dict):
        a, b = a or {}, b or {}
        return {k: _extrapolate(a.get(k), b.get(k), periods)
                for k in sorted(set(a) | set(b))}
    a, b = a or 0, b or 0
    return a + periods * (b - a)


def trace_pieces(cfg, kind: str, shape: dict, mesh, rules,
                 opt_over: dict | None = None) -> dict:
    """The ``traced`` fields of a cell on a model axis above 1: one data
    replica's program over its pieces traced (:func:`analyze_step
    <repro_torch.launch.step_analysis.analyze_step>`), whole or, for a
    deep model (:func:`trace_depths`), at two cut depths and extrapolated
    by its periods: the flops and bytes accessed in all and each traced
    device's (its peak of temporaries too), the model
    axis's collectives (the program's, and for a train step the
    gradients' assembly at the model's own depth) and ``mesh_flops``, the
    flops of every device of the mesh (the traced replicas' times the
    replicas they stand for)."""
    depths = trace_depths(cfg)
    runs, t0 = [], time.time()
    for c in [cfg] if depths is None else [_cut(cfg, d) for d in depths[:2]]:
        st = abstract_state(c, kind, shape, mesh, rules, opt_over)
        res = sa.analyze_step(st["build"])
        res["model_collectives"] = st["held"]["counted"]
        runs.append((res, st["held"]["several"]))
    keys = ("flops", "memory_bytes", "devices", "model_collectives")
    traced = {k: runs[0][0][k] for k in keys}
    if depths is not None:
        traced = {k: _extrapolate(runs[0][0][k], runs[1][0][k], depths[2])
                  for k in keys}
        traced["depths"] = list(depths[:2])
    if kind == "train":
        st = abstract_state(cfg, kind, shape, mesh, rules, opt_over)
        more = assembly_collectives(st["shd"], st["values"], st["axes"],
                                    adamw.AdamWConfig(**(opt_over or {})),
                                    runs[0][1])
        for c, v in more.items():
            traced["model_collectives"][c]["count"] += v["count"]
            traced["model_collectives"][c]["bytes"] += v["bytes"]
    dp = math.prod(mesh.shape[a] for a in dp_axes(mesh))
    k = traced_replicas(cfg, kind, shape["global_batch"], shape["seq_len"],
                        dp)
    traced.update(replicas=k, mesh_flops=traced["flops"] * dp // k,
                  trace_s=round(time.time() - t0, 2))
    return traced


def _group_record(rec, traced) -> dict:
    """:func:`reckon`'s traced fields on a model axis above 1 from
    :func:`trace_pieces`: device ``(0, 0)``'s (``cpu:0`` of the trace)
    flops, bytes accessed and peak of temporaries; the model axis's
    collectives added to the data axes'."""
    coll = rec["collectives"]
    for kind, v in traced["model_collectives"].items():
        coll[kind]["count"] += v["count"]
        coll[kind]["bytes"] += v["bytes"]
    coll["total_bytes"] = sum(v["bytes"] for v in coll.values()
                              if isinstance(v, dict))
    one = traced["devices"]["cpu:0"]
    rec["memory"]["temp_bytes"] = one["peak_bytes"]
    rec.update(trace_s=traced["trace_s"],
               cost={"flops": one["flops"],
                     "bytes_accessed": one["memory_bytes"]},
               analysis={"flops": one["flops"],
                         "memory_bytes": one["memory_bytes"],
                         "collectives": coll},
               traced=traced)
    return rec


def held_bytes(params, opt_state, batch) -> dict:
    """The bytes that the first device of a data-parallel mesh holds of a
    train step's arguments: its pieces of the parameters (the port's
    ``Sharded`` tree), of the AdamW state and of the batch (``Sharded``
    leaves), split as :func:`reckon`'s ``arguments``."""
    def first(x):
        t = x.pieces[0] if isinstance(x, sh.Sharded) else x
        return t.numel() * t.element_size()

    def total(tree):
        return sum(first(x) for x in pr.leaves_like(tree, tree))
    return {"params": sum(first(x) for x in pr.leaves_like(
        pr.stack_tree(params), pr.stack_tree(params)) for x in
        (x if isinstance(x, list) else [x])),
        "opt": first(opt_state["step"]) + total(opt_state["m"]) +
        total(opt_state["v"]),
        "batch": sum(first(x) for x in batch.values())}


def cell_config(arch: str, variant: str = "baseline",
                reduced: bool = False):
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    over = VARIANTS[variant]
    return cfg.replace(**over["cfg"]) if over.get("cfg") else cfg


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: str,
             force: bool = False, variant: str = "baseline",
             reduced: bool = False) -> dict:
    """One cell's record, written to (or read back from) its JSON file.
    ``reduced`` takes the arch's ``reduced()`` config (a quick check of
    the whole path; ``__reduced`` ends the file name)."""
    os.makedirs(out_dir, exist_ok=True)
    suffix = ("" if variant == "baseline" else f"__{variant}") + \
        ("__reduced" if reduced else "")
    path = os.path.join(out_dir,
                        f"{arch}__{shape_name}__{mesh_name}{suffix}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "variant": variant, "reduced": reduced, "status": "unknown"}
    skip = should_skip(arch, shape_name)
    if skip:
        rec.update(status="skipped", reason=skip)
    else:
        over = VARIANTS[variant]
        shape = SHAPES[shape_name]
        mesh = production_mesh(multi_pod=(mesh_name == "multipod"))
        rules = sh.default_rules(mesh)
        rules.update(over.get("rules", {}))
        try:
            rec.update(reckon(cell_config(arch, variant, reduced),
                              shape["kind"],
                              shape, mesh, rules, over.get("opt")))
            rec["status"] = "ok"
        except Exception as e:  # record failures honestly
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-2000:])
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="pod", choices=list(MESHES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced() config (a quick check)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its "
                         "own")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s, m) for a in ARCHS for s in SHAPES for m in MESHES]
    else:
        cells = [(args.arch, args.shape, args.mesh)]
    one = functools.partial(_cell, out_dir=args.out, force=args.force,
                            variant=args.variant, reduced=args.reduced)
    t0 = time.time()
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=ctx) as pool:
            recs = pool.map(one, cells)
            out = [_summary(rec) for rec in recs]
    else:
        out = [_summary(one(cell)) for cell in cells]
    print(f"[dryrun] {len(cells)} cells in {time.time() - t0:.1f} s "
          f"({args.jobs} at once)", flush=True)
    return out


def _cell(cell, **kw) -> dict:
    torch.set_num_threads(1)
    return run_cell(*cell, **kw)


def _summary(rec) -> dict:
    """Print a cell's line; -> the record."""
    status, extra = rec.get("status"), ""
    if status == "ok":
        tb = rec["memory"]["temp_bytes"] / 2 ** 30
        fl = rec["cost"]["flops"]
        cb = rec["collectives"]["total_bytes"] / 2 ** 30
        extra = (f" temp={tb:.2f}GiB/dev flops={fl:.3e} "
                 f"coll={cb:.2f}GiB trace={rec['trace_s']:.0f}s")
    elif status == "error":
        extra = " " + rec.get("error", "")[:120]
    elif status == "skipped":
        extra = " " + rec.get("reason", "")[:80]
    print(f"[dryrun] {rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:8s} "
          f"-> {status}{extra}", flush=True)
    return rec


if __name__ == "__main__":
    main()
