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

A cell traces the port's own step at the cell's global shape on one
device (``step_analysis.analyze_step``): the train step
(``train.loop.make_train_step``: loss, backward, AdamW), ``engine.prefill``
or ``lm.decode_step`` at the last slot of a full cache.  What it records:

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
* ``collectives``: ``step_analysis.reckon_collectives`` on the cell's
  placements (the all-gather of every FSDP piece; for a train step the
  gradients' reduce-scatter and, under ``opt_8bit``, the flat
  reduce-scatter and the all-to-all of item 23), per device;
* ``traced``: the whole step's numbers and the divisor.

**Per-device rule.**  The port has no tensor-parallel compute (ROADMAP
item 21), so the traced step is the whole batch on one device.  A
device's flops, bytes accessed and temporaries are the traced step's
divided by the reference's split of the work: the product of the
data-parallel axes (``pod``, ``data``) where they divide the global batch
(else 1: the batch is replicated, as ``batch_sharding`` falls back) times
the ``model`` axis.

Keys of the reference with no PyTorch meaning are left out, not written
as 0: ``compile_s``, ``generated_code_bytes``, ``hlo_ops``, and the
``transcendentals`` of XLA's cost analysis.  A cell that raises records
``status: "error"`` with the message, as the reference does.  The
``embed_psum`` variants trace the gather lookup: the port's psum lookup
splits the table onto the mesh's devices, which a mesh shape has none of.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.data.pipeline import batch_struct
from repro_torch.launch import sharding as sh
from repro_torch.launch import step_analysis as sa
from repro_torch.launch.mesh import dp_axes, production_mesh
from repro_torch.models import lm
from repro_torch.models import params as pr
from repro_torch.optim import adamw
from repro_torch.serve import engine
from repro_torch.train.loop import make_train_step

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
    params = [(s_, dt, shd.named(ax, s_)) for s_, _, dt, ax in leaves]
    b, s = shape["global_batch"], shape["seq_len"]
    scalar = [((), torch.int32, shd.named(()))]
    batch = _batch(cfg, b, s, kind, "meta")
    out = {"shd": shd, "leaves": leaves, "q_block": None}

    def model():
        return lm.init_model(cfg, device="cpu")

    if kind == "train":
        opt_cfg = adamw.AdamWConfig(**(opt_over or {}))
        opt = scalar + _moment_items(shd, leaves, opt_cfg)

        def build():
            m, data = model(), _batch(cfg, b, s, kind)
            state = adamw.init(m.tree(), opt_cfg)
            step_fn = make_train_step(cfg, opt_cfg)
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


def _batch_items(shd, batch) -> list:
    placements = sh.batch_sharding(shd, batch)
    return [(tuple(v.shape), v.dtype, placements[k])
            for k, v in sorted(batch.items())]


def reckon(cfg, kind: str, shape: dict, mesh, rules,
           opt_over: dict | None = None, trace: bool = True,
           traced: dict | None = None) -> dict:
    """A cell's record fields (see the module docstring) for any mesh
    with ``shape`` and ``axis_names`` (a ``ShardMesh`` too): the
    placements' bytes and collectives, and with ``trace`` the traced
    step's per-device cost (``traced``: a trace of the same step already
    made, to reuse)."""
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
    if traced is None:
        t0 = time.time()
        res = sa.analyze_step(st["build"])
        traced = {k: res[k] for k in ("flops", "memory_bytes",
                                      "peak_bytes")}
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


_TRACES: dict = {}     # (arch, shape, cfg / opt variant) -> trace numbers


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
        key = (arch, shape_name, reduced, repr(over.get("cfg")),
               repr(over.get("opt")))
        try:
            rec.update(reckon(cell_config(arch, variant, reduced),
                              shape["kind"],
                              shape, mesh, rules, over.get("opt"),
                              traced=_TRACES.get(key)))
            _TRACES[key] = {k: v for k, v in rec["traced"].items()
                            if k != "divisor"}
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
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s, m) for a in ARCHS for s in SHAPES for m in MESHES]
    else:
        cells = [(args.arch, args.shape, args.mesh)]
    out = []
    for a, s, m in cells:
        rec = run_cell(a, s, m, args.out, force=args.force,
                       variant=args.variant, reduced=args.reduced)
        summary = rec.get("status")
        extra = ""
        if summary == "ok":
            tb = rec["memory"]["temp_bytes"] / 2 ** 30
            fl = rec["cost"]["flops"]
            cb = rec["collectives"]["total_bytes"] / 2 ** 30
            extra = (f" temp={tb:.2f}GiB/dev flops={fl:.3e} "
                     f"coll={cb:.2f}GiB trace={rec['trace_s']:.0f}s")
        elif summary == "error":
            extra = " " + rec.get("error", "")[:120]
        elif summary == "skipped":
            extra = " " + rec.get("reason", "")[:80]
        print(f"[dryrun] {a:22s} {s:12s} {m:8s} -> {summary}{extra}",
              flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
