"""Plan execution engine — backend emitters over the lowered code tree.

Lowering decisions live in :mod:`repro_torch.core.ir`; this module only
*emits* runnable programs by walking the lowered tree.  A port of the
JAX package's ``core/engine.py``, its sharded emitters
(:func:`make_sharded_executor`, :func:`make_sharded_fixpoint_step`, over a
:class:`repro_torch.launch.mesh.ShardMesh`) included.

Backends:
  * ``torch`` — plain torch ops over the specialized plan (class-sorted
    blocks, indexed window / slice loads, log-step segmented reduce); the
    counterpart of the reference's ``jax`` backend, lowered the same way.
  * ``cuda``  — the hand-written CUDA stage-A kernels in
    :mod:`repro_torch.kernels.unroll_spmv`, the counterpart of the
    reference's ``pallas`` backend.  On CPU tensors the kernel wrappers run
    their plain torch versions.
  * ``segsum`` — the single segment-reduce form: stage A and B fold into
    one ``scatter_reduce_`` straight into the output.  Its float add/mul
    accumulates in float64 in no fixed order (atomics on CUDA), so it is
    held to the other backends to a tolerance, not bitwise.

``torch`` and ``cuda`` share stage B, the collision-free write-back
(:func:`_stage_b`): one indexed write per distinct output row, exact and
free of atomics.  :func:`make_baseline_gather` is the conservative
compiler's form (native gather + scatter, no pattern analysis).

Execution modes (``fused`` flag, default True) and ``coalesce=True`` are
the reference's: they select lowering passes, and results are bitwise
equal across them (DESIGN.md §3, §8).

The executor factory performs the Data Transfer step once (physical nnz
reorder into exec order) and stages every plan array to the device at build
time; a call touches only the *mutable* inputs.  Every entry point takes
``device=`` and defaults to ``"cuda"``; asking for CUDA without a CUDA
device raises — nothing silently runs on the CPU.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core import ir
from repro_torch.core.plan import BlockPlan
from repro_torch.core.seed import (REDUCE_OPS, CodeSeed, reduce_identity_for,
                                   reference_execute)
from repro_torch.kernels import common
from repro_torch.kernels.unroll_spmv import ops as kops
from repro_torch.launch.mesh import dp_axes
from repro_torch.launch.sharding import row_sharding
from repro_torch.obs import trace as _trace

_SEG_PAD = common.SEG_PAD
_expand_trailing = common.expand_trailing
# §5 log-step masked shift-reduce, and the pairwise halving tree behind its
# FULL_REDUCE form: the same functions the kernels' plain versions run
segmented_reduce = common.segmented_reduce_lanes
_halving_tree = common.halving_tree


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA without a CUDA device
    raises: the port never carries on on the CPU unless asked to."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch sees no CUDA "
                "device; pass device='cpu' to run on the CPU")
        if dev.index is None:       # compare equal to tensors' devices
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _padded_view_len(data_len: int, n: int) -> int:
    return max(1, -(-data_len // n)) * n


def reorder_elementwise(plan: BlockPlan, arr, identity=None,
                        reduce: str = "add", device=None) -> torch.Tensor:
    """Data Transfer: physically reorder an nnz-aligned immutable array into
    exec order (class-sorted blocks, in-block write-sorted), padding with the
    reduce identity *in the array's dtype* (DESIGN.md §3a). Returns (B, N)."""
    arr = torch.as_tensor(arr, device=device)
    if identity is None:
        identity = reduce_identity_for(reduce, arr.dtype).item()
    padded = torch.cat([arr, torch.full((1,) + arr.shape[1:], identity,
                                        dtype=arr.dtype, device=arr.device)])
    idx = torch.as_tensor(np.minimum(plan.flat_perm, plan.nnz),
                          device=arr.device)
    return padded[idx].reshape(plan.num_blocks, plan.lane_width)


def _pad_flat(plan: BlockPlan, g: torch.Tensor) -> torch.Tensor:
    """Pad a gathered dense array to a whole number of lane tiles (flat
    view) — the address space of both the window and the coalesced-slice
    loads."""
    pad = _padded_view_len(plan.data_len, plan.lane_width) - g.shape[0]
    if pad:
        g = torch.cat([g, g.new_zeros((pad,) + g.shape[1:])])
    return g


def _pad_gathered(plan: BlockPlan, g: torch.Tensor) -> torch.Tensor:
    """The padded flat view as (num_windows, N, ...) lane tiles."""
    n = plan.lane_width
    gp = _pad_flat(plan, g)
    return gp.reshape((gp.shape[0] // n, n) + g.shape[1:])


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Deterministic full sum of a 1-D tensor by pairwise halving — the same
    fixed combine order everywhere (``torch.sum`` pins none)."""
    if x.numel() == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    return _halving_tree(x.reshape(1, -1), torch.add, 0)[0, 0]


def state_healthy(state: torch.Tensor, reduce: str = "add") -> torch.Tensor:
    """Device-side scalar bool: is a fixpoint state still numerically
    healthy for its semiring? (DESIGN.md §9)  ``min``'s identity is
    ``+inf`` (a legitimate "unreachable"), so only NaN and ``-inf`` count
    as divergence there; symmetrically for ``max``; for ``add``/``mul`` any
    non-finite value does.  Integer states cannot diverge."""
    if not state.is_floating_point():
        return torch.ones((), dtype=torch.bool, device=state.device)
    if reduce == "min":
        bad = torch.isnan(state) | torch.isneginf(state)
    elif reduce == "max":
        bad = torch.isnan(state) | torch.isposinf(state)
    else:
        bad = ~torch.isfinite(state)
    return ~bad.any()


def _gather_launch_values(plan: BlockPlan, launch: ir.Launch, s: slice,
                          meta: Mapping[str, torch.Tensor],
                          mutable: Mapping[str, torch.Tensor],
                          co: dict | None) -> dict:
    """§6: per-lane gathered values for one launch, by its lowered gather
    idiom.  Every idiom reads the identical word ``x[gather_idx]``."""
    seed = plan.seed
    vals = {}
    if seed.gather_index is None:
        return vals
    n = plan.lane_width
    if launch.gather == ir.FALLBACK:
        gi = meta["gather_idx"][s]
        for g in seed.gathered:
            vals[g] = mutable[g][gi]
        return vals
    if launch.gather == ir.COALESCED:
        # one dense N-word slice per block, permuted in the tile when the
        # run is strided
        iota = torch.arange(n, device=co["starts"].device)
        for g in seed.gathered:
            tiles = _pad_flat(plan, mutable[g])[co["starts"][:, None] + iota]
            vals[g] = tiles if co["off"] is None else torch.take_along_dim(
                tiles, _expand_trailing(co["off"], tiles.ndim), dim=1)
        return vals
    win = meta["window_ids"][s][:, :launch.ls_flag]           # (Bc, M)
    for g in seed.gathered:
        gv = _pad_gathered(plan, mutable[g])[win]             # (Bc, M, N)
        if launch.gather == ir.STREAM:
            vals[g] = gv[:, 0]                                # pure vload
        else:
            vals[g] = common.permute_onehot(gv, meta["lane_slot"][s],
                                            meta["lane_offset"][s])
    return vals


def _stage_a_torch(plan: BlockPlan, meta, elem_exec, mutable,
                   launches: list[ir.Launch], co_meta: dict) -> torch.Tensor:
    """Walk the lowered launch list; return the (B, N, ...) post-reduce
    lane matrix in exec-block order.  Mixed native/ladder sections never
    occur here — ``fuse_sections`` merges only equal-op classes for the
    torch backend."""
    seed = plan.seed
    parts = []
    for i, launch in enumerate(launches):
        s = slice(launch.start, launch.stop)
        vals = _gather_launch_values(plan, launch, s, meta, mutable,
                                     co_meta.get(i))
        rank = max((v.ndim for v in vals.values()), default=2)
        for e in seed.elementwise:
            vals[e] = _expand_trailing(elem_exec[e][s], rank)
        term = seed.combine(vals)
        parts.append(segmented_reduce(term, meta["seg_ids"][s],
                                      launch.op_flag, seed.reduce))
    if not parts:      # empty plan (nnz == 0): no launches, no lanes
        dtype = next(iter(mutable.values())).dtype if mutable else \
            torch.float32
        return torch.zeros((0, plan.lane_width), dtype=dtype,
                           device=meta["seg_ids"].device)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def _stage_b(plan: BlockPlan, meta, lanes: torch.Tensor,
             out_init: torch.Tensor) -> torch.Tensor:
    """Merged write-back (Fig. 4): one read-modify-write per distinct output
    row.  Head values are re-gathered from the flat (B*N, ...) lane stream
    in row-sorted order, cross-block contributions to one row are combined
    by a log-step tree (a fixed float order), and the fold into ``out_init``
    is a gather, the op, and an indexed write over unique rows — exact, with
    no atomics, so fused and per-class launches agree bitwise end to end
    (DESIGN.md §3)."""
    hv = lanes.reshape((-1,) + lanes.shape[2:])[meta["head_pos_rowsorted"]]
    seg = meta["head_row_seg"]
    op = REDUCE_OPS[plan.seed.reduce][0]
    identity = reduce_identity_for(plan.seed.reduce, hv.dtype).item()
    h = hv.shape[0]
    for k in range(int(meta["head_tree_depth"])):
        d = min(1 << k, h)
        shifted = torch.cat([hv[d:], torch.full(
            (d,) + hv.shape[1:], identity, dtype=hv.dtype,
            device=hv.device)])
        seg_shift = torch.cat([seg[d:], torch.full(
            (d,), _SEG_PAD, dtype=seg.dtype, device=seg.device)])
        hv = torch.where(_expand_trailing(seg == seg_shift, hv.ndim),
                         op(hv, shifted), hv)
    vals = hv[meta["head_run_starts"]]
    rows = meta["head_unique_rows"]
    out = out_init.clone()
    out[rows] = op(out_init[rows], vals).to(out.dtype)
    return out


def head_write_meta(plan: BlockPlan, device) -> dict:
    """Static metadata for the collision-free write-back, on ``device``:
    heads sorted by output row (stable in exec order), per-row run
    structure, and the tree depth covering the longest run."""
    order = np.argsort(plan.head_rows, kind="stable")
    rows_sorted = plan.head_rows[order]
    change = np.ones(rows_sorted.shape[0], dtype=bool)
    change[1:] = rows_sorted[1:] != rows_sorted[:-1]
    seg = np.cumsum(change) - 1
    counts = np.diff(np.append(np.nonzero(change)[0],
                               rows_sorted.shape[0]))
    depth = int(np.ceil(np.log2(counts.max()))) if counts.size \
        and counts.max() > 1 else 0

    def dev(a, dtype=torch.int64):
        return torch.as_tensor(a, device=device).to(dtype)

    return {
        "head_pos_rowsorted": dev(plan.head_pos[order]),
        "head_row_seg": dev(seg, torch.int32),
        "head_run_starts": dev(np.nonzero(change)[0]),
        "head_unique_rows": dev(rows_sorted[change]),
        "head_tree_depth": depth,
    }


def dense_head_rows(plan: BlockPlan) -> np.ndarray:
    """(B*N,) int32: output row per exec lane for head lanes, ``out_len``
    (a discard bucket) for every other lane — the dense head buffer of the
    opt-in ``stage_b="dense"`` write-back."""
    rows = np.full(plan.num_blocks * plan.lane_width, plan.out_len, np.int64)
    rows[plan.head_pos] = plan.head_rows
    return rows.astype(np.int32)


_INDEX_REDUCE = {"mul": "prod", "max": "amax", "min": "amin"}
_SCATTER_REDUCE = {"add": "sum", **_INDEX_REDUCE}


def segsum_lane_rows(plan: BlockPlan) -> np.ndarray:
    """(B*N,) int64: the output row of every exec lane, ``out_len`` (a
    discard bucket) for pad lanes.  Each head's row is scattered onto its
    (block, segment) and read back per lane: the Data Transfer sort makes
    every segment's lanes consecutive."""
    seg = plan.seg_ids
    per_seg = np.full((plan.num_blocks, plan.lane_width), plan.out_len,
                      np.int64)
    hb = plan.head_pos // plan.lane_width
    hl = plan.head_pos % plan.lane_width
    per_seg[hb, seg[hb, hl]] = plan.head_rows
    lane_rows = per_seg[np.arange(plan.num_blocks)[:, None], seg]
    return np.where(plan.valid, lane_rows, plan.out_len).reshape(-1)


def _make_segsum(plan: BlockPlan, elem_exec, dev):
    """The segsum sweep body: gather every lane, combine, then ONE
    ``scatter_reduce_`` into an ``out_len + 1`` buffer holding the reduce's
    identity (rows without an nnz and the discard bucket keep it), folded
    into ``out_init`` with the seed's reduce.

    A float ``add`` / ``mul`` accumulates in float64 and rounds once, where
    the reference's segment reduce accumulates in the terms' dtype: the
    scatter's float adds are atomics in no fixed order on the card, and a
    float32 accumulator then drifts, on a power-law hub row of thousands
    of terms, past the tolerance the tuner holds every candidate to (the
    webbase-1M analogue).  ``amax`` / ``amin`` and integers are exact in
    their own dtype."""
    seed = plan.seed
    rows = torch.as_tensor(segsum_lane_rows(plan), device=dev)
    gidx = torch.as_tensor(plan.gather_idx.reshape(-1), device=dev).long()
    reduce = seed.reduce
    fold = REDUCE_OPS[reduce][0]
    n_out = plan.out_len

    def run_ss(mutable, out_init):
        vals = {g: mutable[g][gidx] for g in seed.gathered}
        rank = max((v.ndim for v in vals.values()), default=1)
        for e in seed.elementwise:
            vals[e] = _expand_trailing(elem_exec[e].reshape(-1), rank)
        term = seed.combine(vals)
        term_dtype = term.dtype
        if term.is_floating_point() and reduce in ("add", "mul"):
            term = term.double()
        identity = reduce_identity_for(reduce, term.dtype).item()
        red = torch.full((n_out + 1,) + term.shape[1:], identity,
                         dtype=term.dtype, device=term.device)
        index = rows.reshape((-1,) + (1,) * (term.ndim - 1)).expand(
            term.shape)
        red.scatter_reduce_(0, index, term, _SCATTER_REDUCE[reduce],
                            include_self=False)
        return fold(out_init, red[:n_out].to(term_dtype)).to(out_init.dtype)
    return run_ss


def _stage_b_dense(plan: BlockPlan, meta, lanes: torch.Tensor,
                   out_init: torch.Tensor) -> torch.Tensor:
    """Write-back by scattering the whole post-reduce lane stream through
    the dense head-row buffer (non-head lanes land in the discard bucket at
    ``out_len``).  Duplicate rows accumulate through ``index_add`` /
    ``index_reduce``, whose float order is unspecified on CUDA: this form is
    opt-in and carries no bitwise guarantee."""
    rows = meta["lane_rows"]
    flat = lanes.reshape((-1,) + lanes.shape[2:])
    reduce = plan.seed.reduce
    n_out = plan.out_len
    shape = (n_out + 1,) + flat.shape[1:]
    identity = reduce_identity_for(reduce, flat.dtype).item()
    acc = torch.full(shape, identity, dtype=flat.dtype, device=flat.device)
    if reduce == "add":
        acc.index_add_(0, rows, flat)
    else:
        acc.index_reduce_(0, rows, flat, _INDEX_REDUCE[reduce],
                          include_self=True)
    return REDUCE_OPS[reduce][0](out_init, acc[:n_out])


def reorder_static(plan: BlockPlan, static_data: Mapping[str, np.ndarray],
                   device=None) -> dict:
    """Data Transfer for the seed's elementwise arrays: reorder each into
    exec order once, on ``device``.  The result can be shared across every
    executor built on the same plan (``make_executor(..., elem_exec=...)``)."""
    seed = plan.seed
    return {e: reorder_elementwise(plan, static_data[e], reduce=seed.reduce,
                                   device=device)
            for e in seed.elementwise}


@_trace.traced("engine.build_sweeper")
def make_sweeper(plan: BlockPlan, static_data: Mapping[str, np.ndarray],
                 backend: str = "torch", fused: bool = True,
                 stage_b: str = "auto",
                 elem_exec: Mapping[str, torch.Tensor] | None = None,
                 coalesce: bool = False, tree: ir.CodeTree | None = None,
                 kernel_params: Mapping[str, int] | None = None,
                 device="cuda"):
    """The sweep body ``fn(mutable: dict, out_init) -> out``.

    The plan is first lowered through :func:`repro_torch.core.ir.lower`
    (fuse / stage-B / coalesce passes per the ``fused`` / ``stage_b`` /
    ``coalesce`` toggles); the emitter below walks the lowered launch list
    and makes no lowering decisions itself.  ``tree`` optionally supplies
    an already-lowered tree for ``plan``.

    Every host-side constant (reordered elementwise arrays, lane metadata,
    write-back structure, coalesced slice bases) is staged to ``device``
    HERE, once.  ``kernel_params`` carries the stage-A kernel knobs of the
    ``cuda`` backend (``rows_per_step``; ``meta_prefetch`` is accepted and
    ignored)."""
    dev = resolve_device(device)
    if tree is None:
        tree = ir.lower(plan, backend=backend, fused=fused,
                        stage_b=stage_b, coalesce=coalesce)
    elif tree.plan is not plan:
        raise ValueError("make_sweeper: tree.plan must be the given plan")
    elif tree.backend != backend:
        raise ValueError(
            f"make_sweeper: tree was lowered for backend "
            f"{tree.backend!r}, emitter asked for {backend!r}")
    if elem_exec is None:
        elem_exec = reorder_static(plan, static_data, dev)
    if backend == "segsum":
        run_ss = _make_segsum(plan, elem_exec, dev)
        run_ss.tree = tree
        return run_ss
    meta = {"seg_ids": torch.as_tensor(plan.seg_ids, device=dev)}
    if tree.stage_b == "dense":
        meta["lane_rows"] = torch.as_tensor(dense_head_rows(plan),
                                            device=dev).long()
        write_back = _stage_b_dense
    else:
        meta.update(head_write_meta(plan, dev))
        write_back = _stage_b

    if backend == "torch":
        meta.update({
            "window_ids": torch.as_tensor(plan.window_ids, device=dev).long(),
            "lane_slot": torch.as_tensor(plan.lane_slot, device=dev).long(),
            "lane_offset": torch.as_tensor(plan.lane_offset,
                                           device=dev).long(),
            "gather_idx": torch.as_tensor(plan.gather_idx, device=dev).long(),
        })
        launches = tree.launches
        co_meta = {
            i: {"starts": torch.as_tensor(launch.slice_starts,
                                          device=dev).long(),
                "off": (None if launch.local_offset is None else
                        torch.as_tensor(launch.local_offset,
                                        device=dev).long())}
            for i, launch in enumerate(launches)
            if launch.gather == ir.COALESCED}

        def run(mutable, out_init):
            lanes = _stage_a_torch(plan, meta, elem_exec, mutable, launches,
                                   co_meta)
            return write_back(plan, meta, lanes, out_init)
        run.tree = tree
        return run

    stage_a = kops.make_stage_a(plan, elem_exec, dev, launches=tree.launches,
                                kernel_params=kernel_params)

    def run_cuda(mutable, out_init):
        return write_back(plan, meta, stage_a(mutable), out_init)
    run_cuda.tree = tree
    run_cuda.stage_a = stage_a
    return run_cuda


def make_executor(plan: BlockPlan, static_data: Mapping[str, np.ndarray],
                  backend: str = "torch", fused: bool = True,
                  stage_b: str = "auto",
                  elem_exec: Mapping[str, torch.Tensor] | None = None,
                  coalesce: bool = False, tree: ir.CodeTree | None = None,
                  kernel_params: Mapping[str, int] | None = None,
                  device="cuda"):
    """Build an executor ``fn(mutable: dict, out_init) -> out`` on
    ``device``.

    ``static_data`` holds the seed's *elementwise* (immutable, nnz-aligned)
    arrays in original order; they are reordered once here (Data Transfer).
    ``fused`` (default) collapses the per-class launch list (DESIGN.md §3);
    ``fused=False`` keeps the paper's one-launch-per-pattern-class form.
    ``stage_b`` selects the write-back (``"gather"``, ``"dense"`` or
    ``"auto"`` = gather); ``coalesce`` enables the gather-coalescing pass
    (DESIGN.md §8).

    The returned callable exposes the sweep body as ``run.sweep_body`` and
    the lowered code tree as ``run.tree``.  With tracing enabled each call
    emits an ``engine.execute`` span (``first_call=True`` marks the first)."""
    body = make_sweeper(plan, static_data, backend=backend, fused=fused,
                        stage_b=stage_b, elem_exec=elem_exec,
                        coalesce=coalesce, tree=tree,
                        kernel_params=kernel_params, device=device)

    def run(mutable, out_init):
        if not _trace.enabled():
            return body(mutable, out_init)
        first = not run._called
        run._called = True
        with _trace.span("engine.execute", backend=backend,
                         first_call=first):
            return body(mutable, out_init)
    run._called = False
    run.sweep_body = body
    run.tree = body.tree
    return run


# ------------------------------------------------------ sharded emitters
# One mesh, one plan per shard (DESIGN.md §10): the emitters below run the
# per-shard subtrees of ir.partition_plan, one process driving every mesh
# device (the reference's single-controller shard_map).  Its collectives are
# tensor moves: the all-gather is a ``torch.cat`` of the shard pieces, each
# moved with ``.to(device)`` (no copy on a simulated mesh), the psum of the
# per-shard verdicts a sum of per-shard scalars on shard 0's device, and
# ``lax.switch(axis_index)`` a Python loop over the shards, each shard's
# program launched on its own device.  Public interfaces stay FULL-ARRAY
# (pad/shard on entry, unpad on exit), so a sharded executor is a drop-in
# replacement for a single-device one, with bitwise-equal outputs.
def check_shard_backend(backend: str) -> None:
    """The sharded emitters take the torch/segsum backends only."""
    if backend == "cuda":
        raise ValueError("sharded execution supports the torch/segsum "
                         "backends (the CUDA kernels are single-device)")


def _shard_axis(mesh) -> str:
    """The mesh axis shard rows ride on — the data-parallel axis."""
    dp = dp_axes(mesh)
    if len(dp) != 1:
        raise ValueError(
            f"sharded execution needs exactly one data axis in the mesh "
            f"(axes {mesh.axis_names}, data axes {dp}); build one with "
            "repro_torch.launch.mesh.make_shard_mesh(shards)")
    if int(np.prod([mesh.shape[a] for a in mesh.axis_names
                    if a not in dp])) != 1:
        raise ValueError(
            f"sharded execution replicates over non-data axes; mesh "
            f"{dict(mesh.shape)} has a non-trivial model axis")
    return dp[0]


def _check_parts(parts, mesh) -> str:
    axis = _shard_axis(mesh)
    k = int(mesh.shape[axis])
    if len(parts) != k:
        raise ValueError(
            f"{len(parts)} plan shards over a {k}-device '{axis}' axis; "
            "partition_plan(tree, shards) must match the mesh")
    if parts:
        check_shard_backend(parts[0].tree.backend)
    return axis


def shard_widths(parts) -> tuple[list[int], int]:
    """Per-shard row counts and the common padded width S (>= 1)."""
    widths = [p.num_rows for p in parts]
    return widths, max(max(widths), 1)


def _pad_to(y: torch.Tensor, s: int) -> torch.Tensor:
    """``y``'s rows zero-padded to ``s``, always a new tensor."""
    return torch.cat([y, y.new_zeros((s - y.shape[0],) + y.shape[1:])])


def pad_rows(state: torch.Tensor, widths: list[int], s: int,
             devices) -> list[torch.Tensor]:
    """(n, ...) full tensor -> one (S, ...) tensor per shard, shard ``i``'s
    rows zero-padded to S and placed on ``devices[i]`` (the row sharding
    of :func:`repro_torch.launch.sharding.row_sharding`).  Pads are
    CONSTANT zeros in every sweep (the emitters re-pad with zeros), so
    padded-state equality is exactly full-state equality — the sharded
    convergence check leans on this."""
    pieces, lo = [], 0
    for w, dev in zip(widths, devices):
        pieces.append(_pad_to(state[lo:lo + w], s).to(dev))
        lo += w
    return pieces


def unpad_rows(pieces, widths: list[int], device) -> torch.Tensor:
    """Per-shard (S, ...) pieces -> the (n, ...) full tensor on ``device``:
    each shard's pad rows dropped, the rest concatenated in shard order."""
    return torch.cat([p[:w].to(device) for p, w in zip(pieces, widths)])


def shard_sweep_bodies(parts, static_data, devices):
    """One sweep body per shard, shard ``i``'s on ``devices[i]`` (empty
    shards -> identity).  Elementwise arrays stay FULL-LENGTH: each shard's
    sliced ``flat_perm`` holds global nnz positions, so the per-shard Data
    Transfer reorders the same full arrays the parent would (the parent's
    own ``elem_exec`` cannot be shared — it is already block-reordered)."""
    bodies = []
    for p, dev in zip(parts, devices):
        if p.num_blocks == 0 or p.tree.plan.head_pos.size == 0:
            bodies.append(lambda mutable, out_init: out_init)
            continue
        bodies.append(make_sweeper(p.tree.plan, static_data,
                                   backend=p.tree.backend, tree=p.tree,
                                   device=dev))
    return bodies


def make_sharded_executor(parts, static_data, mesh):
    """Executor over a partitioned plan: ``run(mutable, out_init)`` with
    FULL tensors, running shard ``i``'s subtree on mesh device ``i``.

    The mutable gathered inputs are replicated (every shard gathers
    through GLOBAL indices); ``out_init`` is row-sharded, and the result
    is reassembled on ``out_init``'s device.  Bitwise: each output row
    runs the parent's identical block program and per-row combine tree
    (ir.partition_plan), so the result equals single-device execution of
    the same backend bit for bit."""
    _check_parts(parts, mesh)
    widths, s = shard_widths(parts)
    k = len(parts)
    devices = row_sharding(mesh)
    bodies = shard_sweep_bodies(parts, static_data, devices)

    def run_full(mutable, out_init):
        pieces = pad_rows(out_init, widths, s, devices)
        out = []
        for j in range(k):
            if widths[j] == 0:
                out.append(pieces[j])
                continue
            mut = {key: v.to(devices[j]) for key, v in mutable.items()}
            out.append(_pad_to(bodies[j](mut, pieces[j][:widths[j]]), s))
        return unpad_rows(out, widths, out_init.device)

    def run(mutable, out_init):
        if not _trace.enabled():
            return run_full(mutable, out_init)
        first = not run._called
        run._called = True
        with _trace.span("engine.execute", backend=parts[0].tree.backend,
                         shards=k, first_call=first):
            return run_full(mutable, out_init)
    run._called = False
    run.sweep_body = run_full
    run.parts = parts
    run.mesh = mesh
    run.bodies = bodies
    return run


def make_sharded_fixpoint_step(run, state_key: str, *, local_steps=None,
                               with_convergence: bool = True):
    """The sharded resident sweep ``step(pieces) -> ...`` for fixpoint
    drivers (DESIGN.md §7/§10): state lives row-sharded as the padded
    per-shard pieces of :func:`pad_rows`; each sweep all-gathers the
    pieces into the full dense input vector on each shard's device, runs
    the local subtree on the shard's own rows (fold semantics:
    ``out_init`` is the shard's previous rows), and re-pads.  With
    ``with_convergence`` the step also returns device-side ``(changed,
    healthy)`` scalars on shard 0's device — sums of the per-shard
    verdicts — so convergence needs no host read and no full-state
    rebuild outside the loop.

    ``run`` is the app's :func:`make_sharded_executor`: the step runs its
    per-shard sweep bodies, so the shards' plan arrays are staged on the
    devices once for both drivers.  ``local_steps`` optionally overrides
    the per-shard body: a list of ``f_j(full_state, local_rows) ->
    new_local_rows`` (PageRank's damping fold wraps ``run.bodies`` this
    way)."""
    parts, bodies = run.parts, run.bodies
    widths, s = shard_widths(parts)
    k = len(parts)
    devices = row_sharding(run.mesh)
    reduce = parts[0].tree.plan.seed.reduce
    if local_steps is None:
        local_steps = [
            (lambda j: lambda full, local:
             bodies[j]({state_key: full}, local))(j) for j in range(k)]

    def step(pieces):
        fulls, new = {}, []
        for j, (block, dev) in enumerate(zip(pieces, devices)):
            if widths[j] == 0:
                new.append(block)
                continue
            full = fulls.get(dev)
            if full is None:                          # the all-gather
                full = fulls[dev] = unpad_rows(pieces, widths, dev)
            new.append(_pad_to(local_steps[j](full, block[:widths[j]]), s))
        if not with_convergence:
            return new
        home = devices[0]
        changed = torch.stack([(a != b).any().to(home)
                               for a, b in zip(new, pieces)]).any()
        healthy = torch.stack([state_healthy(a, reduce).to(home)
                               for a in new]).all()
        return new, changed, healthy
    step.widths = widths
    step.padded_width = s
    step.devices = devices
    return step


def make_baseline_gather(seed: CodeSeed, access: Mapping[str, np.ndarray],
                         static_data: Mapping[str, np.ndarray],
                         device="cuda"):
    """The conservative-compiler baseline: native gather + scatter, no
    pattern analysis (the paper's icc/-O3 stand-in), over
    :func:`~repro_torch.core.seed.reference_execute`.  The access and
    elementwise arrays are staged to ``device`` once, here."""
    dev = resolve_device(device)
    acc = {k: torch.as_tensor(np.asarray(v), device=dev).long()
           for k, v in access.items()}
    elem = {e: torch.as_tensor(np.asarray(static_data[e]), device=dev)
            for e in seed.elementwise}

    def run(mutable, out_init):
        data = dict(mutable)
        data.update(elem)
        return reference_execute(seed, acc, data, out_init)
    return run
