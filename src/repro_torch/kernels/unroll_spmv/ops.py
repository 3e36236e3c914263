"""Stage A of the ``"cuda"`` backend: walk the lowered launch list.

``make_stage_a(plan, elem_exec, device, launches=...)`` returns
``fn(mutable) -> (B, N, ...)`` lanes in exec-block order (the gathered
arrays' trailing lane axes ride along), as the JAX package's
``kernels/unroll_spmv/ops.py::make_stage_a`` does for its Pallas backend:

* gather-fallback launches stay torch ops: the native gather, the combine,
  the ladder and, in a fused mixed section, the halving-tree full reduce
  where a block's flag is set;
* COALESCED launches go to the dense-slice kernel;
* every other launch (window, stream) goes to the window kernel.

Each launch writes its rows of one preallocated lanes tensor, so stage A
makes no concatenation copy.  All per-launch metadata is staged to the
device once, here, at build time.

Kernel knobs (``kernel_params``): ``rows_per_step`` is honoured by both
kernels (realized as the largest divisor of the launch's block count, so
every value gives bit-identical lanes).  ``meta_prefetch`` sizes the TPU
window form's metadata DMA tiles and has no meaning on Hopper, where each
CTA loads its own metadata rows: it is accepted and ignored, as the
reference's GPU form ignores it.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import ir
from repro_torch.core.plan import BlockPlan
from repro_torch.kernels import common
from repro_torch.kernels.unroll_spmv.kernel import (dense_slice_stage_a,
                                                    window_stage_a)


@dataclasses.dataclass(frozen=True)
class LaunchMeta:
    """Device-resident operands of one launch (int32, contiguous)."""

    launch: ir.Launch
    win: torch.Tensor           # (Bc, ls)
    slot: torch.Tensor          # (Bc, N)
    off: torch.Tensor           # (Bc, N)
    seg: torch.Tensor           # (Bc, N)
    gidx: torch.Tensor | None   # (Bc, N) int64, fallback launches only
    starts: torch.Tensor | None  # (Bc,), coalesced launches only
    local: torch.Tensor | None  # (Bc, N), strided coalesced launches only
    full: torch.Tensor | None   # (Bc,) native-reduce flags


def require_kernel_combine(seed) -> str:
    """The seed's kernel combine, or raise: a seed the CUDA kernels cannot
    evaluate has no place on the ``"cuda"`` backend (no silent torch
    fallback)."""
    if seed.kernel_combine is None:
        raise ValueError(
            f"seed {seed.name!r} has no kernel_combine, so the CUDA stage-A "
            "kernels cannot evaluate it; use backend='torch'")
    return seed.kernel_combine


def stage_launch_meta(plan: BlockPlan, launches: list[ir.Launch],
                      device: torch.device) -> list[LaunchMeta]:
    """Stage every launch's metadata to ``device`` once."""
    def dev(a, dtype=torch.int32):
        return None if a is None else torch.as_tensor(
            a, device=device).to(dtype).contiguous()

    out = []
    for launch in launches:
        s = slice(launch.start, launch.stop)
        fb = launch.gather == ir.FALLBACK
        out.append(LaunchMeta(
            launch=launch,
            win=dev(plan.window_ids[s][:, :max(launch.ls_flag, 1)]),
            slot=dev(plan.lane_slot[s]),
            off=dev(plan.lane_offset[s]),
            seg=dev(plan.seg_ids[s]),
            gidx=dev(plan.gather_idx[s], torch.int64) if fb else None,
            starts=dev(launch.slice_starts),
            local=dev(launch.local_offset),
            full=dev(launch.full_mask)))
    return out


def run_launch(plan: BlockPlan, cm: LaunchMeta, gathered: list,
               elem: list, out: torch.Tensor | None = None,
               rows_per_step: int = 1) -> torch.Tensor:
    """Stage A of one launch into ``out`` (its (Bc, N, ...) rows of the
    lanes tensor).  ``gathered`` are the (data_len, ...) mutable arrays in
    seed order, ``elem`` the launch's (Bc, N) elementwise blocks."""
    seed = plan.seed
    launch = cm.launch
    if launch.gather == ir.FALLBACK and seed.gather_index is not None:
        # native gather + ladder as torch ops (the reference's XLA segment)
        vals = {g: arr[cm.gidx] for g, arr in zip(seed.gathered, gathered)}
        rank = max(v.ndim for v in vals.values())
        vals.update((e, common.expand_trailing(v, rank))
                    for e, v in zip(seed.elementwise, elem))
        return common.write_out(common.ladder_tail(
            seed.combine(vals), cm.seg, launch.op_flag, seed.reduce, cm.full),
            out)
    require_kernel_combine(seed)
    if launch.gather == ir.COALESCED:
        return dense_slice_stage_a(
            cm.starts, gathered, elem, cm.local, cm.seg, op=launch.op_flag,
            reduce=seed.reduce, full_flags=cm.full,
            rows_per_step=rows_per_step, out=out)
    return window_stage_a(
        cm.win, gathered, elem, cm.slot, cm.off, cm.seg, op=launch.op_flag,
        stream=launch.stream, reduce=seed.reduce, full_flags=cm.full,
        rows_per_step=rows_per_step, out=out)


def make_stage_a(plan: BlockPlan, elem_exec, device: torch.device,
                 launches: list[ir.Launch] | None = None,
                 kernel_params: dict | None = None):
    seed = plan.seed
    require_kernel_combine(seed)
    kp = kernel_params or {}
    rows_per_step = int(kp.get("rows_per_step") or 1)
    if launches is None:
        launches = ir.lower(plan, backend="cuda").launches
    launch_meta = stage_launch_meta(plan, launches, device)

    def stage_a(mutable):
        gathered = [mutable[g] for g in seed.gathered]
        dtype = functools.reduce(torch.promote_types, [
            *(g.dtype for g in gathered),
            *(elem_exec[e].dtype for e in seed.elementwise)])
        trailing = tuple(gathered[0].shape[1:]) if gathered else ()
        lanes = torch.empty((plan.num_blocks, plan.lane_width) + trailing,
                            dtype=dtype, device=device)
        for cm in launch_meta:
            s = slice(cm.launch.start, cm.launch.stop)
            elem = [elem_exec[e][s] for e in seed.elementwise]
            run_launch(plan, cm, gathered, elem, out=lanes[s],
                       rows_per_step=rows_per_step)
        return lanes

    stage_a.launch_meta = launch_meta
    return stage_a
