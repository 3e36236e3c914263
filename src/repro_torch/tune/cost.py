"""Analytical candidate pre-pruner driven by feature-table statistics.

A port of the JAX package's ``tune/cost.py``: the arithmetic is the
reference's, with its backend names mapped (``torch`` for ``jax``,
``cuda`` for ``pallas``), so on the ``"cpu"`` platform every prediction
and ranking equals the reference's exactly.  One constant is the port's
own: :data:`CUDA_SCALE` scales a ``cuda`` candidate on the ``"cuda"``
platform, where the reference would apply ``INTERPRET_SCALE`` to any
platform but ``"tpu"`` and so predict the hand kernels 200x too slow.

Measuring every candidate on-device is exact but linear in the space, and
the space multiplies (plan knobs x backends x write-backs).  This module
ranks candidates *analytically* from statistics the plan build already
produced — ``PlanStats`` is the feature table's per-matrix summary — and
cuts the measured set to a top-K.  The model is a pruning heuristic, not
an oracle: constants are coarse (launch dispatch overhead vs per-lane
streaming work, re-derived from the checked-in BENCH_spmv.json
trajectory), and the final choice always comes from real measurements in
:mod:`repro_torch.tune.search`.  What the model must get right is only the
*order of magnitude* separation — e.g. a 36-class power-law plan pays
``36 x launch_overhead`` per call in per-class form, which no per-lane
constant can buy back, so per-class configurations rank last there and
are pruned without ever being timed.

Everything here is a pure function of a :class:`BlockPlan` — ranking is
deterministic given a plan (pinned by tests).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import feature_table as ft
from repro_torch.core import ir
from repro_torch.core.plan import BlockPlan
from repro_torch.tune.space import Candidate

# --- model constants (microseconds / per-element nanoseconds, XLA-CPU
# scale; see module docstring for why coarseness is acceptable)
LAUNCH_US = 12.0          # per-launch dispatch + assembly overhead
GATHER_NS = 4.0           # native dynamic gather, per lane
WINDOW_NS = 2.0           # tile-load + lane-select path, per lane per window
STREAM_NS = 1.0           # pure vload (stream) copy, per lane
SLICE_NS = 1.5            # coalesced dense slice load + static permute
LADDER_NS = 2.0           # one masked shift-reduce step, per lane
HEAD_NS = 8.0             # stage-B head re-gather + unique-row scatter
DENSE_NS = 6.0            # stage-B dense scatter, per lane (incl. pads)
SEGSUM_NS = 5.0           # single sorted segment reduce, per lane
PALLAS_TPU_SCALE = 0.35   # reference: VMEM/MXU path vs XLA-CPU per-lane work
INTERPRET_SCALE = 200.0   # kernels' plain versions off the card: never fast
# the hand-written stage-A kernels on the card vs the model's per-lane
# work (the port's counterpart of PALLAS_TPU_SCALE): measured/predicted
# time of the fused window-kernel candidate over that of the fused torch
# one on the pwtk and webbase-1M analogues, geometric mean over the two
# (`python -m repro_torch.tune.calibrate` on an NVIDIA H100 80GB HBM3,
# 700 W; PERF.md section 5)
CUDA_SCALE = 0.13
SHARD_COLLECTIVE_US = 25.0  # per-participant all-gather/psum exchange
STEP_NS = 3.0             # kernel per-step dispatch, per block row
META_NS = 1.0             # reference: per-block metadata DMA issue


@dataclasses.dataclass(frozen=True)
class PlanFeatures:
    """Per-matrix decision features, distilled from the feature table /
    plan statistics (paper Table 6's opportunity summary, plus the launch
    fragmentation the fused executor targets)."""

    nnz: int
    lane_width: int
    num_blocks: int
    lanes_total: int           # num_blocks * lane_width (incl. pad lanes)
    num_classes: int
    num_fused_launches: int    # len(fused_xla_classes)
    num_pallas_sections: int   # len(fused_sections): the cuda form, 1 or 2
    fallback_frac: float       # fraction of blocks on the native-gather path
    stream_frac: float         # fraction of blocks in pure-vload classes
    full_reduce_frac: float    # op_hist[FULL_REDUCE]
    mean_op_steps: float       # ladder depth, FULL_REDUCE counted as 1
    mean_windows: float        # mean ls over vload blocks
    heads_per_nnz: float       # RMW writes after reduction merge / nnz
    heads_per_lane: float      # heads / lanes_total (write density)
    nnz_per_row: float         # nnz / out_len (skew summary)
    coalesced_frac: float = 0.0  # nnz reachable by ir.coalesce_gathers

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def plan_features(plan: BlockPlan) -> PlanFeatures:
    st = plan.stats
    lanes = plan.num_blocks * plan.lane_width
    stream_blocks = sum(c.num_blocks for c in plan.classes if c.stream)
    full = st.op_hist.get(ft.FULL_REDUCE, 0.0)
    mean_op = sum((1.0 if k == ft.FULL_REDUCE else float(k)) * v
                  for k, v in st.op_hist.items())
    vload = {k: v for k, v in st.ls_hist.items() if k > 0}
    vfrac = sum(vload.values())
    mean_windows = (sum(k * v for k, v in vload.items()) / vfrac
                    if vfrac else 0.0)
    return PlanFeatures(
        nnz=st.nnz, lane_width=plan.lane_width, num_blocks=plan.num_blocks,
        lanes_total=lanes, num_classes=st.num_classes,
        num_fused_launches=len(ir.fused_xla_classes(plan)),
        num_pallas_sections=len(ir.fused_sections(plan)),
        fallback_frac=1.0 - st.replaced_gather_frac,
        stream_frac=stream_blocks / max(plan.num_blocks, 1),
        full_reduce_frac=full, mean_op_steps=mean_op,
        mean_windows=mean_windows,
        heads_per_nnz=st.heads_total / max(st.nnz, 1),
        heads_per_lane=st.heads_total / max(lanes, 1),
        nnz_per_row=st.nnz / max(plan.out_len, 1),
        coalesced_frac=ir.coalesce_stats(plan)["coalesced_fraction"])


def _stage_a_ns_per_lane(c: Candidate, f: PlanFeatures) -> float:
    """Gather + ladder work per lane for the torch/cuda stage A."""
    if c.fused and c.backend == "torch":
        # fused XLA op-groups gather directly through gather_idx
        gather = GATHER_NS
    else:
        gather = (f.fallback_frac * GATHER_NS
                  + f.stream_frac * STREAM_NS
                  + max(1.0 - f.fallback_frac - f.stream_frac, 0.0)
                  * (WINDOW_NS * max(f.mean_windows, 1.0)))
    if c.coalesce and c.backend in ("torch", "cuda"):
        # the coalesced share of lanes trades its gather for a dense
        # slice load (the pass is a no-op on the rest); both
        # lane-granular emitters lower the rewritten launches now
        gather = ((1.0 - f.coalesced_frac) * gather
                  + f.coalesced_frac * SLICE_NS)
    # exact per-group ladder depth in every mode (exec order groups by op);
    # FULL_REDUCE blocks pay the pairwise tree (~2 combines/lane on XLA).
    ladder = LADDER_NS * (f.mean_op_steps
                          + f.full_reduce_frac * 1.0)
    return gather + ladder


def _stage_b_us(c: Candidate, f: PlanFeatures) -> float:
    if c.stage_b == "dense":
        return f.lanes_total * DENSE_NS * 1e-3
    heads = f.heads_per_lane * f.lanes_total
    return heads * HEAD_NS * 1e-3


def predict_us(c: Candidate, f: PlanFeatures, platform: str = "cpu"
               ) -> float:
    """Predicted steady-state microseconds per call for one candidate.

    Only relative order matters (the measurement pass owns the absolute
    numbers); the dominant terms are launch fragmentation
    (``num_classes`` vs ``num_fused_launches``) and per-lane streaming
    work scaled by the feature-table histograms.
    """
    if c.backend == "segsum":
        us = LAUNCH_US + f.lanes_total * SEGSUM_NS * 1e-3
        return _shard_scale(c, us)
    launches = (f.num_fused_launches if c.fused else f.num_classes)
    if c.backend == "cuda":
        launches = (f.num_pallas_sections if c.fused else f.num_classes)
    us = (LAUNCH_US * launches
          + f.lanes_total * _stage_a_ns_per_lane(c, f) * 1e-3
          + _stage_b_us(c, f))
    if c.backend == "cuda":
        # per-launch kernel params (DESIGN.md §13): packing more block
        # rows per grid step amortizes step dispatch, deeper metadata
        # prefetch tiles amortize the per-block DMA issue.  Modeled on
        # the requested upper bound — the realized divisor only helps.
        rows = c.kernel_rows or 1
        prefetch = c.kernel_prefetch or 1
        us += f.num_blocks * (STEP_NS / rows + META_NS / prefetch) * 1e-3
        us *= backend_scale(c, platform)
    return _shard_scale(c, us)


def backend_scale(c: Candidate, platform: str) -> float:
    """The factor :func:`predict_us` applies to ``c``'s modelled work for
    its backend on ``platform``: 1 but for a ``cuda`` candidate."""
    if c.backend != "cuda":
        return 1.0
    return CUDA_SCALE if platform == "cuda" else INTERPRET_SCALE


def _shard_scale(c: Candidate, us: float) -> float:
    """Sharded execution (DESIGN.md §10): per-lane work runs concurrently
    across the mesh (divide by shards — coarse: assumes the nnz-balanced
    cuts landed even), while the per-sweep input exchange costs one
    all-gather whose bill grows with participant count.  Single-device
    candidates pass through untouched, keeping every pre-§10 ranking
    bitwise stable."""
    if c.shards <= 1:
        return us
    return us / c.shards + LAUNCH_US + SHARD_COLLECTIVE_US * c.shards


def rank_candidates(candidates: list[Candidate],
                    features_by_plan: dict,
                    platform: str = "cpu",
                    top_k: int | None = None) -> list[tuple]:
    """Rank ``candidates`` by :func:`predict_us` (stable on ties — the
    declared space order breaks them deterministically) and cut to the
    top-K measured set.  ``features_by_plan`` maps
    :attr:`Candidate.plan_key` -> :class:`PlanFeatures`.

    Returns ``[(candidate, predicted_us), ...]`` best-first.
    """
    scored = [(c, predict_us(c, features_by_plan[c.plan_key], platform))
              for c in candidates]
    ranked = sorted(scored, key=lambda t: t[1])
    if top_k is not None:
        ranked = ranked[:max(top_k, 1)]
    return ranked
