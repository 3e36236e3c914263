"""Information-code-tree IR — the paper's explicit lowering pipeline.

The paper lowers a *code seed* through an information-code tree before
vectorized code is emitted: the seed fixes the computation, the feature
table supplies per-block pattern information, and a sequence of tree
transformations decides what machine idiom each region of the iteration
space compiles to.  Until this module that tree was implicit — fusing,
write-back selection, and gather lowering were hard-wired inside
``engine.make_sweeper`` (and duplicated by ``spmm``).  Here it is explicit
and composable:

* :class:`Launch` — one leaf of the tree: a contiguous exec-order block
  range ``[start, stop)`` plus the *gather idiom* it lowers to
  (``fallback`` native gather / ``window`` aligned tile loads + permute /
  ``stream`` pure vload / ``coalesced`` dense unaligned slice loads) and
  the reduce ladder depth (``op_flag``).
* :class:`CodeTree` — the whole lowered program: the launch list, the
  resolved write-back, and the provenance of each pass that ran.
* Passes — pure functions ``CodeTree -> CodeTree``, applied in a fixed
  legal order by :func:`lower`:

  1. :func:`fuse_sections` — collapse the per-class launch list into the
     backend's fused form (op-groups on the torch emitter / at most two
     kernel sections with per-block native-reduce masks on the cuda
     backend).  Legality: DESIGN.md §3.
  2. :func:`choose_stage_b` — resolve the write-back (``auto`` ->
     collision-free ``gather``; both backends share both forms).
  3. :func:`coalesce_gathers` — the run-detection pass (DESIGN.md §8):
     blocks whose post-sort gather indices span less than one lane width
     are re-lowered from per-lane gathers to ONE dense slice load each
     (plus a static in-tile permutation when the run is not contiguous).
     Bitwise-identical by construction: the slice+permute reads exactly
     the words the gather read, and everything downstream (ladder,
     write-back) is untouched.

A port of the JAX package's ``core/ir.py``.  Every pass makes exactly the
reference's decisions: the port's ``"torch"`` backend lowers as the
reference's ``"jax"`` backend and ``"cuda"`` as its ``"pallas"`` backend
(:data:`LOWERING_FORMS`, the one place the names are mapped), so the
lowered launch lists are equal field for field.

The backend emitters in :mod:`repro_torch.core.engine` only *walk* the
lowered tree; they make no lowering decisions of their own.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import feature_table as ft
from repro_torch.core.plan import GATHER_FALLBACK, BlockPlan, PatternClass
from repro_torch.obs import trace as _trace

# gather idioms a Launch can lower to
FALLBACK = "fallback"     # native per-lane gather through gather_idx
WINDOW = "window"         # ls aligned lane-tile loads + (slot, offset) permute
STREAM = "stream"         # single aligned tile, identity permutation
COALESCED = "coalesced"   # one unaligned dense slice load (+ static permute)

# The port's backend names -> the lowering form each one takes.  "xla" is
# the reference's jax-backend lowering (per-op-group launches through the
# native gather), "kernel" its pallas-backend lowering (at most two fused
# sections, per-block native-reduce masks), "fold" its segsum lowering
# (the per-class launch list kept as built, stage A+B folded into one
# segment reduce, no coalescing).  The passes below test the form, never
# a backend name.
LOWERING_FORMS = {"torch": "xla", "cuda": "kernel", "segsum": "fold"}


def lowering_form(backend: str) -> str:
    try:
        return LOWERING_FORMS[backend]
    except KeyError:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{sorted(LOWERING_FORMS)}") from None


@dataclasses.dataclass(frozen=True, eq=False)
class Launch:
    """One leaf of the information-code tree: a contiguous exec-order
    block range lowered to a single launch of one gather idiom + one
    reduce-ladder depth."""

    start: int
    stop: int
    ls_flag: int
    op_flag: int              # ft.FULL_REDUCE or ladder depth
    stream: bool
    gather: str               # FALLBACK | WINDOW | STREAM | COALESCED
    # COALESCED operands (static, derived from immutable access arrays):
    slice_starts: np.ndarray | None = None   # (Bc,) int64 clamped bases
    local_offset: np.ndarray | None = None   # (Bc, N) int32; None == identity
    # kernel-form fused sections: per-block native-reduction flags
    full_mask: np.ndarray | None = None

    @property
    def num_blocks(self) -> int:
        return self.stop - self.start


@dataclasses.dataclass
class CodeTree:
    """The lowered information-code tree for one (seed, plan, backend)."""

    plan: BlockPlan
    backend: str                       # "torch" | "segsum" | "cuda"
    launches: list[Launch]
    stage_b: str = "auto"              # resolved by choose_stage_b
    passes: tuple[str, ...] = ()       # provenance, in application order
    # per-pass tree-shape deltas, parallel to ``passes``: each entry is a
    # dict with the pass name and its launch count before/after — the
    # quantitative companion to the provenance tuple (DESIGN.md §11)
    pass_deltas: tuple = ()

    @property
    def seed(self):
        return self.plan.seed

    def _with(self, **kw) -> "CodeTree":
        return dataclasses.replace(self, **kw)

    def _after_pass(self, name: str, launches_before: int,
                    **extra) -> "CodeTree":
        """Stamp one pass into ``passes`` + ``pass_deltas`` (call on the
        ALREADY-transformed tree)."""
        delta = {"pass": name, "launches_before": launches_before,
                 "launches_after": len(self.launches), **extra}
        return dataclasses.replace(
            self, passes=self.passes + (name,),
            pass_deltas=self.pass_deltas + (delta,))


def _launch_of_class(c: PatternClass) -> Launch:
    if c.ls_flag == GATHER_FALLBACK:
        kind = FALLBACK
    else:
        kind = STREAM if c.stream else WINDOW
    return Launch(start=c.start, stop=c.stop, ls_flag=c.ls_flag,
                  op_flag=c.op_flag, stream=c.stream, gather=kind)


def build_tree(plan: BlockPlan, backend: str = "torch") -> CodeTree:
    """The un-lowered tree: one launch per pattern class, in exec order
    (the paper's per-class specialized form)."""
    lowering_form(backend)
    tree = CodeTree(plan=plan, backend=backend,
                    launches=[_launch_of_class(c) for c in plan.classes])
    return tree._after_pass("build", 0)


# --------------------------------------------------------------- fusing
# Fusing is a dispatch/fragmentation optimization: below this many pattern
# classes the per-class specialized launches (stream copies, narrow window
# loads) are already optimal and merging only costs padding, so the fused
# mode keeps them (measured on the small suite, DESIGN.md §3).
FUSE_MIN_CLASSES = 4


def _merge_section(classes: list[PatternClass], ls_flag: int,
                   lane_width: int) -> PatternClass:
    """Collapse contiguous pattern classes into one fused launch section.

    The merged ``op_flag`` is the ladder depth covering every member class:
    extra shift-reduce steps are exact no-ops (DESIGN.md §3), and window
    slots beyond a block's own ``ls`` are never selected by its lane
    permutation (``window_ids`` padding repeats the last valid window).
    """
    full = int(math.ceil(math.log2(max(lane_width, 2))))
    if all(c.op_flag == ft.FULL_REDUCE for c in classes):
        op = ft.FULL_REDUCE
    else:
        op = max(full if c.op_flag == ft.FULL_REDUCE else c.op_flag
                 for c in classes)
    return PatternClass(ls_flag=ls_flag, op_flag=op,
                        stream=all(c.stream for c in classes),
                        start=min(c.start for c in classes),
                        stop=max(c.stop for c in classes))


def fused_sections(plan: BlockPlan) -> list[PatternClass]:
    """The fused launch list for the kernel form: at most one
    gather-fallback section plus one vload section (class binning sorts
    fallback classes first, so each section is a contiguous exec-order
    block range)."""
    fb = [c for c in plan.classes if c.ls_flag == GATHER_FALLBACK]
    vl = [c for c in plan.classes if c.ls_flag != GATHER_FALLBACK]
    sections = []
    for group, ls in ((fb, GATHER_FALLBACK),
                      (vl, max((c.ls_flag for c in vl), default=0))):
        if not group:
            continue
        sec = _merge_section(group, ls, plan.lane_width)
        assert sec.num_blocks == sum(c.num_blocks for c in group), \
            "pattern classes of one section must be exec-contiguous"
        sections.append(sec)
    return sections


def fused_xla_classes(plan: BlockPlan) -> list[PatternClass]:
    """The fused launch list for the xla form: adjacent pattern classes
    merged by ``op_flag`` into op-groups that gather directly through the
    post-sort ``gather_idx``.  On XLA the tile-granular window loads lower
    to a gather HLO over the identical float words, so a merged group loses
    nothing semantically (bitwise-equal to the per-class launches); and
    because ``op`` is the minor exec-order key, same-depth blocks are
    contiguous — each block gets exactly the shift-reduce depth its class
    needs, in at most ``2 * (log2(N) + 2)`` static slices of one jitted
    graph instead of one launch per (ls, op, stream) class.

    Fragmented plans (many small classes — the irregular inputs the paper
    targets) collapse ~10x; plans already at a handful of launches keep
    their per-class specializations, so the fused mode never regresses the
    regular inputs where per-class stream/window forms are the best code.
    """
    groups: list[PatternClass] = []
    for c in plan.classes:
        if groups and groups[-1].op_flag == c.op_flag \
                and groups[-1].stop == c.start:
            prev = groups[-1]
            groups[-1] = PatternClass(ls_flag=GATHER_FALLBACK,
                                      op_flag=prev.op_flag, stream=False,
                                      start=prev.start, stop=c.stop)
        else:
            groups.append(PatternClass(ls_flag=GATHER_FALLBACK,
                                       op_flag=c.op_flag, stream=False,
                                       start=c.start, stop=c.stop))
    if len(plan.classes) <= max(FUSE_MIN_CLASSES, 2 * len(groups)):
        return list(plan.classes)
    return groups


def section_full_mask(plan: BlockPlan, sec: PatternClass) -> np.ndarray | None:
    """Per-block native-reduction flags for a fused section: True where the
    covering pattern class is ``FULL_REDUCE`` (single-segment block), so the
    fused launch can keep the architecture-native reduction for exactly the
    blocks the per-class path would give it to.  None when the section has
    no such member (or is itself pure ``FULL_REDUCE``)."""
    if sec.op_flag == ft.FULL_REDUCE:
        return None
    mask = np.zeros(sec.num_blocks, dtype=bool)
    for c in plan.classes:
        if (c.op_flag == ft.FULL_REDUCE
                and c.start >= sec.start and c.stop <= sec.stop):
            mask[c.start - sec.start:c.stop - sec.start] = True
    return mask if mask.any() else None


def fuse_sections(tree: CodeTree) -> CodeTree:
    """Pass 1: collapse the per-class launch list into the backend's fused
    launch form.  No-op for the fold form (the segsum emitter folds the
    whole plan into one segment reduce regardless of the launch list)."""
    plan = tree.plan
    form = lowering_form(tree.backend)
    if form == "kernel":
        launches = []
        for sec in fused_sections(plan):
            launch = _launch_of_class(sec)
            launches.append(dataclasses.replace(
                launch, full_mask=section_full_mask(plan, sec)))
    elif form == "xla":
        launches = [_launch_of_class(c) for c in fused_xla_classes(plan)]
    else:
        launches = tree.launches
    return tree._with(launches=launches)._after_pass(
        "fuse_sections", len(tree.launches))


# -------------------------------------------------------------- stage B
_STAGE_BS = ("gather", "dense")


def choose_stage_b(tree: CodeTree, stage_b: str = "auto") -> CodeTree:
    """Pass 2: resolve the write-back node.

    ``auto`` always lowers to the collision-free gather write-back: it is
    the only form with a cross-program bitwise guarantee (DESIGN.md §3).
    The dense head-buffer scatter stays explicit opt-in.  The fold form
    has no separate stage B (stage A+B are ONE segment reduce): its node
    is ``fold``, and explicit gather/dense requests are still validated
    so a typo fails identically on every backend."""
    if stage_b == "auto":
        resolved = "gather"
    elif stage_b in _STAGE_BS:
        resolved = stage_b
    else:
        raise ValueError(f"unknown stage_b {stage_b!r}")
    if lowering_form(tree.backend) == "fold":
        resolved = "fold"
    return tree._with(stage_b=resolved)._after_pass(
        "choose_stage_b", len(tree.launches), stage_b=resolved)


# ---------------------------------------------------- gather coalescing
# A coalescible run shorter than this many blocks is not worth splitting
# a launch for: each split adds one slice/gather op pair to the program,
# and a handful of blocks cannot amortize it.  A launch that is
# coalescible IN FULL is always converted (no split, no new launch).
MIN_COALESCE_RUN = 4


def coalesce_gathers(tree: CodeTree,
                     min_run_blocks: int = MIN_COALESCE_RUN) -> CodeTree:
    """Pass 3 (DESIGN.md §8): re-lower gather launches whose blocks hold
    contiguous/strided index runs to dense unaligned slice loads.

    For every ``fallback`` / ``window`` launch, the post-sort gather
    indices of each block are tested with
    :func:`feature_table.gather_run_features`: a block whose whole index
    footprint spans less than one lane width is served by ONE dense
    slice of ``lane_width`` elements from a clamped base,
    plus a static in-tile permutation (``None`` when the run is exactly
    ``base + iota`` — then the slice IS the lane vector).  Launches are
    split at eligibility boundaries into maximal runs, keeping exec-order
    contiguity; ineligible remainders keep their original idiom.

    Legality / bitwise argument: the slice covers ``[base, base + N)`` of
    the same padded dense view the window path reads, every lane's value
    is the identical word ``x[gather_idx]`` the gather fetched (the clamp
    in ``gather_run_features`` keeps offsets exact at the right edge), and
    the ladder/write-back downstream are untouched — so a coalesced
    program is bitwise-equal to its un-coalesced form, which the tests pin
    against the scatter oracle.  ``stream`` launches qualify trivially
    (an aligned identity run IS a contiguous run — they lower to the pure
    slice form with no permutation).  Both emitters consume the rewritten
    launches: the torch emitter as indexed slices of the flat view, the
    cuda backend as the dense-slice kernel.  The fold form and a seed with
    no gather index skip the pass.
    """
    if lowering_form(tree.backend) == "fold" \
            or tree.seed.gather_index is None:
        return tree._after_pass("coalesce_gathers:skip",
                                len(tree.launches))
    plan = tree.plan
    out: list[Launch] = []
    for launch in tree.launches:
        if launch.gather not in (FALLBACK, WINDOW, STREAM) \
                or launch.num_blocks == 0:
            out.append(launch)
            continue
        gidx = plan.gather_idx[launch.start:launch.stop]
        runs = ft.gather_run_features(gidx, plan.lane_width, plan.data_len)
        if not runs.coalescible.any():
            out.append(launch)
            continue
        out.extend(_split_launch(launch, runs, gidx, min_run_blocks))
    return tree._with(launches=out)._after_pass(
        "coalesce_gathers", len(tree.launches),
        coalesced_launches=sum(1 for la in out if la.gather == COALESCED))


def _split_launch(launch: Launch, runs: ft.GatherRunFeatures,
                  gidx: np.ndarray, min_run_blocks: int) -> list[Launch]:
    """Split one launch into maximal coalescible / residual sub-ranges."""
    n_blocks = launch.num_blocks
    elig = runs.coalescible
    if elig.all():
        min_run_blocks = 1          # full conversion never splits
    # maximal runs of equal eligibility
    bounds = np.flatnonzero(np.diff(elig.astype(np.int8))) + 1
    edges = np.concatenate([[0], bounds, [n_blocks]])
    keep = elig.copy()
    for lo, hi in zip(edges[:-1], edges[1:]):
        if elig[lo] and (hi - lo) < min_run_blocks:
            keep[lo:hi] = False     # too short to carve out
    if not keep.any():
        return [launch]
    bounds = np.flatnonzero(np.diff(keep.astype(np.int8))) + 1
    edges = np.concatenate([[0], bounds, [n_blocks]])
    parts = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        # per-block arrays must follow the block range: a fused kernel
        # section carries (Bc,) native-reduce flags on full_mask
        mask = launch.full_mask
        sub = dataclasses.replace(
            launch, start=launch.start + int(lo),
            stop=launch.start + int(hi),
            full_mask=None if mask is None else mask[lo:hi])
        if keep[lo]:
            base = runs.base[lo:hi]
            off = None
            if not runs.identity[lo:hi].all():
                off = (gidx[lo:hi] - base[:, None]).astype(np.int32)
            sub = dataclasses.replace(sub, gather=COALESCED,
                                      slice_starts=base.astype(np.int64),
                                      local_offset=off)
        parts.append(sub)
    return parts


# -------------------------------------------------------------- pipeline
def lower(plan: BlockPlan, backend: str = "torch", fused: bool = True,
          stage_b: str = "auto", coalesce: bool = False) -> CodeTree:
    """The full lowering pipeline: build the per-class tree, then apply
    the passes in their one legal order (fuse before coalesce — the
    run detector sees the launch ranges that will actually execute;
    stage-B choice is independent but resolved before emission so every
    emitter sees a concrete write-back node).

    When tracing is enabled every pass gets its own ``ir.pass.*`` span
    whose attributes carry the launch-count delta — the same numbers
    stamped into ``tree.pass_deltas`` alongside the ``tree.passes``
    provenance."""
    with _trace.span("ir.lower", backend=backend, fused=fused,
                     coalesce=coalesce) as sp:
        with _trace.span("ir.pass.build") as s:
            tree = build_tree(plan, backend)
            s.set(**tree.pass_deltas[-1])
        if fused:
            with _trace.span("ir.pass.fuse_sections") as s:
                tree = fuse_sections(tree)
                s.set(**tree.pass_deltas[-1])
        with _trace.span("ir.pass.choose_stage_b") as s:
            tree = choose_stage_b(tree, stage_b)
            s.set(**tree.pass_deltas[-1])
        if coalesce:
            with _trace.span("ir.pass.coalesce_gathers") as s:
                tree = coalesce_gathers(tree)
                s.set(**tree.pass_deltas[-1])
        sp.set(launches=len(tree.launches), passes=",".join(tree.passes))
    return tree


# ------------------------------------------------------------ partition
@dataclasses.dataclass
class PlanShard:
    """One shard of a partitioned CodeTree: the contiguous output-row
    range ``[row_start, row_stop)`` it owns, the parent exec-order block
    positions assigned to it (ascending — the parent's exec-order
    invariant restricted to the shard), and the per-shard subtree whose
    plan/launches were SLICED from the parent's lowered artifacts
    (re-derived, not re-binned: no feature analysis runs again).

    The shard plan's ``out_len`` is local (``num_rows``) with
    ``head_rows`` rebased to it; ``data_len``, ``gather_idx`` and
    ``flat_perm`` stay GLOBAL — every shard gathers from the full dense
    input (the all-gathered vector in the sharded fixpoint drivers) and
    reorders the full nnz-aligned elementwise arrays.  ``plan.nnz`` is
    therefore also the PARENT's nnz (it is the pad sentinel of
    ``flat_perm`` into the full arrays), while the shard's own lane
    count lives in ``plan.stats.nnz``."""

    index: int
    num_shards: int
    row_start: int
    row_stop: int
    block_ids: np.ndarray          # (Bs,) int64 parent exec block positions
    tree: CodeTree

    @property
    def num_rows(self) -> int:
        return self.row_stop - self.row_start

    @property
    def num_blocks(self) -> int:
        return int(self.block_ids.shape[0])


def _block_row_spans(plan: BlockPlan) -> tuple[np.ndarray, np.ndarray]:
    """Per exec block: (min, max) output row written by its heads.
    Blocks with no heads (all-pad) report ``(out_len, -1)``."""
    b = plan.num_blocks
    hb = plan.head_pos // plan.lane_width
    row_min = np.full(b, plan.out_len, np.int64)
    row_max = np.full(b, -1, np.int64)
    np.minimum.at(row_min, hb, plan.head_rows)
    np.maximum.at(row_max, hb, plan.head_rows)
    return row_min, row_max


def legal_cuts(plan: BlockPlan) -> np.ndarray:
    """Sorted row positions ``r`` where the plan may be split: no block
    writes both a row ``< r`` and a row ``>= r`` (a block's whole head
    span must land in one shard so its byte-identical block program runs
    exactly once, on the shard that owns its rows).  Always contains 0
    and ``out_len``.  Row-major-sorted inputs (every generator, the
    validators' canonical output) give a cut at nearly every row; an
    adversarially interleaved input degrades to fewer cuts — partitioning
    then yields imbalanced (possibly empty) shards, never a wrong one."""
    n = plan.out_len
    row_min, row_max = _block_row_spans(plan)
    has_heads = row_max >= 0
    # cut r is illegal iff some block's span straddles it:
    # r in [row_min + 1, row_max] <=> half-open [row_min + 1, row_max + 1)
    mark = np.zeros(n + 2, np.int64)
    np.add.at(mark, row_min[has_heads] + 1, 1)
    np.add.at(mark, row_max[has_heads] + 1, -1)
    illegal = np.cumsum(mark)[: n + 1] > 0
    return np.flatnonzero(~illegal).astype(np.int64)


def _per_row_nnz(plan: BlockPlan) -> np.ndarray:
    """(out_len,) valid-lane count per output row, reconstructed from the
    head structure: within a block, pads sort to the front and rows
    ascend, so forward max-filling ``head_rows`` scattered at
    ``head_pos`` labels every valid lane with its row."""
    b, n = plan.num_blocks, plan.lane_width
    rows = np.full(b * n, -1, np.int64)
    rows[plan.head_pos] = plan.head_rows
    rows = np.maximum.accumulate(rows.reshape(b, n), axis=1)
    lane_rows = rows.reshape(-1)[plan.valid.reshape(-1)]
    return np.bincount(lane_rows, minlength=plan.out_len)


def _pick_cuts(plan: BlockPlan, shards: int) -> np.ndarray:
    """(shards + 1,) non-decreasing legal row cuts, 0 and out_len at the
    ends, interior cuts chosen nearest to the nnz-balanced targets."""
    cuts_ok = legal_cuts(plan)
    cum = np.concatenate([[0], np.cumsum(_per_row_nnz(plan))])
    total = int(cum[-1])
    load_at = cum[cuts_ok].astype(np.float64)
    cuts = np.empty(shards + 1, np.int64)
    cuts[0], cuts[shards] = 0, plan.out_len
    lo = 0                            # index into cuts_ok; keeps cuts sorted
    for i in range(1, shards):
        target = total * i / shards
        j = int(np.argmin(np.abs(load_at[lo:] - target))) + lo
        cuts[i] = cuts_ok[j]
        lo = j
    return cuts


def _slice_blockwise(a: np.ndarray, ids: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a[ids])


def _shard_launches(parent: list[Launch], ids: np.ndarray,
                    pos_in_shard: np.ndarray) -> list[Launch]:
    """Restrict a lowered launch list to the shard's block set.  ``ids``
    is sorted, and parent launches cover disjoint contiguous exec
    ranges, so each parent launch maps to AT MOST one shard launch whose
    blocks are contiguous in the shard's own exec order; COALESCED
    operands and kernel-form ``full_mask`` are sliced by membership."""
    out: list[Launch] = []
    for launch in parent:
        members = ids[(ids >= launch.start) & (ids < launch.stop)]
        if members.size == 0:
            continue
        local = members - launch.start       # positions within the launch
        start = int(pos_in_shard[members[0]])
        sub = dataclasses.replace(
            launch, start=start, stop=start + int(members.size),
            slice_starts=(None if launch.slice_starts is None
                          else launch.slice_starts[local]),
            local_offset=(None if launch.local_offset is None
                          else launch.local_offset[local]),
            full_mask=(None if launch.full_mask is None
                       else launch.full_mask[local]))
        out.append(sub)
    return out


def _shard_classes(parent: list[PatternClass], ids: np.ndarray,
                   pos_in_shard: np.ndarray) -> list[PatternClass]:
    out: list[PatternClass] = []
    for c in parent:
        members = ids[(ids >= c.start) & (ids < c.stop)]
        if members.size == 0:
            continue
        start = int(pos_in_shard[members[0]])
        out.append(dataclasses.replace(c, start=start,
                                       stop=start + int(members.size)))
    return out


def partition_plan(tree: CodeTree, shards: int) -> list[PlanShard]:
    """Split one lowered CodeTree into ``shards`` per-shard subtrees
    along a disjoint row tiling of ``[0, out_len)``.

    Every parent exec-order block is assigned to exactly ONE shard (the
    owner of its head-row span; blocks with no heads go to shard 0), and
    shards keep their blocks in ascending parent exec position — so the
    per-shard launch lists partition the parent's exec order.  Per-shard
    plans are sliced from the parent's already-analyzed arrays and the
    parent's already-lowered launch list (feature tables re-derived, not
    re-binned: no ``reduce_features``/``gather_features`` pass runs
    again), which is what makes the per-row combine programs of a shard
    byte-identical to the parent's — the bitwise argument in DESIGN.md
    §10.  Shards may own zero rows or zero blocks when the input lacks
    enough legal cuts (the emitters run those as identity sweeps)."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1 (got {shards})")
    if tree.backend == "cuda":
        raise ValueError(
            "partition_plan: the cuda backend is single-device (its "
            "kernels run on one card); use backend='torch' or 'segsum' "
            "for sharded execution")
    plan = tree.plan
    b, n = plan.num_blocks, plan.lane_width
    with _trace.span("ir.partition_plan", shards=shards,
                     num_blocks=b) as sp:
        out = _partition_plan_impl(tree, plan, b, n, shards)
        sp.set(shard_blocks=",".join(str(p.num_blocks) for p in out),
               shard_rows=",".join(str(p.num_rows) for p in out))
    return out


def _partition_plan_impl(tree: CodeTree, plan: BlockPlan, b: int, n: int,
                         shards: int) -> list[PlanShard]:
    cuts = _pick_cuts(plan, shards)
    row_min, row_max = _block_row_spans(plan)
    # owner shard per block: the range containing its row span (legal
    # cuts guarantee the span never straddles); head-less blocks -> 0
    owner = np.searchsorted(cuts[1:-1], row_min, side="right")
    owner[row_max < 0] = 0
    hb = plan.head_pos // n
    head_owner = owner[hb] if plan.head_pos.size else np.zeros(0, np.int64)

    out: list[PlanShard] = []
    for s in range(shards):
        ids = np.flatnonzero(owner == s).astype(np.int64)
        lo, hi = int(cuts[s]), int(cuts[s + 1])
        pos_in_shard = np.full(b, -1, np.int64)
        pos_in_shard[ids] = np.arange(ids.size)
        sel = head_owner == s
        head_pos = (pos_in_shard[hb[sel]] * n
                    + plan.head_pos[sel] % n).astype(np.int64)
        head_rows = (plan.head_rows[sel] - lo).astype(np.int64)
        valid = _slice_blockwise(plan.valid, ids)
        classes = _shard_classes(plan.classes, ids, pos_in_shard)
        stats = dataclasses.replace(
            plan.stats, nnz=int(valid.sum()), num_blocks=int(ids.size),
            num_classes=len(classes), heads_total=int(head_pos.shape[0]))
        shard_plan = dataclasses.replace(
            plan,
            out_len=hi - lo,
            num_blocks=int(ids.size),
            classes=classes,
            window_ids=_slice_blockwise(plan.window_ids, ids),
            lane_slot=_slice_blockwise(plan.lane_slot, ids),
            lane_offset=_slice_blockwise(plan.lane_offset, ids),
            seg_ids=_slice_blockwise(plan.seg_ids, ids),
            gather_idx=_slice_blockwise(plan.gather_idx, ids),
            valid=valid,
            flat_perm=np.ascontiguousarray(
                plan.flat_perm.reshape(b, n)[ids]).reshape(-1),
            head_pos=head_pos, head_rows=head_rows, stats=stats)
        shard_launches = _shard_launches(tree.launches, ids, pos_in_shard)
        shard_tree = CodeTree(
            plan=shard_plan, backend=tree.backend,
            launches=shard_launches,
            stage_b=tree.stage_b,
            passes=tree.passes + (f"partition_plan[{s}/{shards}]",),
            pass_deltas=tree.pass_deltas + (
                {"pass": f"partition_plan[{s}/{shards}]",
                 "launches_before": len(tree.launches),
                 "launches_after": len(shard_launches),
                 "rows": hi - lo, "blocks": int(ids.size)},))
        out.append(PlanShard(index=s, num_shards=shards, row_start=lo,
                             row_stop=hi, block_ids=ids, tree=shard_tree))
    assigned = np.concatenate([p.block_ids for p in out]) if out else \
        np.zeros(0, np.int64)
    assert np.array_equal(np.sort(assigned), np.arange(b)), \
        "partition_plan: shard block sets must partition the exec order"
    return out


def coalesced_fraction(tree: CodeTree) -> float:
    """Share of nnz served by dense-slice loads after lowering — the
    reach of :func:`coalesce_gathers` (``chip_smoke.py`` prints it per
    matrix)."""
    plan = tree.plan
    if plan.nnz == 0:
        return 0.0
    served = 0
    for launch in tree.launches:
        if launch.gather == COALESCED:
            served += int(plan.valid[launch.start:launch.stop].sum())
    return served / plan.nnz


def coalesce_stats(plan: BlockPlan, fused: bool = True) -> dict:
    """Static reach summary of the coalescing pass on this plan (no
    executor built): the lowered launch count and nnz fraction."""
    tree = lower(plan, backend="torch", fused=fused, coalesce=True)
    return {
        "coalesced_fraction": round(coalesced_fraction(tree), 4),
        "num_launches": len(tree.launches),
        "num_coalesced_launches": sum(
            1 for launch in tree.launches if launch.gather == COALESCED),
    }
