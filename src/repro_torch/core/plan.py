"""Execution-plan construction — the paper's Code Optimizer + Data Transfer.

A numpy-only copy of the JAX package's ``core/plan.py``: the port's plans
must equal the reference's array for array, so the cost model below is
the reference's own (derived for the TPU), not re-tuned for Hopper.

Build pipeline (Fig. 3):
  1. block-partition the iteration space by lane width N,
  2. reduction analysis (§5): in-block stable sort by write index (applied
     *physically* to the nnz-aligned data by the Data Transfer module, so no
     runtime permutation is needed), segment structure, ``op_flag``,
  3. gather analysis (§6): aligned-window cover of the (post-sort) gather
     indices, ``ls_flag`` + permutation operands,
  4. column hashing: metadata dedup accounting (Fig. 3c),
  5. class binning: blocks quantized to (ls, op, stream) *pattern classes*;
     the cost model (paper Tables 1–3 re-derived for TPU, see below) decides
     which classes take the vload+permute path vs the native-gather fallback,
  6. block reorder: blocks of one class are made contiguous in execution
     order (the paper's "merge columns with the same hash"), giving one
     kernel launch per class with zero runtime branching.

Cost model (paper §5.3/§6.4 re-derived for TPU):
  * gather replacement — the HBM lines touched are *identical* (paper §6.4:
    "the number of cache lines consumed by our method is the same"); the win
    is replacing N serialized element accesses with M pipelined tile DMAs +
    cheap in-VMEM permutes.  We apply it when ``M <= max_windows_replace``
    (default N//4) — beyond that the M tile loads + selects cost more than
    the native gather.  Extra metadata per block: N*(slot int8 + offset int8
    + seg int8) + M*4B window ids, vs the N*4B gather indices it replaces —
    the paper's Table 3 accounting, reported in ``PlanStats``.
  * reduction replacement — always beneficial when it fires: N read-modify-
    write scatters collapse to ``num_heads`` (Table 2: write data N->M), at
    the price of ``op_flag`` masked shift-reduce steps (Table 1).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core import feature_table as ft
from repro_torch.core.seed import CodeSeed
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

GATHER_FALLBACK = 0  # ls_flag sentinel: keep the native gather for this class


@dataclasses.dataclass(frozen=True)
class CostModel:
    lane_width: int = 128
    max_windows_replace: int | None = None  # default lane_width // 4
    elem_bytes: int = 4
    idx_bytes: int = 4

    @property
    def window_cutoff(self) -> int:
        if self.max_windows_replace is not None:
            return self.max_windows_replace
        return max(1, self.lane_width // 4)


@dataclasses.dataclass(frozen=True)
class PatternClass:
    ls_flag: int    # number of vloads; GATHER_FALLBACK => native gather
    op_flag: int    # ft.FULL_REDUCE or 0..log2(N) shift-reduce steps
    stream: bool    # ls==1 and identity lane permutation (pure vload)
    start: int      # exec-order block range [start, stop)
    stop: int

    @property
    def key(self) -> tuple:
        return (self.ls_flag, self.op_flag, self.stream)

    @property
    def num_blocks(self) -> int:
        return self.stop - self.start


@dataclasses.dataclass
class PlanStats:
    nnz: int
    num_blocks: int
    num_classes: int
    ls_hist: dict      # ls_flag -> fraction of blocks (paper Table 6 upper)
    op_hist: dict      # op_flag -> fraction of blocks (paper Table 6 lower)
    dedup_ratio: float  # metadata saved by column hashing (Fig. 3c)
    meta_bytes: int     # plan metadata footprint (paper Tables 2/3)
    replaced_gather_frac: float  # fraction of blocks on the vload path
    heads_total: int    # total RMW writes after reduction merge (Table 2)


@dataclasses.dataclass
class BlockPlan:
    seed: CodeSeed
    lane_width: int
    nnz: int
    out_len: int
    data_len: int            # length of gathered (dense) arrays
    num_blocks: int
    classes: list[PatternClass]
    # exec-order per-block metadata:
    window_ids: np.ndarray   # (B, Lmax) int32 — window index into padded data view
    lane_slot: np.ndarray    # (B, N) uint8
    lane_offset: np.ndarray  # (B, N) uint8/uint16
    seg_ids: np.ndarray      # (B, N) int32 (small values; int32 for jnp compare ease)
    gather_idx: np.ndarray   # (B, N) int32 — post-sort gather indices (fallback path)
    valid: np.ndarray        # (B, N) bool
    flat_perm: np.ndarray    # (B*N,) int64 — exec flat pos -> original nnz pos (clipped)
    head_pos: np.ndarray     # (H,) int64 — flat exec positions of segment heads
    head_rows: np.ndarray    # (H,) int64 — output row per head
    stats: PlanStats

    @property
    def max_windows(self) -> int:
        return int(self.window_ids.shape[1])

    def class_slice(self, c: PatternClass) -> slice:
        return slice(c.start, c.stop)


def _class_key_of_blocks(gf: ft.GatherFeatures, rf: ft.ReduceFeatures,
                         cost: CostModel) -> tuple[np.ndarray, np.ndarray]:
    """Return (ls_class, op_class) per block after cost-model quantization."""
    n = gf.lane_width
    ls = gf.num_windows.astype(np.int32)
    # identity-permutation detection for the stream class
    iota = np.arange(n, dtype=np.int32)[None, :]
    identity = (gf.lane_offset == iota).all(axis=1) & (ls == 1)
    ls_class = np.where(ls <= cost.window_cutoff, ls, GATHER_FALLBACK)
    return ls_class, identity


def build_plan(seed: CodeSeed, access: dict, out_len: int, data_len: int,
               cost: CostModel | None = None) -> BlockPlan:
    """Information Producer + Code Optimizer: build the full execution plan.

    ``access`` maps access-array names -> int numpy arrays of length nnz.
    Only *immutable* inputs are consulted, matching the paper's legality
    argument.

    Instrumented (DESIGN.md §11): a ``plan.build`` span with feature /
    binning / reorder child spans when tracing is enabled, plus the
    ``plan.builds`` counter and ``plan.build_seconds`` histogram
    unconditionally (a handful of registry ops per build — invisible
    next to the nnz-sized vector passes).
    """
    cost = cost or CostModel()
    t0 = time.perf_counter()
    with _trace.span("plan.build", lane_width=cost.lane_width) as sp:
        plan = _build_plan_impl(seed, access, out_len, data_len, cost)
        sp.set(nnz=plan.nnz, num_blocks=plan.num_blocks,
               num_classes=plan.stats.num_classes)
    _metrics.inc("plan.builds")
    _metrics.observe("plan.build_seconds", time.perf_counter() - t0)
    return plan


def _build_plan_impl(seed: CodeSeed, access: dict, out_len: int,
                     data_len: int, cost: CostModel) -> BlockPlan:
    n = cost.lane_width
    out_idx = np.asarray(access[seed.out_index], dtype=np.int64)
    nnz = int(out_idx.shape[0])
    if seed.gather_index is not None:
        gidx = np.asarray(access[seed.gather_index], dtype=np.int64)
        assert gidx.shape[0] == nnz
    else:
        gidx = np.zeros(nnz, dtype=np.int64)

    out_blocks = ft.pad_to_blocks(out_idx, n, fill=-1)
    b = out_blocks.shape[0]
    # original flat position per (block, lane); pad lanes point at slot nnz
    # (a zero row appended to the data at ingest time).
    pos_blocks = ft.pad_to_blocks(np.arange(nnz, dtype=np.int64), n, fill=nnz)

    # ---- §5 reduction features + physical in-block sort (Data Transfer)
    with _trace.span("plan.features.reduce"):
        rf = ft.reduce_features(out_blocks, n, pad_value=-1)
        pos_sorted = np.take_along_axis(pos_blocks, rf.sort_perm, axis=1)
        gidx_blocks = ft.pad_to_blocks(gidx, n,
                                       fill=int(gidx[-1]) if nnz else 0)
        gidx_sorted = np.take_along_axis(gidx_blocks, rf.sort_perm, axis=1)

    # ---- §6 gather features on the post-sort index stream
    with _trace.span("plan.features.gather"):
        gf = ft.gather_features(gidx_sorted, n)

    # ---- Fig. 3c column hashing (dedup accounting)
    with _trace.span("plan.features.hash"):
        hashes = ft.pattern_hashes(gf, rf)
        dedup = ft.dedup_ratio(hashes)

    # ---- class binning + cost model (vectorized: encode the class key into
    # one order-preserving int64 and np.unique it — no per-block zip/dict
    # loop).  Exec-order key is (fallback?, op, ls, stream): the fallback /
    # vload split is the major key so each fused launch section is one
    # contiguous block range, and op is the next key so the fused ladder
    # runs per contiguous op-group — every block gets exactly the
    # shift-reduce depth its class needs (DESIGN.md §3).
    with _trace.span("plan.binning") as sp_bin:
        ls_class, stream = _class_key_of_blocks(gf, rf, cost)
        op_class = rf.op_flag
        # op_class >= FULL_REDUCE (-1) so op+1 >= 0 and < 2^16; ls < 2^20.
        key_code = (((ls_class != GATHER_FALLBACK).astype(np.int64) << 40)
                    | ((op_class.astype(np.int64) + 1) << 24)
                    | (ls_class.astype(np.int64) << 4)
                    | stream.astype(np.int64))
        uniq_codes, cid = np.unique(key_code, return_inverse=True)
        cid = cid.astype(np.int32)
        exec_order = np.argsort(cid, kind="stable")    # original block -> sorted
        counts = np.bincount(cid, minlength=uniq_codes.shape[0])
        stops = np.cumsum(counts)
        starts = stops - counts

        classes = []
        for i, code in enumerate(uniq_codes.tolist()):
            classes.append(PatternClass(ls_flag=int((code >> 4) & 0xFFFFF),
                                        op_flag=int(((code >> 24) & 0xFFFF)
                                                    - 1),
                                        stream=bool(code & 1),
                                        start=int(starts[i]),
                                        stop=int(stops[i])))
        sp_bin.set(num_classes=len(classes), num_blocks=b)

    # ---- reorder all per-block metadata into exec order
    with _trace.span("plan.reorder"):
        def r(a):
            return np.ascontiguousarray(a[exec_order])

        window_ids = r(gf.window_ids)
        lane_slot = r(gf.lane_slot).astype(np.uint8)
        off_dtype = np.uint8 if n <= 256 else np.uint16
        lane_offset = r(gf.lane_offset).astype(off_dtype)
        seg_ids = r(rf.seg_ids).astype(np.int32)
        gather_idx_exec = r(gidx_sorted).astype(np.int32)
        head_mask = r(rf.head_mask)
        write_sorted = r(rf.write_sorted)
        valid = write_sorted != -1
        flat_perm = r(pos_sorted).reshape(-1)

        head_pos = np.nonzero(head_mask.reshape(-1))[0].astype(np.int64)
        head_rows = write_sorted.reshape(-1)[head_pos]

    # ---- stats (paper Tables 1–3 / Table 6 accounting), vectorized
    frac = 1.0 / max(b, 1)
    ls_u, ls_c = np.unique(gf.num_windows, return_counts=True)
    ls_hist = {int(k): float(c) * frac
               for k, c in zip(ls_u.tolist(), ls_c.tolist())}
    op_u, op_c = np.unique(rf.op_flag, return_counts=True)
    op_hist = {int(k): float(c) * frac
               for k, c in zip(op_u.tolist(), op_c.tolist())}
    meta_bytes = (lane_slot.nbytes + lane_offset.nbytes +
                  np.int8(0).nbytes * seg_ids.size +  # seg ids ship as int8 equivalent
                  window_ids.nbytes + head_pos.nbytes + head_rows.nbytes)
    replaced = float((ls_class != GATHER_FALLBACK).sum()) / max(b, 1)
    stats = PlanStats(nnz=nnz, num_blocks=b, num_classes=len(classes),
                      ls_hist=ls_hist, op_hist=op_hist, dedup_ratio=dedup,
                      meta_bytes=int(meta_bytes),
                      replaced_gather_frac=replaced,
                      heads_total=int(head_pos.shape[0]))

    return BlockPlan(seed=seed, lane_width=n, nnz=nnz, out_len=out_len,
                     data_len=data_len, num_blocks=b, classes=classes,
                     window_ids=window_ids.astype(np.int32),
                     lane_slot=lane_slot, lane_offset=lane_offset,
                     seg_ids=seg_ids, gather_idx=gather_idx_exec,
                     valid=valid, flat_perm=flat_perm,
                     head_pos=head_pos, head_rows=head_rows, stats=stats)
