"""Feature table construction — the paper's §4/Fig.3(b).

The feature table has one *column* per lane-width block of iterations and
records, per block, the instruction-pattern descriptors that drive code
specialization:

* gather features (§6): the set of aligned windows of width ``N`` that cover
  the block's gather indices. ``ls_flag`` = number of windows = number of
  contiguous vector loads that replace one ``gather``.  Per-lane
  ``(window_slot, offset)`` is the paper's *permutation address* +
  *select mask* pair (Fig. 6).
* reduction features (§5): the run/segment structure of the block's write
  indices after the in-block stable sort (the sort itself is applied
  physically by the Data Transfer module at plan-build time, so the runtime
  kernel sees consecutive runs).  ``op_flag`` = number of log-step
  shuffle-reduce instructions = ``ceil(log2(max_run_len))``; ``op_flag``
  of ``FULL_REDUCE`` marks a block that is a single segment and can use the
  architecture's native cross-lane reduction (paper: "Op = 3 / hardware
  reduction").

TPU adaptation notes (see DESIGN.md §2): windows are *aligned* to the lane
tile (the paper's Fig. 6 allows unaligned begin addresses; aligned windows
are what a TPU can fetch as one HBM->VMEM tile and they bound the paper's M
by at most 2x).  Everything here is plain numpy executed once per immutable
access array — the moral equivalent of the paper's runtime JIT analysis.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

# Sentinel op_flag for a block that is one single segment (paper: use the
# architecture-provided reduction instruction).
FULL_REDUCE = -1


@dataclasses.dataclass(frozen=True)
class GatherFeatures:
    """Per-block gather descriptors (arrays are block-major, padded)."""

    lane_width: int
    num_windows: np.ndarray  # (B,)  int32 — the ls_flag per block
    window_ids: np.ndarray   # (B, Lmax) int32, padded by repeating last id
    lane_slot: np.ndarray    # (B, N) int8/int32 — which window each lane selects
    lane_offset: np.ndarray  # (B, N) int32 — offset of the lane inside its window

    @property
    def max_windows(self) -> int:
        return int(self.window_ids.shape[1])


@dataclasses.dataclass(frozen=True)
class ReduceFeatures:
    """Per-block reduction descriptors after in-block write sort."""

    lane_width: int
    sort_perm: np.ndarray   # (B, N) int32 — stable argsort of write idx per block
    seg_ids: np.ndarray     # (B, N) int32 — run index per lane (post-sort, block-local)
    head_mask: np.ndarray   # (B, N) bool — first lane of each run (post-sort)
    op_flag: np.ndarray     # (B,) int32 — ceil(log2 max_run); FULL_REDUCE if 1 run
    num_heads: np.ndarray   # (B,) int32 — distinct write locations per block
    write_sorted: np.ndarray  # (B, N) int64 — write indices post-sort (PAD = -1 lanes)


def pad_to_blocks(arr: np.ndarray, lane_width: int, fill) -> np.ndarray:
    """Pad the leading dim to a multiple of ``lane_width`` and reshape to blocks."""
    n = arr.shape[0]
    num_blocks = max(1, -(-n // lane_width))
    padded = np.full((num_blocks * lane_width,) + arr.shape[1:], fill, dtype=arr.dtype)
    padded[:n] = arr
    return padded.reshape((num_blocks, lane_width) + arr.shape[1:])


def gather_features(gather_idx_blocks: np.ndarray, lane_width: int,
                    max_windows: int | None = None) -> GatherFeatures:
    """Compute aligned-window cover of each block's gather indices.

    ``gather_idx_blocks`` is (B, N) int, already blocked (PAD lanes should
    repeat a valid index, e.g. index 0, so they never add windows — use
    :func:`pad_to_blocks` with fill equal to a real index, conventionally the
    block's first index; a fill of 0 is always safe).
    """
    b, n = gather_idx_blocks.shape
    assert n == lane_width
    win = gather_idx_blocks // lane_width                      # (B, N)
    win_sorted = np.sort(win, axis=1)
    # distinct windows per block
    newmask = np.ones_like(win_sorted, dtype=bool)
    newmask[:, 1:] = win_sorted[:, 1:] != win_sorted[:, :-1]
    num_windows = newmask.sum(axis=1).astype(np.int32)         # (B,)
    lmax = int(num_windows.max()) if max_windows is None else max_windows
    lmax = max(lmax, 1)
    # window id table (B, lmax): the sorted unique windows, padded by repeating
    # the last valid one (safe: the load is legal, lanes never select it).
    rank = np.cumsum(newmask, axis=1) - 1                      # rank of each sorted pos
    window_ids = np.zeros((b, lmax), dtype=np.int64)
    rows = np.repeat(np.arange(b), n)
    # scatter (last-write-wins is fine: all values within one rank are equal)
    window_ids[rows, np.minimum(rank, lmax - 1).ravel()] = win_sorted.ravel()
    # pad slots beyond num_windows by repeating the last valid window id
    pad_src = window_ids[np.arange(b), np.maximum(num_windows - 1, 0)]
    slot_idx = np.arange(lmax)[None, :]
    window_ids = np.where(slot_idx < num_windows[:, None], window_ids,
                          pad_src[:, None])
    # per-lane slot: position of lane's window in the block's window table.
    # window_ids rows are sorted in their valid prefix (padding repeats the
    # max, keeping rows sorted), so a row-wise searchsorted is exact.
    lane_slot = _rowwise_searchsorted(window_ids, win)
    lane_offset = (gather_idx_blocks - window_ids[np.arange(b)[:, None],
                                                  lane_slot] * lane_width)
    lane_offset = lane_offset.astype(np.int32)
    assert (lane_offset >= 0).all() and (lane_offset < lane_width).all()
    return GatherFeatures(lane_width=lane_width,
                          num_windows=num_windows,
                          window_ids=window_ids.astype(np.int32),
                          lane_slot=lane_slot.astype(np.int32),
                          lane_offset=lane_offset)


def _rowwise_searchsorted(sorted_rows: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Row-wise ``searchsorted`` (left) of ``values`` into ``sorted_rows``."""
    b, l = sorted_rows.shape
    _, n = values.shape
    # offset trick: make all rows comparable in one flat searchsorted
    lo = min(sorted_rows.min(), values.min())
    hi = max(sorted_rows.max(), values.max())
    span = (hi - lo + 1)
    flat_sorted = (sorted_rows - lo + span * np.arange(b)[:, None]).ravel()
    flat_vals = (values - lo + span * np.arange(b)[:, None]).ravel()
    pos = np.searchsorted(flat_sorted, flat_vals, side="left") - \
        np.repeat(np.arange(b) * l, n)
    return pos.reshape(b, n).astype(np.int32)


def reduce_features(write_idx_blocks: np.ndarray, lane_width: int,
                    pad_value: int = -1) -> ReduceFeatures:
    """Compute the reduction pattern of each block's write indices.

    PAD lanes must carry ``pad_value`` (< 0); they sort to the front and are
    given their own segment with no head so they contribute nothing.
    """
    b, n = write_idx_blocks.shape
    assert n == lane_width
    sort_perm = np.argsort(write_idx_blocks, axis=1, kind="stable").astype(np.int32)
    srt = np.take_along_axis(write_idx_blocks, sort_perm, axis=1)
    boundary = np.ones((b, n), dtype=bool)
    boundary[:, 1:] = srt[:, 1:] != srt[:, :-1]
    seg_ids = (np.cumsum(boundary, axis=1) - 1).astype(np.int32)
    valid = srt != pad_value
    head_mask = boundary & valid
    num_heads = head_mask.sum(axis=1).astype(np.int32)
    # run lengths: count lanes per (block, seg)
    run_len = np.zeros((b, n), dtype=np.int32)
    np.add.at(run_len, (np.repeat(np.arange(b), n), seg_ids.ravel()),
              valid.ravel().astype(np.int32))
    max_run = run_len.max(axis=1)
    op_flag = np.ceil(np.log2(np.maximum(max_run, 1))).astype(np.int32)
    # single valid segment covering all valid lanes -> hardware reduction
    n_valid = valid.sum(axis=1)
    full = (num_heads <= 1) & (n_valid == n)
    op_flag = np.where(full, FULL_REDUCE, op_flag)
    return ReduceFeatures(lane_width=lane_width, sort_perm=sort_perm,
                          seg_ids=seg_ids, head_mask=head_mask,
                          op_flag=op_flag, num_heads=num_heads,
                          write_sorted=srt.astype(np.int64))


@dataclasses.dataclass(frozen=True)
class GatherRunFeatures:
    """Per-block *run* descriptors of the (post-sort) gather-index stream —
    the trace-analysis input of the ``coalesce_gathers`` lowering pass
    (repro_torch.core.ir): a block whose whole index footprint fits one
    lane-width window can be served by ONE dense unaligned vector load
    (``lax.dynamic_slice``) plus a static in-tile permutation, instead of
    a per-lane gather.  The span test subsumes contiguous runs (span ==
    N-1 with identity permutation) and small-stride runs (stride ``s``
    over ``k`` lanes qualifies whenever ``s * (k - 1) < N``)."""

    lane_width: int
    base: np.ndarray        # (B,) int64 — clamped slice start per block
    span: np.ndarray        # (B,) int64 — max(idx) - min(idx) per block
    coalescible: np.ndarray  # (B,) bool — span fits one lane-width window
    identity: np.ndarray    # (B,) bool — idx == base + iota (pure slice)


def gather_run_features(gather_idx_blocks: np.ndarray, lane_width: int,
                        data_len: int) -> GatherRunFeatures:
    """Detect contiguous/strided index runs per block (see
    :class:`GatherRunFeatures`).

    ``data_len`` bounds the padded dense view (``ceil(data_len / N) * N``
    elements): the slice start is clamped so ``base + N`` never leaves the
    padded view — XLA's ``dynamic_slice`` clamps out-of-range starts
    silently, which would shift every in-tile offset, so the clamp must
    happen HERE where the offsets are derived."""
    b, n = gather_idx_blocks.shape
    assert n == lane_width
    lo = gather_idx_blocks.min(axis=1).astype(np.int64)
    hi = gather_idx_blocks.max(axis=1).astype(np.int64)
    span = hi - lo
    padded = max(1, -(-data_len // n)) * n
    base = np.minimum(lo, max(padded - n, 0))
    coalescible = span < n
    iota = np.arange(n, dtype=np.int64)[None, :]
    identity = coalescible & (
        gather_idx_blocks == (base[:, None] + iota)).all(axis=1)
    return GatherRunFeatures(lane_width=lane_width, base=base, span=span,
                             coalescible=coalescible, identity=identity)


def _hash_payload(gf: GatherFeatures, rf: ReduceFeatures) -> np.ndarray:
    """The per-block feature payload hashed by Fig.3(c) column hashing."""
    return np.concatenate([
        gf.lane_slot.astype(np.int32),
        gf.lane_offset.astype(np.int32),
        rf.seg_ids,
        rf.head_mask.astype(np.int32),
        gf.num_windows[:, None].astype(np.int32),
        rf.op_flag[:, None].astype(np.int32),
    ], axis=1)


_MIX_SEED = np.uint64(0xCBF29CE484222325)
_MIX_STEP = np.uint64(0x9E3779B97F4A7C15)  # 2^64 / golden ratio


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized (uint64 wraparound arithmetic)."""
    x = x ^ (x >> np.uint64(30))
    x = x * np.uint64(0xBF58476D1CE4E5B9)
    x = x ^ (x >> np.uint64(27))
    x = x * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def pattern_hashes(gf: GatherFeatures, rf: ReduceFeatures) -> np.ndarray:
    """The paper's Fig.3(c) column hash: blocks with equal hashes share one
    generated pattern (and here, one metadata row — dedup accounting).

    Vectorized multiply-shift mixing hash over the feature payload: each of
    the ~4N+2 payload columns gets a fixed odd 64-bit multiplier from the
    splitmix64 sequence; the row hash is the wrapped uint64 dot product plus
    a splitmix64 finalizer — one numpy expression over all B blocks, no
    per-block Python work (the inspector itself must be vectorized for
    end-to-end wins; arXiv:2111.12243).  Equal payload rows hash equal, and
    position-dependent multipliers keep permuted rows distinct; the grouping
    matches :func:`pattern_hashes_blake2b` up to negligible 64-bit collision
    probability (regression-tested).
    """
    payload = np.ascontiguousarray(_hash_payload(gf, rf))
    # pack adjacent int32 column pairs into uint64 words (K = 4N+2 is even),
    # halving the multiply/sum work; equal rows still map to equal words.
    words = payload.view(np.uint64)                      # (B, K // 2)
    k = words.shape[1]
    with np.errstate(over="ignore"):
        mult = _mix64(np.arange(1, k + 1, dtype=np.uint64) * _MIX_STEP)
        mult |= np.uint64(1)                             # odd multipliers
        h = (words * mult[None, :]).sum(axis=1, dtype=np.uint64)
        return _mix64(h ^ (np.uint64(k) * _MIX_STEP))


def pattern_hashes_blake2b(gf: GatherFeatures, rf: ReduceFeatures
                           ) -> np.ndarray:
    """Per-block blake2b reference implementation (the original per-block
    Python loop) — kept only as the oracle for the vectorized hash's
    regression test; O(B) Python-level iterations."""
    payload = _hash_payload(gf, rf)
    b = payload.shape[0]
    out = np.empty(b, dtype=np.uint64)
    for i in range(b):
        out[i] = np.frombuffer(
            hashlib.blake2b(payload[i].tobytes(), digest_size=8).digest(),
            dtype=np.uint64)[0]
    return out


def dedup_ratio(hashes: np.ndarray) -> float:
    """Fraction of metadata storage saved by the hash map (paper: 'decreases
    the memory occupancy during instruction unrolling')."""
    if hashes.size == 0:
        return 0.0
    return 1.0 - (np.unique(hashes).size / hashes.size)
