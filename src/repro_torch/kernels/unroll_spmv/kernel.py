"""Stage-A kernels of the SpMV program: wrappers and plain versions.

Two hand-written CUDA C++ kernels for Hopper (``csrc/stage_a.cu``, built by
:mod:`repro_torch.kernels.build` for ``sm_90a`` into a shared library with a
plain C interface, loaded with ``ctypes``):

* :func:`window_stage_a` replaces the JAX package's
  ``kernels/unroll_spmv/kernel.py`` ``class_stage_a`` and ``gpu_stage_a``
  (the window form and its Triton twin): per exec block, lane ``j`` reads
  ``view[win_ids[b, slot[b, j]], off[b, j]]`` (stream launches:
  ``view[win_ids[b, 0], j]``), applies the combine and runs the segmented
  ladder.
* :func:`dense_slice_stage_a` replaces ``coalesced_stage_a`` (the dense-slice
  form of coalesced launches): lane ``j`` reads
  ``flat[starts[b] + local_off[b, j]]`` (``+ j`` for identity runs).

Both are bound by bytes on the card; the source's header counts them and
says what the design does about it.  Beside each wrapper sits its plain
torch version, the same arithmetic in the same order, and a launch counter
(``wrapper.launches``, a plain int that grows by one per kernel launch and
by nothing else).  A wrapper runs the plain version for tensors on the
CPU; for CUDA tensors it launches the kernel or raises — there is no
fallback.

Gathered operands are passed unpadded: every word a lane reads is a real
gather index (stream and identity runs are exactly ``base + iota`` over real
indices), so the kernels need no padded copy of ``x``.  The plain versions
pad, as the reference's views do, and read the same words.

Trailing lane axes (SpMM, DESIGN.md §8): a gathered operand may be
``(data_len, ...)``; every lane then reads a whole value row, the output is
``(Bc, N, ...)``, and the elementwise operand and the lane metadata stay
``(Bc, N)`` and broadcast.  Column ``d`` of such a launch is bitwise equal
to the launch on column ``d`` alone.
"""
from __future__ import annotations

import math
from pathlib import Path

import torch

from repro_torch.kernels import build, common

_DTYPE_CODE = {torch.float32: 0, torch.int32: 1}
_REDUCE_CODE = {"add": 0, "mul": 1, "max": 2, "min": 3}
_MAX_THREADS = 1024
_largest_divisor = build.largest_divisor
P, I, LL = build.P, build.I, build.LL

library = build.Library(
    "unroll_stage_a", Path(__file__).with_name("csrc") / "stage_a.cu", {
        "unroll_window_stage_a": [I, I, P, LL, I, P, P, P, P, P, P, P, P, I,
                                  I, LL, I, I, P],
        "unroll_dense_slice_stage_a": [I, I, P, P, P, P, P, P, P, P, I, I,
                                       LL, I, I, P],
    })


# ---------------------------------------------------------- shared checks
def _term_struct(gathered, elem) -> tuple[torch.dtype, tuple]:
    """dtype and trailing lane shape of the ``mul_all`` combine (the only
    one the kernels implement): every operand shares the dtype, float32 or
    int32 (the kernels' two instantiations), and every gathered operand the
    trailing shape.  Raises otherwise, on the CPU too, so the plain path
    accepts exactly what the kernel does."""
    if not 1 <= len(gathered) <= 2 or len(elem) > 1:
        raise ValueError("mul_all takes one or two gathered operands and at "
                         f"most one elementwise (got {len(gathered)}, "
                         f"{len(elem)})")
    dtypes = {t.dtype for t in (*gathered, *elem)}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _DTYPE_CODE:
        raise TypeError("stage-A kernels take operands of one dtype, float32 "
                        f"or int32; got {sorted(map(str, dtypes))}")
    trailing = {tuple(g.shape[1:]) for g in gathered}
    if len(trailing) != 1 or any(g.ndim < 1 for g in gathered):
        raise ValueError("gathered operands must share one trailing lane "
                         f"shape; got {[tuple(g.shape) for g in gathered]}")
    return next(iter(dtypes)), next(iter(trailing))


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _launch_output(seg, gathered, elem, dtype, trailing, out, meta: dict):
    """Device, dtype, shape and layout checks before a launch — the kernel
    reads raw pointers, so what it does not take must raise here — and the
    output tensor.  ``meta`` maps a name to ``(int32 tensor or None,
    "lanes" | "blocks")``: a (Bc, N) or a (Bc,) operand."""
    bc, n = seg.shape
    if seg.device.type != "cuda":
        raise ValueError(f"no stage-A kernel for device {seg.device}")
    if not 1 <= n <= _MAX_THREADS:
        raise ValueError(f"lane width {n} outside the kernels' 1..1024")
    if out is None:
        out = torch.empty((bc, n) + trailing, dtype=dtype, device=seg.device)
    shapes = {"lanes": (bc, n), "blocks": (bc,)}
    named = {"seg": (seg, torch.int32, (bc, n)),
             "out": (out, dtype, (bc, n) + trailing),
             **{f"gathered[{k}]": (g, dtype, None)
                for k, g in enumerate(gathered)},
             **{f"elem[{k}]": (e, dtype, (bc, n)) for k, e in enumerate(elem)},
             **{k: (t, torch.int32, shapes[kind])
                for k, (t, kind) in meta.items()}}
    for name, (t, dt, shape) in named.items():
        if t is not None:
            build.check_operand(name, t, seg.device, dt, shape)
    return out


def _mul_all(operands):
    """``g0 * g1 * e0`` in that order; the (Bc, N) elementwise operand
    broadcasts over the gathered rank (the §8 rank rule)."""
    rank = operands[0].ndim
    term = operands[0]
    for o in operands[1:]:
        term = term * common.expand_trailing(o, rank)
    return term


def _pad_flat(g: torch.Tensor, n: int) -> torch.Tensor:
    """Pad a gathered array to a whole number of N-row tiles."""
    pad = max(1, -(-g.shape[0] // n)) * n - g.shape[0]
    if pad:
        g = torch.cat([g, g.new_zeros((pad,) + g.shape[1:])])
    return g


# ------------------------------------------------------------ window form
def window_stage_a_plain(win_ids, gathered, elem, slot, off, seg, *,
                         op: int, stream: bool, reduce: str,
                         full_flags=None) -> torch.Tensor:
    """Plain torch version of the window kernel: load the ``ls`` windows of
    each gathered array, select ``concat(windows)[slot * N + off]`` per
    lane (window 0 as it is for stream launches), combine, ladder."""
    n = seg.shape[1]
    win = win_ids.long()
    vals = []
    for g in gathered:
        view = _pad_flat(g, n).reshape((-1, n) + g.shape[1:])
        if stream:
            vals.append(view[win[:, 0]])
        else:
            vals.append(common.permute_onehot(view[win], slot, off))
    return common.ladder_tail(_mul_all(vals + list(elem)), seg, op, reduce,
                              full_flags)


def window_stage_a(win_ids, gathered, elem, slot, off, seg, *, op: int,
                   stream: bool, reduce: str, full_flags=None,
                   rows_per_step: int = 1,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Stage A for one window / stream launch or fused section.

    win_ids     (Bc, L) int32, L >= the launch's ls; rows contiguous
    gathered    list of (data_len, ...) gathered arrays (1 or 2), one
                trailing shape
    elem        list of (Bc, N) exec-order elementwise blocks (0 or 1)
    slot/off    (Bc, N) int32 per-lane window slot and offset
    seg         (Bc, N) int32 segment ids
    full_flags  (Bc,) int32 native-reduce flags of a fused mixed section
    rows_per_step  exec blocks per CTA (upper bound; the realized value is
                   the largest divisor of Bc, so results never depend on it)
    out         optional (Bc, N, ...) contiguous destination
    returns     (Bc, N, ...) post-ladder lanes in the combine's dtype
    """
    bc, n = seg.shape
    dtype, trailing = _term_struct(gathered, elem)
    if seg.device.type == "cpu":
        return common.write_out(window_stage_a_plain(
            win_ids, gathered, elem, slot, off, seg, op=op, stream=stream,
            reduce=reduce, full_flags=full_flags), out)
    out = _launch_output(seg, gathered, elem, dtype, trailing, out, {
        "slot": (slot, "lanes"), "off": (off, "lanes"),
        "full_flags": (full_flags, "blocks")})
    if win_ids.device != seg.device or win_ids.dtype != torch.int32 \
            or win_ids.ndim != 2 or win_ids.stride(1) != 1 \
            or win_ids.shape[0] != bc:
        raise ValueError("win_ids must be (Bc, L) int32 on the launch device "
                         "with contiguous rows")
    if bc == 0:
        return out
    rows = _largest_divisor(bc, rows_per_step)
    g1 = gathered[1] if len(gathered) > 1 else None
    e0 = elem[0] if elem else None
    build.check_launch(library().unroll_window_stage_a(
        _DTYPE_CODE[dtype], _REDUCE_CODE[reduce], win_ids.data_ptr(),
        win_ids.stride(0), int(stream), slot.data_ptr(), off.data_ptr(),
        gathered[0].data_ptr(), _ptr(g1), _ptr(e0), seg.data_ptr(),
        _ptr(full_flags), out.data_ptr(), bc, n, math.prod(trailing), op,
        rows, build.stream_of(seg)), "unroll_window_stage_a")
    window_stage_a.launches += 1
    return out


window_stage_a.launches = 0


# ------------------------------------------------------- dense-slice form
def dense_slice_stage_a_plain(starts, gathered, elem, local_off, seg, *,
                              op: int, reduce: str,
                              full_flags=None) -> torch.Tensor:
    """Plain torch version of the dense-slice kernel: one N-row slice
    ``flat[starts[b]:starts[b] + N]`` per block, permuted in the tile by
    ``local_off`` for strided runs, then combine and ladder."""
    n = seg.shape[1]
    iota = torch.arange(n, device=seg.device)
    vals = []
    for g in gathered:
        tiles = _pad_flat(g, n)[starts.long()[:, None] + iota]
        if local_off is not None:
            tiles = torch.take_along_dim(
                tiles, common.expand_trailing(local_off.long(), tiles.ndim),
                dim=1)
        vals.append(tiles)
    return common.ladder_tail(_mul_all(vals + list(elem)), seg, op, reduce,
                              full_flags)


def dense_slice_stage_a(starts, gathered, elem, local_off, seg, *, op: int,
                        reduce: str, full_flags=None, rows_per_step: int = 1,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """Stage A for one COALESCED launch.

    starts      (Bc,) int32 clamped slice bases
    local_off   (Bc, N) int32 in-tile permute, or None for identity runs
    the rest as in :func:`window_stage_a`
    """
    bc, n = seg.shape
    dtype, trailing = _term_struct(gathered, elem)
    if seg.device.type == "cpu":
        return common.write_out(dense_slice_stage_a_plain(
            starts, gathered, elem, local_off, seg, op=op, reduce=reduce,
            full_flags=full_flags), out)
    out = _launch_output(seg, gathered, elem, dtype, trailing, out, {
        "starts": (starts, "blocks"), "local_off": (local_off, "lanes"),
        "full_flags": (full_flags, "blocks")})
    if bc == 0:
        return out
    rows = _largest_divisor(bc, rows_per_step)
    g1 = gathered[1] if len(gathered) > 1 else None
    e0 = elem[0] if elem else None
    build.check_launch(library().unroll_dense_slice_stage_a(
        _DTYPE_CODE[dtype], _REDUCE_CODE[reduce], starts.data_ptr(),
        _ptr(local_off), gathered[0].data_ptr(), _ptr(g1), _ptr(e0),
        seg.data_ptr(), _ptr(full_flags), out.data_ptr(), bc, n,
        math.prod(trailing), op, rows, build.stream_of(seg)),
        "unroll_dense_slice_stage_a")
    dense_slice_stage_a.launches += 1
    return out


dense_slice_stage_a.launches = 0

# the kernels of this module by the names chip_smoke.py reports them under
KERNELS = {"unroll_spmv.window": window_stage_a,
           "unroll_spmv.dense_slice": dense_slice_stage_a}
