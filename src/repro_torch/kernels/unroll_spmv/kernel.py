"""Stage-A kernels of the SpMV program: wrappers, plain versions, build.

Two hand-written CUDA C++ kernels for Hopper (``csrc/stage_a.cu``, built for
``sm_90a`` with ``nvcc`` into a shared library with a plain C interface,
loaded with ``ctypes``):

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

Gathered operands are passed flat, unpadded: every word a lane reads is a
real gather index (stream and identity runs are exactly ``base + iota``
over real indices), so the kernels need no padded copy of ``x``.  The plain
versions pad, as the reference's views do, and read the same words.

Trailing lane axes (SpMM) are not in this slice: the wrappers raise on them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.kernels import common

_CSRC = Path(__file__).with_name("csrc") / "stage_a.cu"
# repo-root/build/repro_torch, listed in .gitignore
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_DTYPE_CODE = {torch.float32: 0, torch.int32: 1}
_REDUCE_CODE = {"add": 0, "mul": 1, "max": 2, "min": 3}
_MAX_THREADS = 1024


def _largest_divisor(b: int, r: int) -> int:
    """Largest step size <= r that divides b (>= 1) — kernel params are
    upper bounds; the realized value keeps the grid exact so no block is
    ever padded or dropped (bitwise-stable across any requested value)."""
    r = max(1, min(int(r), max(b, 1)))
    while b % r:
        r -= 1
    return r


# ------------------------------------------------------------------ build
def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the stage-A "
                           "kernels are built from csrc/stage_a.cu at first "
                           "use")
    return found


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library.

    The shared object is keyed by a hash of the source and the flags, so an
    edited source rebuilds and an unchanged one loads in milliseconds.
    ``library.build_seconds`` and ``library.build_log`` (the compiler's
    ``-Xptxas -v`` report: registers, shared memory, spills) record the
    last build; both stay empty when the library was already built."""
    src = _CSRC.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libunroll_stage_a_{key[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(_CSRC)], capture_output=True, text=True)
        library.build_seconds = time.perf_counter() - t0
        library.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_CSRC}:\n{library.build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.unroll_window_stage_a.argtypes = [i, i, p, ll, i, p, p, p, p, p, p,
                                          p, p, i, i, i, i, p]
    lib.unroll_window_stage_a.restype = i
    lib.unroll_dense_slice_stage_a.argtypes = [i, i, p, p, p, p, p, p, p, p,
                                               i, i, i, i, p]
    lib.unroll_dense_slice_stage_a.restype = i
    return lib


library.build_seconds = 0.0
library.build_log = ""


# ---------------------------------------------------------- shared checks
def _term_dtype(gathered, elem) -> torch.dtype:
    """dtype of the ``mul_all`` combine (the only one the kernels
    implement): every operand shares it, and it is float32 or int32 (the
    kernels' two instantiations).  Raises otherwise, on the CPU too, so the
    plain path accepts exactly what the kernel does."""
    if not 1 <= len(gathered) <= 2 or len(elem) > 1:
        raise ValueError("mul_all takes one or two gathered operands and at "
                         f"most one elementwise (got {len(gathered)}, "
                         f"{len(elem)})")
    if any(g.ndim != 1 for g in gathered):
        raise NotImplementedError(
            "trailing lane axes (SpMM) are not in the stage-A kernels yet "
            "(ROADMAP.md queue 1, item 3.1); gathered operands must be 1-D")
    dtypes = {t.dtype for t in (*gathered, *elem)}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _DTYPE_CODE:
        raise TypeError("stage-A kernels take operands of one dtype, float32 "
                        f"or int32; got {sorted(map(str, dtypes))}")
    return next(iter(dtypes))


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _launch_output(seg, gathered, elem, dtype, out, meta: dict):
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
        out = torch.empty((bc, n), dtype=dtype, device=seg.device)
    shapes = {"lanes": (bc, n), "blocks": (bc,)}
    named = {"seg": (seg, torch.int32, (bc, n)), "out": (out, dtype, (bc, n)),
             **{f"gathered[{k}]": (g, dtype, None)
                for k, g in enumerate(gathered)},
             **{f"elem[{k}]": (e, dtype, (bc, n)) for k, e in enumerate(elem)},
             **{k: (t, torch.int32, shapes[kind])
                for k, (t, kind) in meta.items()}}
    for name, (t, dt, shape) in named.items():
        if t is None:
            continue
        if t.device != seg.device:
            raise ValueError(f"{name} is on {t.device}, expected {seg.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return out


def _mul_all(operands):
    term = operands[0]
    for o in operands[1:]:
        term = term * o
    return term


def _pad_flat(g: torch.Tensor, n: int) -> torch.Tensor:
    """Pad a flat gathered array to a whole number of N-word tiles."""
    pad = max(1, -(-g.shape[0] // n)) * n - g.shape[0]
    if pad:
        g = torch.cat([g, g.new_zeros(pad)])
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
        view = _pad_flat(g, n).reshape(-1, n)
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
    gathered    list of flat (data_len,) gathered arrays (1 or 2)
    elem        list of (Bc, N) exec-order elementwise blocks (0 or 1)
    slot/off    (Bc, N) int32 per-lane window slot and offset
    seg         (Bc, N) int32 segment ids
    full_flags  (Bc,) int32 native-reduce flags of a fused mixed section
    rows_per_step  exec blocks per CTA (upper bound; the realized value is
                   the largest divisor of Bc, so results never depend on it)
    out         optional (Bc, N) contiguous destination
    returns     (Bc, N) post-ladder lanes in the combine's dtype
    """
    bc, n = seg.shape
    dtype = _term_dtype(gathered, elem)
    if seg.device.type == "cpu":
        return common.write_out(window_stage_a_plain(
            win_ids, gathered, elem, slot, off, seg, op=op, stream=stream,
            reduce=reduce, full_flags=full_flags), out)
    out = _launch_output(seg, gathered, elem, dtype, out, {
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
    err = library().unroll_window_stage_a(
        _DTYPE_CODE[dtype], _REDUCE_CODE[reduce], win_ids.data_ptr(),
        win_ids.stride(0), int(stream), slot.data_ptr(), off.data_ptr(),
        gathered[0].data_ptr(), _ptr(g1), _ptr(e0), seg.data_ptr(),
        _ptr(full_flags), out.data_ptr(), bc, n, op, rows,
        torch.cuda.current_stream(seg.device).cuda_stream)
    if err:
        raise RuntimeError(f"unroll_window_stage_a launch failed: CUDA "
                           f"error {err}")
    window_stage_a.launches += 1
    return out


window_stage_a.launches = 0


# ------------------------------------------------------- dense-slice form
def dense_slice_stage_a_plain(starts, gathered, elem, local_off, seg, *,
                              op: int, reduce: str,
                              full_flags=None) -> torch.Tensor:
    """Plain torch version of the dense-slice kernel: one N-word slice
    ``flat[starts[b]:starts[b] + N]`` per block, permuted in the tile by
    ``local_off`` for strided runs, then combine and ladder."""
    n = seg.shape[1]
    iota = torch.arange(n, device=seg.device)
    vals = []
    for g in gathered:
        tiles = _pad_flat(g, n)[starts.long()[:, None] + iota]
        if local_off is not None:
            tiles = torch.take_along_dim(tiles, local_off.long(), dim=1)
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
    dtype = _term_dtype(gathered, elem)
    if seg.device.type == "cpu":
        return common.write_out(dense_slice_stage_a_plain(
            starts, gathered, elem, local_off, seg, op=op, reduce=reduce,
            full_flags=full_flags), out)
    out = _launch_output(seg, gathered, elem, dtype, out, {
        "starts": (starts, "blocks"), "local_off": (local_off, "lanes"),
        "full_flags": (full_flags, "blocks")})
    if bc == 0:
        return out
    rows = _largest_divisor(bc, rows_per_step)
    g1 = gathered[1] if len(gathered) > 1 else None
    e0 = elem[0] if elem else None
    err = library().unroll_dense_slice_stage_a(
        _DTYPE_CODE[dtype], _REDUCE_CODE[reduce], starts.data_ptr(),
        _ptr(local_off), gathered[0].data_ptr(), _ptr(g1), _ptr(e0),
        seg.data_ptr(), _ptr(full_flags), out.data_ptr(), bc, n, op, rows,
        torch.cuda.current_stream(seg.device).cuda_stream)
    if err:
        raise RuntimeError(f"unroll_dense_slice_stage_a launch failed: CUDA "
                           f"error {err}")
    dense_slice_stage_a.launches += 1
    return out


dense_slice_stage_a.launches = 0

# the kernels of this module by the names chip_smoke.py reports them under
KERNELS = {"unroll_spmv.window": window_stage_a,
           "unroll_spmv.dense_slice": dense_slice_stage_a}
