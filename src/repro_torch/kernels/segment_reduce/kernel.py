"""Standalone segmented reduction (paper §5, Fig. 5): wrapper and plain version.

:func:`segment_reduce` runs the hand-written CUDA C++ kernel of
``csrc/segment_reduce.cu`` (built by :mod:`repro_torch.kernels.build` for
``sm_90a``), which replaces the JAX package's
``kernels/segment_reduce/kernel.py`` ``segment_reduce``: ``op_flag`` masked
shift-combine steps over lane blocks ``x (B, N, ...)``, ``seg_ids (B, N)``
broadcasting over the trailing lane axes, so every segment head holds its
segment's reduction; ``FULL_REDUCE`` puts the block's total in lane 0 and
leaves the other lanes as they are.

The kernel runs the segmented ladder of ``kernels/csrc/ladder.cuh``, the
code of the stage-A kernels, so its bits are those of the plain version
beside it, :func:`repro_torch.kernels.common.segmented_reduce_lanes`, for
float32, float64 and int32 and every reduce.  ``FULL_REDUCE`` is the
pairwise halving tree (a fixed order), where the reference's Pallas kernel
uses a native reduce of unspecified order.

The wrapper runs the plain version for tensors on the CPU; for CUDA tensors
it launches the kernel or raises.  ``segment_reduce.launches`` counts
launches.
"""
from __future__ import annotations

import math
from pathlib import Path

import torch

from repro_torch.kernels import build, common

_DTYPE_CODE = {torch.float32: 0, torch.int32: 1, torch.float64: 2}
_REDUCE_CODE = {"add": 0, "mul": 1, "max": 2, "min": 3}
_MAX_LANES = 1024
P, I, LL = build.P, build.I, build.LL

library = build.Library(
    "segment_reduce", Path(__file__).with_name("csrc") / "segment_reduce.cu",
    {"segment_reduce": [I, I, P, P, P, I, I, LL, I, I, P]})


def segment_reduce_plain(x: torch.Tensor, seg_ids: torch.Tensor,
                         op_flag: int, reduce: str = "add") -> torch.Tensor:
    """Plain torch version: the segmented ladder of the stage-A kernels."""
    return common.segmented_reduce_lanes(x, seg_ids, op_flag, reduce)


def segment_reduce(x: torch.Tensor, seg_ids: torch.Tensor, op_flag: int,
                   reduce: str = "add", rows_per_step: int = 8) -> torch.Tensor:
    """x (B, N, ...) values, seg_ids (B, N) int32 consecutive-run segment
    ids (block-local); returns (B, N, ...) with head lanes holding segment
    reductions.  ``rows_per_step`` blocks share a CTA (an upper bound: the
    realized value is the largest divisor of B, so results never depend on
    it)."""
    if x.ndim < 2 or tuple(seg_ids.shape) != tuple(x.shape[:2]):
        raise ValueError(f"x {tuple(x.shape)} must be (B, N, ...) and seg_ids "
                         f"(B, N); got seg_ids {tuple(seg_ids.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError("segment_reduce takes float32, float64 or int32; "
                        f"got {x.dtype}")
    if reduce not in _REDUCE_CODE:
        raise ValueError(f"unknown reduce {reduce!r}")
    if op_flag < common.FULL_REDUCE:
        raise ValueError(f"op_flag {op_flag} is neither a ladder depth nor "
                         "FULL_REDUCE")
    if x.device.type == "cpu":
        return segment_reduce_plain(x, seg_ids, op_flag, reduce)
    if x.device.type != "cuda":
        raise ValueError(f"no segment_reduce kernel for device {x.device}")
    b, n = x.shape[:2]
    if not 1 <= n <= _MAX_LANES:
        raise ValueError(f"lane width {n} outside the kernel's 1..1024")
    build.check_operand("x", x, x.device)
    build.check_operand("seg_ids", seg_ids, x.device, torch.int32)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return out
    rows = build.largest_divisor(b, rows_per_step)
    build.check_launch(library().segment_reduce(
        _DTYPE_CODE[x.dtype], _REDUCE_CODE[reduce], x.data_ptr(),
        seg_ids.data_ptr(), out.data_ptr(), b, n, math.prod(x.shape[2:]),
        op_flag, rows, build.stream_of(x)), "segment_reduce")
    segment_reduce.launches += 1
    return out


segment_reduce.launches = 0
