"""MoE token-dispatch row gather: wrapper and plain version.

:func:`row_gather` runs the hand-written CUDA C++ kernel of
``csrc/row_gather.cu`` (built by :mod:`repro_torch.kernels.build` for
``sm_90a``), which replaces the JAX package's
``kernels/moe_dispatch/kernel.py`` ``row_gather``: ``out[i, :] =
src[row_ids[i], :]`` for ``src (T, D)`` (token activations, with a zero row
appended for padding slots) and ``row_ids (R,)`` int32.  A warp copies a
strip of a row (the row copy of ``kernels/csrc/row_copy.cuh``, in the access
width and shape of :func:`repro_torch.kernels.build.row_copy_shape`); the
reference's ``d_tile`` bounds its VMEM row tile, and the CUDA grid does not
depend on it, so it is accepted and has no effect on the launch or the
result.  The copy moves bytes (16 at a time where the row and the pointers
allow), so it takes bfloat16, float32 and every other dtype alike.

The plain version is ``src[row_ids.long()]``.  The wrapper runs it for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.  On
the card the row ids must lie in ``[0, T)``: the kernel reads without a
bounds check, as an indexed load does.  ``row_gather.launches`` counts
launches.
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import build

P, I, LL = build.P, build.I, build.LL

library = build.Library(
    "row_gather", Path(__file__).with_name("csrc") / "row_gather.cu",
    {"row_gather": [P, P, P, I, LL, I, I, P]})


def row_gather_plain(src: torch.Tensor, row_ids: torch.Tensor
                     ) -> torch.Tensor:
    """Plain torch version: an indexed read of whole rows."""
    return src[row_ids.long()]


def row_gather(src: torch.Tensor, row_ids: torch.Tensor, d_tile: int = 512
               ) -> torch.Tensor:
    """src (T, D), row_ids (R,) int32 -> (R, D)."""
    if src.ndim != 2 or row_ids.ndim != 1:
        raise ValueError(f"src {tuple(src.shape)} must be (T, D) and row_ids "
                         f"{tuple(row_ids.shape)} (R,)")
    if src.device.type == "cpu":
        return row_gather_plain(src, row_ids)
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"no row_gather kernel for device {dev}")
    r, (_, d) = row_ids.shape[0], src.shape
    build.check_operand("src", src, dev)
    build.check_operand("row_ids", row_ids, dev, torch.int32)
    out = torch.empty((r, d), dtype=src.dtype, device=dev)
    if out.numel() == 0:
        return out
    es = src.element_size()
    shape = build.row_copy_shape(es, d, src.data_ptr(), out.data_ptr())
    build.check_launch(library().row_gather(
        src.data_ptr(), row_ids.data_ptr(), out.data_ptr(), r, d * es,
        *shape, build.stream_of(src)), "row_gather")
    row_gather.launches += 1
    return out


row_gather.launches = 0
