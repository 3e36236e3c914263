"""Standalone gather replacement (paper §6, Fig. 6): wrapper and plain version.

:func:`gather_vload` runs the hand-written CUDA C++ kernel of
``csrc/gather_vload.cu`` (built by :mod:`repro_torch.kernels.build` for
``sm_90a``), which replaces the JAX package's
``kernels/gather_vload/kernel.py`` ``gather_vload``: per block ``b`` and
lane ``j``, ``concat(x_view[win_ids[b, :ls]])[slot[b, j] * N + off[b, j]]``
with trailing axes riding along (each lane then takes a whole value row, the
shape of an embedding-row lookup); stream launches copy window 0.

Where the TPU loads the ``ls`` whole windows and selects with a one-hot
matmul, each output word here reads its one word of the view; the plain
version beside it loads the windows and selects
(:func:`repro_torch.kernels.common.permute_onehot`).  Both move words, so
they agree bit for bit in every dtype.

The wrapper runs the plain version for tensors on the CPU; for CUDA tensors
it launches the kernel or raises.  ``gather_vload.launches`` counts
launches.
"""
from __future__ import annotations

import math
from pathlib import Path

import torch

from repro_torch.kernels import build, common

P, I, LL = build.P, build.I, build.LL

library = build.Library(
    "gather_vload", Path(__file__).with_name("csrc") / "gather_vload.cu",
    {"gather_vload": [I, P, P, LL, I, P, P, P, I, I, LL, P]})


def gather_vload_plain(x_view: torch.Tensor, win_ids: torch.Tensor,
                       slot: torch.Tensor, off: torch.Tensor, *, ls: int,
                       stream: bool = False) -> torch.Tensor:
    """Plain torch version: load each block's ``ls`` windows, then select
    ``concat(windows)[slot * N + off]`` per lane (window 0 as it is for
    stream launches)."""
    win = win_ids[:, :ls].long()
    if stream:
        return x_view[win[:, 0]]
    return common.permute_onehot(x_view[win], slot, off)


def gather_vload(x_view: torch.Tensor, win_ids: torch.Tensor,
                 slot: torch.Tensor, off: torch.Tensor, ls: int,
                 stream: bool = False) -> torch.Tensor:
    """x_view (W, N, ...) lane-tile view; win_ids (B, L) int32 with L >= ls
    (rows contiguous); slot/off (B, N) int32.  Returns (B, N, ...)."""
    b, n = slot.shape
    if x_view.ndim < 2 or x_view.shape[1] != n:
        raise ValueError(f"x_view {tuple(x_view.shape)} must be (W, N, ...) "
                         f"with N = {n}")
    if ls < 1 or win_ids.ndim != 2 or win_ids.shape[0] != b \
            or win_ids.shape[1] < ls:
        raise ValueError(f"win_ids {tuple(win_ids.shape)} must be (B, >= ls)"
                         f" with B = {b}, ls = {ls} >= 1")
    if x_view.device.type == "cpu":
        return gather_vload_plain(x_view, win_ids, slot, off, ls=ls,
                                  stream=stream)
    dev = x_view.device
    if dev.type != "cuda":
        raise ValueError(f"no gather_vload kernel for device {dev}")
    if x_view.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"no gather_vload kernel for {x_view.dtype}")
    build.check_operand("x_view", x_view, dev)
    build.check_operand("slot", slot, dev, torch.int32, (b, n))
    build.check_operand("off", off, dev, torch.int32, (b, n))
    if win_ids.device != dev or win_ids.dtype != torch.int32 \
            or win_ids.stride(1) != 1:
        raise ValueError("win_ids must be int32 on the launch device with "
                         "contiguous rows")
    out = torch.empty((b, n) + tuple(x_view.shape[2:]), dtype=x_view.dtype,
                      device=dev)
    if out.numel() == 0:
        return out
    build.check_launch(library().gather_vload(
        x_view.element_size(), x_view.data_ptr(), win_ids.data_ptr(),
        win_ids.stride(0), int(stream), slot.data_ptr(), off.data_ptr(),
        out.data_ptr(), b, n, math.prod(x_view.shape[2:]),
        build.stream_of(x_view)), "gather_vload")
    gather_vload.launches += 1
    return out


gather_vload.launches = 0
