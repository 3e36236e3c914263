"""Shared building blocks of the stage-A kernels, in plain torch.

These are the plain versions of the in-kernel parts of the JAX package's
``kernels/common.py``; the CUDA kernels in ``unroll_spmv/csrc`` do the same
arithmetic in the same order, and the torch emitter of
:mod:`repro_torch.core.engine` runs them as they are.

* :func:`permute_onehot` — the paper's ``permutation + select`` pair
  (Fig. 6): lane ``j`` takes word ``slot[j] * N + offset[j]`` of the
  concatenated windows.  The TPU expresses it as a one-hot select-sum so it
  fits the MXU/VPU; an indexed read gives the same word in every dtype.
* :func:`segmented_reduce_lanes` — the paper's log-step shuffle-reduce
  (§5, Fig. 5): ``op_flag`` masked shift-combine steps.  ``FULL_REDUCE``
  puts the whole block's reduction in lane 0 by the pairwise halving tree
  (:func:`halving_tree`), a fixed combine order, where the reference's
  Pallas kernel uses a native reduce of unspecified order.

There is no ``resolve_interpret``: a wrapper runs its kernel or its plain
version by the device its tensors lie on.
"""
from __future__ import annotations

import torch

from repro_torch.core.seed import reduce_identity_for

SEG_PAD = -(2 ** 30)

FULL_REDUCE = -1

REDUCE_FNS = {
    "add": (torch.add, 0.0, torch.sum),
    "mul": (torch.mul, 1.0, torch.prod),
    "max": (torch.maximum, -float("inf"), torch.amax),
    "min": (torch.minimum, float("inf"), torch.amin),
}


def expand_trailing(a: torch.Tensor, ndim: int) -> torch.Tensor:
    """Append trailing singleton axes until ``a.ndim == ndim`` — the §8
    rank rule: lane metadata and per-nnz elementwise arrays broadcast over
    any trailing lane axes."""
    if a.ndim >= ndim:
        return a
    return a.reshape(a.shape + (1,) * (ndim - a.ndim))


def permute_onehot(windows: torch.Tensor, slot: torch.Tensor,
                   offset: torch.Tensor) -> torch.Tensor:
    """Gather-replacement permute: windows ``(B, M, N, ...)`` -> ``(B, N,
    ...)``, lane ``j`` of block ``b`` taking
    ``concat(windows[b])[slot[b, j] * N + offset[b, j]]`` — exactly the
    word the reference's one-hot select-sum returns, in every dtype.
    Trailing axes ride along (SpMM lanes select whole value rows)."""
    b, m, n = windows.shape[:3]
    flat = windows.reshape((b, m * n) + windows.shape[3:])
    sel = slot.long() * n + offset.long()
    return torch.take_along_dim(flat, expand_trailing(sel, flat.ndim), dim=1)


def halving_tree(total: torch.Tensor, op, identity) -> torch.Tensor:
    """(B, N, ...) -> (B, 1, ...) full reduction by pairwise halving along
    axis 1, padding an odd level with the identity — a fixed combine order.
    Lane 0 of an unmasked shift ladder with offsets 1, 2, 4, ... (lanes past
    N reading the identity) builds exactly these pairs, which is how the
    CUDA kernels compute it."""
    while total.shape[1] > 1:
        if total.shape[1] % 2:
            pad = torch.full((total.shape[0], 1) + total.shape[2:], identity,
                             dtype=total.dtype, device=total.device)
            total = torch.cat([total, pad], dim=1)
        total = op(total[:, 0::2], total[:, 1::2])
    return total


def segmented_reduce_lanes(term: torch.Tensor, seg: torch.Tensor,
                           op_flag: int, reduce: str) -> torch.Tensor:
    """(B, N, ...) lane matrix -> (B, N, ...) with each segment head holding
    the full segment reduction.  Step ``k`` sets ``t[j] = op(t[j],
    t[j + 2^k])`` where ``seg[j] == seg[j + 2^k]``; lanes past N read the
    identity and ``SEG_PAD``.  ``FULL_REDUCE`` puts the halving-tree total in
    lane 0 and leaves the other lanes as they are.  ``seg`` is (B, N) and
    broadcasts over trailing lane axes."""
    op = REDUCE_FNS[reduce][0]
    identity = reduce_identity_for(reduce, term.dtype).item()
    if op_flag == FULL_REDUCE:
        total = halving_tree(term, op, identity)
        out = term.clone()
        out[:, 0] = total[:, 0]
        return out
    b, n = seg.shape
    for k in range(op_flag):
        d = 1 << k
        if d >= n:
            break               # every partner is past N: the step is a no-op
        shifted = torch.cat([term[:, d:], torch.full(
            (b, d) + term.shape[2:], identity, dtype=term.dtype,
            device=term.device)], dim=1)
        seg_shift = torch.cat([seg[:, d:], torch.full(
            (b, d), SEG_PAD, dtype=seg.dtype, device=seg.device)], dim=1)
        mask = expand_trailing(seg == seg_shift, term.ndim)
        term = torch.where(mask, op(term, shifted), term)
    return term


def ladder_tail(term: torch.Tensor, seg: torch.Tensor, op_flag: int,
                reduce: str, full_flags: torch.Tensor | None) -> torch.Tensor:
    """The tail every stage-A form shares: the masked ladder of depth
    ``op_flag`` (or the halving-tree full reduce), then, in a fused mixed
    section, the full reduce where a block's ``full_flags`` entry is set.
    The (Bc,) flags select whole blocks, over every trailing lane axis."""
    red = segmented_reduce_lanes(term, seg, op_flag, reduce)
    if full_flags is not None:
        native = segmented_reduce_lanes(term, seg, FULL_REDUCE, reduce)
        red = torch.where(expand_trailing(full_flags != 0, term.ndim),
                          native, red)
    return red


def write_out(res: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    """``res`` itself, or copied into the caller's ``out``."""
    if out is None:
        return res
    out.copy_(res)
    return out
