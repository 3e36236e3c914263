"""Code seed — the paper's user-facing computation description (§4, Alg. 4/5).

A :class:`CodeSeed` is the lambda-expression analogue: it names the output,
the access arrays (immutable), the dense arrays gathered through them
(mutable between calls), the nnz-aligned element arrays (immutable), and the
per-lane combine expression plus the reduction operator.  No optimization
concerns live here — the Information Producer (feature_table), the Code
Optimizer (plan) and the Data Transfer module (engine ingest) take it from
there.

``combine`` is a function of torch tensors, used by the plain torch
emitter.  ``kernel_combine`` (with ``kernel_addend``) names the same
function as one of the forms the hand-written CUDA stage-A kernels
implement (:data:`KERNEL_COMBINES`); a seed without one cannot run on the
``"cuda"`` backend, which raises rather than silently staying on the torch
emitter.

Example (paper Alg. 5)::

    spmv = CodeSeed(
        name="spmv",
        output="y", out_index="row",
        gather_index="col", gathered=("x",),
        elementwise=("value",),
        combine=lambda v: v["value"] * v["x"],
        reduce="add", kernel_combine="mul_all")
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch

REDUCE_OPS = {
    "add": (torch.add, 0.0),
    "mul": (torch.mul, 1.0),
    "max": (torch.maximum, -float("inf")),
    "min": (torch.minimum, float("inf")),
}

# Combines the CUDA stage-A kernels implement, over at most two gathered
# operands (in ``gathered`` order) and then one elementwise operand:
# ``"mul_all"``, their product; ``"add_all"``, their sum and then the seed's
# ``kernel_addend`` where it has one.
KERNEL_COMBINES = ("mul_all", "add_all")


def numpy_dtype(dtype) -> np.dtype:
    """numpy dtype of a torch dtype (or anything ``np.dtype`` accepts)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def reduce_identity_for(reduce: str, dtype) -> np.generic:
    """Identity element of ``reduce`` *in the given dtype* (numpy or torch).

    Integer dtypes have no ``±inf``: the max/min identities are the dtype's
    ``iinfo`` bounds.  Every pad lane, empty segment, and discard bucket in
    the engine must use this (a float ``inf`` cast to int32 is undefined
    behaviour).
    """
    dt = numpy_dtype(dtype)
    if reduce == "add":
        return dt.type(0)
    if reduce == "mul":
        return dt.type(1)
    if reduce not in REDUCE_OPS:
        raise ValueError(f"unsupported reduce {reduce!r}")
    if np.issubdtype(dt, np.floating):
        return dt.type(-np.inf if reduce == "max" else np.inf)
    info = np.iinfo(dt)
    return dt.type(info.min if reduce == "max" else info.max)


@dataclasses.dataclass(frozen=True)
class CodeSeed:
    """Declarative description of one irregular loop nest ``for i in range(nnz)``.

    ``output[out_index[i]] = reduce(output[out_index[i]],
        combine({g: g_arr[gather_index[i]] for g in gathered} |
                {e: e_arr[i] for e in elementwise}))``
    """

    name: str
    output: str
    out_index: str
    gather_index: str | None
    gathered: tuple[str, ...]
    elementwise: tuple[str, ...]
    combine: Callable[[Mapping[str, torch.Tensor]], torch.Tensor]
    reduce: str = "add"
    kernel_combine: str | None = None
    kernel_addend: int | float | None = None

    def __post_init__(self):
        if self.reduce not in REDUCE_OPS:
            raise ValueError(f"unsupported reduce {self.reduce!r}; "
                             f"supported: {sorted(REDUCE_OPS)} "
                             "(paper §5.2: minus/division are expressed as "
                             "add/mul with negated/inverted operands)")
        if self.gather_index is None and self.gathered:
            raise ValueError("gathered arrays require a gather_index")
        if self.kernel_combine is not None:
            if self.kernel_combine not in KERNEL_COMBINES:
                raise ValueError(
                    f"unknown kernel_combine {self.kernel_combine!r}; "
                    f"supported: {KERNEL_COMBINES}")
            if len(self.gathered) > 2 or len(self.elementwise) > 1:
                raise ValueError(
                    f"kernel_combine {self.kernel_combine!r} takes at most "
                    "two gathered and one elementwise operand")
        if self.kernel_addend is not None \
                and self.kernel_combine != "add_all":
            raise ValueError("kernel_addend needs kernel_combine 'add_all'")

    @property
    def reduce_op(self):
        return REDUCE_OPS[self.reduce][0]

    @property
    def reduce_identity(self) -> float:
        return REDUCE_OPS[self.reduce][1]


def spmv_seed(reduce: str = "add") -> CodeSeed:
    """SpMV over COO (paper Alg. 5).  ``reduce`` generalizes the plain
    (+, x) product to the other semirings (tropical SpMV/SpMM) — same
    access pattern, same plan, different reduce ladder op."""
    return CodeSeed(name="spmv", output="y", out_index="row",
                    gather_index="col", gathered=("x",),
                    elementwise=("value",),
                    combine=lambda v: v["value"] * v["x"],
                    reduce=reduce, kernel_combine="mul_all")


def pagerank_seed() -> CodeSeed:
    """Edge-push PageRank contribution pass (paper Alg. 4).

    The division by out-degree is pre-inverted (paper §5.2: division becomes
    multiplication by the inverse), so the mutable gathered arrays are the
    rank vector and the immutable inverse-degree vector.
    """
    return CodeSeed(name="pagerank_push", output="sum", out_index="n2",
                    gather_index="n1", gathered=("rank", "inv_nneighbor"),
                    elementwise=(),
                    combine=lambda v: v["rank"] * v["inv_nneighbor"],
                    reduce="add", kernel_combine="mul_all")


def bfs_seed() -> CodeSeed:
    """Level relaxation: ``level[dst] = min(level[dst], level[src] + 1)``."""
    return CodeSeed(name="bfs_relax", output="level", out_index="dst",
                    gather_index="src", gathered=("level",),
                    elementwise=(),
                    combine=lambda v: v["level"] + 1,
                    reduce="min", kernel_combine="add_all", kernel_addend=1)


def sssp_seed() -> CodeSeed:
    """(min, +) semiring edge relaxation (Bellman-Ford inner loop)."""
    return CodeSeed(name="sssp_relax", output="dist", out_index="dst",
                    gather_index="src", gathered=("dist",),
                    elementwise=("weight",),
                    combine=lambda v: v["dist"] + v["weight"],
                    reduce="min", kernel_combine="add_all")


def cc_seed() -> CodeSeed:
    """Min-label propagation: ``label[dst] = min(label[dst], label[src])``
    (the kernels' ``"add_all"`` over the one operand is the identity)."""
    return CodeSeed(name="cc_propagate", output="label", out_index="dst",
                    gather_index="src", gathered=("label",),
                    elementwise=(),
                    combine=lambda v: v["label"],
                    reduce="min", kernel_combine="add_all")


_INDEX_REDUCE = {"mul": "prod", "max": "amax", "min": "amin"}


def reference_execute(seed: CodeSeed, access: Mapping[str, np.ndarray],
                      data: Mapping[str, torch.Tensor], out_init: torch.Tensor,
                      nnz: int | None = None) -> torch.Tensor:
    """Direct scatter oracle — the un-optimized semantics of the seed.

    Rank-polymorphic like the engine: gathered arrays may carry trailing
    lane axes, and per-nnz elementwise arrays broadcast against them with
    trailing singleton axes.  Float ``add`` accumulates in an unspecified
    order (``index_add``), so it is an oracle to a tolerance, not bitwise."""
    dev = out_init.device
    out_idx = torch.as_tensor(np.asarray(access[seed.out_index]),
                              dtype=torch.int64, device=dev)
    vals = {}
    if seed.gather_index is not None:
        gi = torch.as_tensor(np.asarray(access[seed.gather_index]),
                             dtype=torch.int64, device=dev)
        for g in seed.gathered:
            vals[g] = torch.as_tensor(data[g], device=dev)[gi]
    rank = max((v.ndim for v in vals.values()), default=1)
    for e in seed.elementwise:
        ev = torch.as_tensor(data[e], device=dev)
        vals[e] = ev.reshape(ev.shape + (1,) * (rank - ev.ndim))
    term = seed.combine(vals).to(out_init.dtype)
    if seed.reduce == "add":
        return out_init.index_add(0, out_idx, term)
    return out_init.index_reduce(0, out_idx, term,
                                 _INDEX_REDUCE[seed.reduce],
                                 include_self=True)
