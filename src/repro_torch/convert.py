"""Carry a plan or a model's weights built elsewhere into the port:
:func:`plan_from_arrays` and :func:`lm_params_from_numpy`.

The port's planner is a copy of the JAX package's, and the tests hold the
two equal array for array.  This module lets a caller go one step further
and run the port on the reference's *own* plan, independently of the
port's planner: the plan crosses as plain numpy arrays and scalars (no JAX
object, no import of the JAX package), in the field names of
``BlockPlan``:

* scalars ``lane_width``, ``nnz``, ``out_len``, ``data_len``,
  ``num_blocks``;
* arrays ``window_ids``, ``lane_slot``, ``lane_offset``, ``seg_ids``,
  ``gather_idx``, ``valid``, ``flat_perm``, ``head_pos``, ``head_rows``;
* ``classes``, a sequence of ``(ls_flag, op_flag, stream, start, stop)``
  tuples in exec order;
* ``stats``, a dict of the ``PlanStats`` fields
  (``dataclasses.asdict`` of the source plan's stats).

The seed is the port's own (a ``CodeSeed`` with torch combines), passed
beside the fields.

Model weights cross the same way, as a nested dict of numpy arrays in the
JAX package's parameter tree (``lm_params_from_numpy``), and back
(``lm_params_to_numpy``).  The reference stacks every layer leaf on a
leading axis; :func:`host_stacked` builds that layout from the port's
per-layer tensors on the host, for the checkpoints too.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.plan import BlockPlan, PatternClass, PlanStats
from repro_torch.core.seed import CodeSeed
from repro_torch.models import params as pr

_SCALARS = ("lane_width", "nnz", "out_len", "data_len", "num_blocks")
# field -> (dtype kinds accepted, lanes per block: None = (B, L) free width)
_BLOCK_ARRAYS = {
    "window_ids": ("i", None),
    "lane_slot": ("u", "n"),
    "lane_offset": ("u", "n"),
    "seg_ids": ("i", "n"),
    "gather_idx": ("i", "n"),
    "valid": ("b", "n"),
}


def plan_from_arrays(fields: Mapping, seed: CodeSeed) -> BlockPlan:
    """Build the port's :class:`BlockPlan` from a plan's fields handed over
    as numpy arrays and scalars (see the module docstring).  Shapes, dtypes
    and class ranges are checked; a malformed plan raises ``ValueError``."""
    missing = [k for k in (*_SCALARS, *_BLOCK_ARRAYS, "flat_perm",
                           "head_pos", "head_rows", "classes", "stats")
               if k not in fields]
    if missing:
        raise ValueError(f"plan fields missing: {missing}")
    sc = {k: int(fields[k]) for k in _SCALARS}
    b, n = sc["num_blocks"], sc["lane_width"]
    arrays = {}
    for name, (kinds, width) in _BLOCK_ARRAYS.items():
        a = np.ascontiguousarray(fields[name])
        if a.dtype.kind not in kinds or a.ndim != 2 or a.shape[0] != b \
                or (width == "n" and a.shape[1] != n):
            raise ValueError(f"{name}: expected (num_blocks={b}, "
                             f"{'N=' + str(n) if width else 'L'}) of kind "
                             f"{kinds!r}, got {a.shape} {a.dtype}")
        arrays[name] = a
    flat_perm = np.asarray(fields["flat_perm"], dtype=np.int64)
    head_pos = np.asarray(fields["head_pos"], dtype=np.int64)
    head_rows = np.asarray(fields["head_rows"], dtype=np.int64)
    if flat_perm.shape != (b * n,) or head_pos.shape != head_rows.shape:
        raise ValueError("flat_perm must be (B*N,) and head_pos/head_rows "
                         "of one length")
    classes = [PatternClass(ls_flag=int(ls), op_flag=int(op),
                            stream=bool(st), start=int(lo), stop=int(hi))
               for ls, op, st, lo, hi in fields["classes"]]
    pos = 0
    for c in classes:
        if c.start != pos or c.stop < c.start:
            raise ValueError("classes must tile [0, num_blocks) in exec "
                             "order")
        pos = c.stop
    if pos != b:
        raise ValueError("classes must tile [0, num_blocks) in exec order")
    return BlockPlan(seed=seed, classes=classes,
                     flat_perm=flat_perm, head_pos=head_pos,
                     head_rows=head_rows, stats=PlanStats(**fields["stats"]),
                     **sc, **arrays)


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 ones included, as ``ml_dtypes`` gives
    them) as a tensor on ``device``."""
    a = np.array(a)                 # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def lm_params_from_numpy(cfg, tree: Mapping, device="cuda"):
    """The port's model (:class:`repro_torch.models.lm.LM`) holding the
    weights of the JAX package's ``materialize_init(lm.init_model, key,
    cfg)`` values, handed over as a nested dict of numpy arrays.  Layer
    leaves are stacked on a leading layer axis (``scan_layers=True``) and
    are unstacked into one module per layer; every array keeps its dtype.
    ``device`` defaults to ``"cuda"``, which raises when no CUDA device
    exists."""
    from repro_torch.core.engine import resolve_device
    from repro_torch.models import lm
    dev = resolve_device(device)
    values = pr.tree_map(lambda a: _tensor(a, dev), dict(tree))
    stacked = values["layers"]
    values["layers"] = [pr.tree_map(lambda t, i=i: t[i], stacked)
                        for i in range(cfg.num_layers)]
    return lm.LM(cfg, values)


def host_stacked(stree) -> dict:
    """A tree in :func:`repro_torch.models.params.stack_tree`'s structure
    as new host tensors, each layer leaf stacked on a leading axis: every
    layer is copied from its device into its slice of one host tensor, so
    nothing is stacked on the device."""
    def one(leaf):
        if not isinstance(leaf, list):
            return leaf.detach().to("cpu", copy=True)
        out = torch.empty(pr.stacked_shape(leaf), dtype=leaf[0].dtype)
        for i, t in enumerate(leaf):
            out[i].copy_(t.detach())
        return out
    return pr.stacked_map(one, stree)


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def lm_params_to_numpy(model) -> dict:
    """The inverse of :func:`lm_params_from_numpy`: the model's weights
    as the JAX package's parameter tree of numpy arrays, layer leaves
    stacked (bfloat16 leaves as ``ml_dtypes.bfloat16``, which needs that
    package)."""
    return pr.stacked_map(_numpy, host_stacked(pr.stack_tree(model.tree())))


@torch.no_grad()
def load_stacked(model, stree) -> None:
    """Copy a tree in the reference's stacked layout (tensors on any
    device, as :func:`host_stacked` or a checkpoint gives them) into the
    model's parameters, in place."""
    mine = pr.stack_tree(model.tree())
    for dst, src in zip(pr.leaves_like(mine, mine),
                        pr.leaves_like(mine, stree)):
        if isinstance(dst, list):
            for i, t in enumerate(dst):
                t.copy_(src[i])
        else:
            dst.copy_(src)
