"""Static analysis of one step, the port's counterpart of the JAX
package's ``launch/hlo_analysis.py``.

The reference reads the roofline terms from a compiled program's HLO
text.  The port has no HLO: it runs the step itself on fake tensors
(``FakeTensorMode``: CPU tensors with shapes and dtypes and no data,
nothing allocated or launched; the CPU's plain versions of the kernels,
the MoE row gather's among them, run as shapes) and watches every ATen op
it dispatches, forward, backward and optimizer alike.
:func:`analyze_step` returns the reference's ``analyze_hlo`` keys:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of the
  products that ran (``mm``, ``bmm``, ``addmm``, convolutions, attention),
  the counterpart of the reference's ``2 * numel(out) * contracted`` per
  ``dot``.  A Python loop runs each of its iterations, so nothing is
  multiplied by a trip count, and a branch not taken is not counted.
* ``memory_bytes``: the reference's per-op traffic proxy on ATen ops:
  every op reads its operands and writes its outputs (each tensor once
  per op, by its view's bytes); view and metadata ops move nothing; a
  gather (``index``, ``index_select``, ``gather``, ``embedding``,
  ``take``) charges twice its output and a scatter (``index_put``,
  ``scatter``, ``index_add``, ``index_copy``, ``*_scatter``) three times
  its update, so a small lookup does not charge the whole table.
* ``collectives``: by kind, ``{"count", "bytes"}``, and ``total_bytes``,
  reckoned by :func:`reckon_collectives` from the placements (the port's
  one-process step runs no collective of its own to watch).
* ``peak_bytes`` (beside them): the peak of the live bytes of the storages
  the step creates (its arguments excluded), a tensor live until autograd
  and the step drop every reference to it: the dry run's ``temp_bytes``.

Collective bytes are in the reference's unit (``dryrun.py``'s
``parse_collectives``): the output's bytes on one device.  They are the
collectives of ``train.loop.DataParallel``, which counts the same bytes
as it runs: the all-gather of every piece cut over a data-parallel axis
(its output: the tensor gathered over those axes), the gradients'
reduce-scatter in float32 onto the pieces (an all-reduce where a leaf is
not cut over them), and with 8-bit moments the reduce-scatter in flat
block order (``sharding.blocks_placement``) and the all-to-all that puts
the new parameter values back into their pieces.
"""
from __future__ import annotations

import math
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch import sharding as sh
from repro_torch.models import params as pr

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_FREE = {"empty", "empty_strided", "empty_like", "new_empty", "arange",
         "detach", "alias", "lift_fresh", "set_", "resize_", "_unsafe_view"}
_GATHERS = {"index", "index_select", "gather", "embedding", "take"}
# scatter op -> the name of its update argument
_SCATTERS = {"index_put": "values", "index_put_": "values",
             "_index_put_impl_": "values", "scatter": "src",
             "scatter_": "src", "scatter_add": "src", "scatter_add_": "src",
             "scatter_reduce": "src", "scatter_reduce_": "src",
             "index_add": "source", "index_add_": "source",
             "index_copy": "source", "index_copy_": "source",
             "slice_scatter": "src", "select_scatter": "src",
             "diagonal_scatter": "src", "as_strided_scatter": "src"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in _pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def op_traffic(func, args, kwargs, out) -> int:
    """The bytes one ATen op reads and writes, by the proxy above."""
    if func.is_view or not _tensors(out):     # views, metadata queries
        return 0
    name = func.overloadpacket.__name__
    if name in _FREE:
        return 0
    if name in _GATHERS:
        return 2 * sum(_nbytes(t) for t in _tensors(out))
    if name in _SCATTERS:
        arg = _SCATTERS[name]
        names = [a.name for a in func._schema.arguments]
        upd = kwargs.get(arg) if arg in kwargs else (
            args[names.index(arg)] if arg in names and
            names.index(arg) < len(args) else None)
        if isinstance(upd, (list, tuple)):
            upd = next((t for t in upd if isinstance(t, torch.Tensor)), None)
        if isinstance(upd, torch.Tensor):
            return 3 * _nbytes(upd)
        return 3 * sum(_nbytes(t) for t in _tensors(out))
    seen, total = set(), 0
    for t in _tensors((args, kwargs)):
        if id(t) not in seen:
            seen.add(id(t))
            total += _nbytes(t)
    return total + sum(_nbytes(t) for t in _tensors(out))


class _Watch(TorchDispatchMode):
    """Sums :func:`op_traffic` and follows the live bytes of the storages
    the ops create (argument storages excluded)."""

    def __init__(self, arguments):
        super().__init__()
        self.memory_bytes = 0
        self.live = self.peak = 0
        self._args = {t.untyped_storage()._cdata for t in arguments}
        self._storages = {}      # storage -> [bytes, live tensors on it]

    def _release(self, key) -> None:
        entry = self._storages[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.memory_bytes += op_traffic(func, args, kwargs, out)
        for t in _tensors(out):
            key = t.untyped_storage()._cdata
            if key in self._args:
                continue
            entry = self._storages.get(key)
            if entry is None:
                entry = self._storages[key] = [
                    t.untyped_storage().nbytes(), 0]
                self.live += entry[0]
                self.peak = max(self.peak, self.live)
            entry[1] += 1
            weakref.finalize(t, self._release, key)
        return out


def analyze_step(build) -> dict:
    """``build()`` makes a step's inputs on the CPU inside a fresh
    ``FakeTensorMode`` and returns ``(step, arguments)``: ``step()`` is
    then run there under the watch -> ``{"flops", "memory_bytes",
    "peak_bytes"}``.  ``arguments`` lists every tensor the step takes
    (parameters, state, batch): their storages are its arguments, not its
    temporaries."""
    with FakeTensorMode():
        step, arguments = build()
        watch = _Watch(arguments)
        with FlopCounterMode(display=False) as flops, watch:
            step()
    return {"flops": int(flops.get_total_flops()),
            "memory_bytes": int(watch.memory_bytes),
            "peak_bytes": int(watch.peak)}


# ------------------------------------------------------------- placements
def piece_numel(placement: sh.Placement, shape) -> int:
    """Elements of one device's piece of a tensor of ``shape`` (the pieces
    of a placement are all alike)."""
    cut = math.prod(placement.mesh.shape[a] for entry in placement.spec
                    for a in sh._axes(entry))
    return math.prod(shape) // cut


def stacked_leaves(values, axes) -> list:
    """``(stacked shape, layers, dtype, axes)`` of every leaf of a
    parameter tree (the port's per-layer values, on any device) in the
    reference's stacked layout, keys sorted.  ``layers`` is the number of
    per-layer tensors the port keeps for the leaf (1 outside the layer
    stacks)."""
    st = pr.stack_tree(values)
    out = []
    for leaf, ax in zip(pr.leaves_like(st, st), _axes_leaves(st, axes)):
        first = leaf[0] if isinstance(leaf, list) else leaf
        out.append((pr.stacked_shape(leaf),
                    len(leaf) if isinstance(leaf, list) else 1,
                    first.dtype, ax))
    return out


def _axes_leaves(ref, axes) -> list:
    if isinstance(ref, dict):
        return [x for k in sorted(ref) for x in _axes_leaves(ref[k], axes[k])]
    return [tuple(axes)]


def reckon_collectives(shd: sh.Shd, leaves, kind: str, q_block=None,
                       split: bool = True, microbatches: int = 1) -> dict:
    """The collectives of one step over ``shd``'s mesh, by kind, in the
    reference's unit (see the module docstring), from the parameter
    ``leaves`` of :func:`stacked_leaves`.  ``kind`` "train" adds the
    gradients' (``microbatches`` times, none where the batch is
    replicated: ``split`` False) and, with ``q_block``, the 8-bit
    moments' flat reduce-scatter and all-to-all; "prefill" and "decode"
    gather the parameters only.  The all-to-all runs whether or not the
    batch is split."""
    out = {c: {"count": 0, "bytes": 0} for c in COLLECTIVES}

    def add(c, count, nbytes):
        out[c]["count"] += count
        out[c]["bytes"] += count * nbytes
    for shape, layers, dtype, axes in leaves:
        pl = shd.named(axes, shape)
        item = torch.empty((), dtype=dtype).element_size()
        piece = piece_numel(pl, shape) // layers
        cut = sh.data_cut(pl)
        if cut > 1:
            add("all-gather", layers, piece * cut * item)
        if kind != "train":
            continue
        if q_block is None:
            if split:
                add("reduce-scatter" if cut > 1 else "all-reduce",
                    layers * microbatches, piece * 4)
            continue
        nb = -(-math.prod(shape) // q_block)
        fl = sh.blocks_placement(shd, nb, q_block)
        if split:
            add("reduce-scatter" if sh.data_cut(fl) > 1 else "all-reduce",
                microbatches, piece_numel(fl, (nb, q_block)) * 4)
        if sh.data_cut(fl) > 1:
            add("all-to-all", layers, piece * item)
    out["total_bytes"] = sum(v["bytes"] for v in out.values()
                             if isinstance(v, dict))
    return out
