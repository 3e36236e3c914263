"""Compute over the mesh's model axis: Megatron tensor parallel, expert
parallel and vocab parallel pieces (the program GSPMD makes of the JAX
package's rules table, ``launch/sharding.py``: ``heads``, ``heads_flat``,
``kv_heads``, ``mlp``, ``experts``, ``router_experts`` and ``vocab`` ->
``"model"``), for every model family.

One process drives the mesh (as in ``DataParallel``).  A data replica's
``m`` model pieces are a :class:`Group`: ``trees[j]``, piece ``j``'s
parameters on ``devices[j]``, each leaf the block of the model axis that
the rules give it (whole over ``data``), so a dimension the model axis
does not divide is whole in every piece (the rules' divisibility
fallback).  The layers read what is cut from the pieces' shapes, never
from the config alone: with ``replicated_rules``, or ``vocab: None``,
nothing (or the vocabulary) is cut and the lead piece computes it whole.

The activations between the layers' pieces live on the group's lead
device (``devices[0]``).  Two conjugate operations carry them, as
autograd functions:

* :func:`copy_in`: the identity forward onto every piece's device, the
  sum of the pieces' gradients backward (Megatron's ``f``);
* :func:`reduce_out`: the sum of the pieces' partial results forward,
  the identity backward (Megatron's ``g``).

A tensor on the lead stands for one every piece holds (the activations
are replicated over ``model``), so a piece may read any part of its copy
without an exchange.  :func:`norm_sum` is the all-reduce of a norm whose
axis is cut over the pieces (rwkv6's ``ln_x``, Mamba2's gated norm): each
piece's sums of squares of its block, summed onto every piece, forward
and backward.

On a simulated mesh every piece is on one card and a sum is an addition
there.  Each sum (:func:`reduce_out` forward, :func:`copy_in` backward,
:func:`norm_sum` forward and backward, the logsumexp's max in
:func:`all_max`) is counted as one ``"all-reduce"`` and
:func:`all_gather` as one ``"all-gather"`` in the counter the group
carries, with the bytes of the output on one device, as ``DataParallel``
counts its own (``step_analysis.COLLECTIVES``).  Under ``remat`` the
layers' forward runs again in the backward, and its sums are counted
again.  A group of one piece (:meth:`Group.one`: a model on one device)
exchanges nothing: :func:`copy_in` is the input itself, :func:`reduce_out`
and :func:`norm_sum` the identity, and nothing is counted; so the ssm,
hybrid and encdec families' one-device functions are their one-piece
case.

:class:`ModelPieces` is a model split this way for serving
(``serve.engine.generate(ModelPieces(model, shd), ...)``).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.launch import sharding as sh
from repro_torch.launch.step_analysis import COLLECTIVES
from repro_torch.models import params as pr

def zero_collectives(collectives: dict | None = None) -> dict:
    """A counter of collectives by kind (count, and bytes on one
    device), or ``collectives`` zeroed in place."""
    if collectives is None:
        return {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
    for v in collectives.values():
        v["count"] = v["bytes"] = 0
    return collectives


def count_into(collectives: dict, kind: str, nbytes: int) -> None:
    collectives[kind]["count"] += 1
    collectives[kind]["bytes"] += int(nbytes)


def model_axis(mesh) -> int:
    return int(mesh.shape.get("model", 1))


class Group:
    """One data replica's model pieces: ``trees[j]`` (a tree of tensors,
    or a module read with ``[]``) on ``devices[j]``; ``count(kind,
    nbytes)`` records a collective (or is None).  ``group[key]`` is the
    group of the pieces' subtrees."""

    def __init__(self, trees, devices, count=None):
        self.trees = list(trees)
        self.devices = tuple(devices)
        self.count = count

    @classmethod
    def one(cls, tree, device) -> "Group":
        """A model on one device as a group of one piece (nothing
        counted)."""
        return cls([tree], [device])

    def __getitem__(self, key) -> "Group":
        return Group([t[key] for t in self.trees], self.devices, self.count)

    def __len__(self) -> int:
        return len(self.trees)

    @property
    def lead(self):
        return self.trees[0]

    def first(self) -> "Group":
        """The lead piece alone: where the model axis does not cut a
        block, the lead computes it whole."""
        return Group(self.trees[:1], self.devices[:1], self.count)

    def record(self, kind: str, t: torch.Tensor) -> None:
        if self.count is not None:
            self.count(kind, t.numel() * t.element_size())


def _on(x: torch.Tensor, device) -> torch.Tensor:
    return x.view_as(x) if x.device == device else x.to(device)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.device = group, x.device
        return tuple(_on(x, d) for d in group.devices)

    @staticmethod
    def backward(ctx, *grads):
        total = grads[0].to(ctx.device)
        for g in grads[1:]:
            total = total + g.to(ctx.device)
        ctx.group.record("all-reduce", total)
        return total, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *parts):
        ctx.devices = [p.device for p in parts]
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(total.device)
        group.record("all-reduce", total)
        return total

    @staticmethod
    def backward(ctx, grad):
        return (None, *(_on(grad, d) for d in ctx.devices))


class _NormSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *parts):
        ctx.group, ctx.devices = group, [p.device for p in parts]
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(total.device)
        group.record("all-reduce", total)
        return tuple(_on(total, d) for d in ctx.devices)

    @staticmethod
    def backward(ctx, *grads):
        total = grads[0]
        for g in grads[1:]:
            total = total + g.to(total.device)
        ctx.group.record("all-reduce", total)
        return (None, *(_on(total, d) for d in ctx.devices))


def copy_in(group: Group, x: torch.Tensor) -> list:
    """``x`` (on the lead) on every piece's device; backward, the sum of
    the pieces' gradients."""
    if len(group) == 1 and x.device == group.devices[0]:
        return [x]
    return list(_CopyIn.apply(x, group))


def reduce_out(group: Group, parts) -> torch.Tensor:
    """The sum of the pieces' partial results, on the lead, in piece
    order; backward, the gradient on every piece's device."""
    if len(parts) == 1 and parts[0].device == group.devices[0]:
        return parts[0]
    return _ReduceOut.apply(group, *parts)


def norm_sum(group: Group, parts) -> list:
    """The sum of ``parts[j]`` (piece ``j``'s sums of squares over its
    block of a norm's axis) on every piece's device, summed in piece
    order; backward, the sum of the pieces' gradients on every piece's
    device (an all-reduce each way)."""
    if len(parts) == 1:
        return list(parts)
    return list(_NormSum.apply(group, *parts))


def piece_range(j: int, local: int, whole: int) -> tuple[int, int]:
    """The run ``[lo, hi)`` of a dimension of ``whole`` that piece ``j``
    holding ``local`` of it holds (all of it where it is not cut)."""
    return (0, whole) if local == whole else (j * local, (j + 1) * local)


def all_gather(group: Group, parts, dim: int) -> torch.Tensor:
    """The pieces' blocks concatenated along ``dim`` on the lead."""
    out = torch.cat([p.to(group.devices[0]) for p in parts], dim=dim)
    group.record("all-gather", out)
    return out


def all_max(group: Group, parts) -> torch.Tensor:
    """The elementwise max of the pieces' tensors on the lead (no
    gradient)."""
    out = parts[0].detach()
    for p in parts[1:]:
        out = torch.maximum(out, p.detach().to(out.device))
    group.record("all-reduce", out)
    return out


def kv_heads_of(j: int, heads: int, num_heads: int, num_kv_heads: int,
                kv_local: int):
    """The kv heads piece ``j`` of ``heads`` q heads attends with, of the
    ``kv_local`` it holds (all ``num_kv_heads`` where the model axis does
    not divide them): q head ``h`` reads kv head ``h // (H / KH)``.  ->
    ``(lo, hi, index)``: the contiguous run ``[lo, hi)`` of the piece's kv
    heads, and where the piece's q heads do not map onto it in groups of
    one size, ``index`` (one kv head a q head), else None."""
    if kv_local < num_kv_heads:            # cut: a piece's own kv heads
        return 0, kv_local, None
    g = num_heads // num_kv_heads
    first = j * heads
    lo, hi = first // g, (first + heads - 1) // g + 1
    if heads % g == 0 or hi - lo == 1:
        return lo, hi, None
    return lo, hi, torch.arange(first, first + heads) // g - lo


class ModelPieces:
    """A model split over ``shd``'s mesh for serving: device ``n`` holds
    each leaf's block of the model axis (whole over ``data``: the
    gathered weights a data replica computes with; views of the model's
    leaves where a block is contiguous on its device, else copies), and
    ``groups[i]`` is data replica ``i``'s pieces.  The serving batch is
    split over the data replicas where ``data`` divides it, else each
    replica serves it whole (``batch_sharding``'s fallback).
    ``collectives`` counts the serving collectives of one device's
    program (data replica 0's group), as ``DataParallel`` counts the
    training ones."""

    def __init__(self, model, shd):
        if model.axes is None:
            raise ValueError("the model carries no logical axes (build it "
                             "with lm.init_model, or pass axes= to "
                             "convert.lm_params_from_numpy)")
        mesh = shd.mesh
        self.cfg, self.shd = model.cfg, shd
        self.data, self.model = mesh.shape["data"], model_axis(mesh)
        values = model.tree()
        placements = piece_placements(shd, model.axes, values)
        made = {}
        trees = []
        for n, dev in enumerate(mesh.devices):
            key = (dev, n % self.model)
            if key not in made:
                made[key] = pr.tree_map(
                    lambda t, pl, n=n, dev=dev: t.detach()[pl.block(
                        n, t.shape)].to(dev).contiguous(),
                    values, placements)
            trees.append(made[key])
        m = self.model
        self.collectives = zero_collectives()
        count = functools.partial(count_into, self.collectives)
        self.groups = [Group(trees[i * m:(i + 1) * m],
                             mesh.devices[i * m:(i + 1) * m],
                             count if i == 0 else None)
                       for i in range(self.data)]

    def reset_collectives(self) -> None:
        zero_collectives(self.collectives)

    def rows(self, b: int) -> list:
        """Each data replica's rows of a serving batch of ``b``."""
        d = self.data
        if b % d:
            return [slice(0, b)] * d
        return [slice(i * b // d, (i + 1) * b // d) for i in range(d)]


def piece_placements(shd, axes, values):
    """The model-axis placements (:func:`sharding.model_only`) of a
    model's per-layer tree ``values`` under ``shd``'s rules."""
    stacked = sh.params_shardings(shd, axes, pr.stack_tree(values))
    return pr.tree_map(sh.model_only, sh.per_layer(stacked, values))
