"""Parameter system: trees of tensors with logical axes, and the module
that holds them.

Every parameter leaf is created as ``P(value, axes)`` where ``axes`` names
one logical axis per tensor dimension (MaxText-style), as in the JAX
package's ``models/params.py``.  ``split_ptree`` separates the value tree
from the axes tree.  Random leaves come from a caller's
``torch.Generator``, drawn in order, so one seed gives one model; the
streams are not those of ``jax.random`` (weights cross from the JAX
package only through :func:`repro_torch.convert.lm_params_from_numpy`).

:class:`Tree` turns a value tree into an ``nn.Module``: dict nodes become
child modules, tensor leaves parameters, and ``p["name"]`` reads either,
so the layer functions take a module or a plain dict of tensors alike.
The parameters are created frozen, so serving builds no autograd graph;
training unfreezes them (``model.requires_grad_(True)``, done by
:mod:`repro_torch.train.loop`).

The port keeps one module per layer, where the JAX package stacks every
layer leaf on a leading "layers" axis.  :func:`stack_tree` gives a
parameter tree the reference's stacked *structure* without copying: a
layer leaf becomes the list of its per-layer tensors, in layer order.
The optimizer state and the checkpoints use that structure, so their
paths and shapes are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass
class P:
    value: Any
    axes: tuple[str | None, ...]

    def __post_init__(self):
        if hasattr(self.value, "ndim") and self.value.ndim != len(self.axes):
            raise ValueError(
                f"axes {self.axes} rank mismatch for shape "
                f"{getattr(self.value, 'shape', None)}")


def tree_map(fn, tree, *rest):
    """``fn`` on every leaf of a tree of dicts and lists (one entry per
    layer), and on the leaves at the same places of the trees ``rest``."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def stack_tree(tree):
    """A parameter tree (``"layers"`` a list of per-layer trees) in the
    JAX package's stacked structure: each layer leaf becomes the list of
    its per-layer tensors; other leaves stay tensors.  Nothing is
    copied."""
    if isinstance(tree, Mapping):
        return {k: stack_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return _zip_layers([stack_tree(t) for t in tree])
    return tree


def _zip_layers(trees):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _zip_layers([t[k] for t in trees]) for k in first}
    return list(trees)


def stacked_shape(leaf) -> tuple:
    """The shape of a leaf of :func:`stack_tree`'s structure: a list of
    ``L`` layer tensors is ``(L, *shape)``."""
    if isinstance(leaf, list):
        return (len(leaf), *leaf[0].shape)
    return tuple(leaf.shape)


def stacked_map(fn, tree, *rest):
    """``fn`` on every leaf of a stacked-structure tree (lists are
    leaves), and on the nodes at the same places of the trees ``rest``."""
    if isinstance(tree, Mapping):
        return {k: stacked_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def leaves_like(ref, tree) -> list:
    """The nodes of ``tree`` at the leaves of the stacked-structure tree
    ``ref``, keys sorted (the order of ``jax.tree.leaves``)."""
    if isinstance(ref, Mapping):
        return [x for k in sorted(ref) for x in leaves_like(ref[k], tree[k])]
    return [tree]


def split_ptree(ptree):
    """P-tree -> (values tree, axes tree)."""
    return (tree_map(lambda p: p.value, ptree),
            tree_map(lambda p: p.axes, ptree))


class MetaDraws:
    """The generator of a model on the ``meta`` device, where
    ``torch.Generator`` cannot live: a draw is a meta tensor of its shape
    and dtype, and nothing is drawn."""

    device = torch.device("meta")


def normal(generator: torch.Generator, shape, axes, dtype, scale=None) -> P:
    """Standard normal draws in ``dtype`` times ``scale`` (by default
    ``1/sqrt(fan_in)``, fan-in the leading dimension), on the generator's
    device."""
    if generator.device.type == "meta":
        return P(torch.empty(shape, dtype=dtype, device="meta"), axes)
    fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
    scale = (1.0 / np.sqrt(fan_in)) if scale is None else scale
    value = torch.randn(shape, generator=generator, dtype=dtype,
                        device=generator.device)
    return P(value.mul_(torch.tensor(scale, dtype=dtype)), axes)


def abstract_init(cfg):
    """Shape-only init, the JAX package's ``abstract_init(lm.init_model,
    cfg)``: the model built on the ``meta`` device (no element allocated
    or drawn) -> (values tree of meta tensors, in the port's per-layer
    structure, axes tree in the stacked layout)."""
    from repro_torch.models import lm
    model = lm.init_model(cfg, device="meta")
    return model.tree(), model.axes


def zeros(shape, axes, dtype, device) -> P:
    return P(torch.zeros(shape, dtype=dtype, device=device), axes)


def ones(shape, axes, dtype, device) -> P:
    return P(torch.ones(shape, dtype=dtype, device=device), axes)


def const(value, axes) -> P:
    return P(value, axes)


class Tree(nn.Module):
    """A value tree as a module (see the module docstring)."""

    def __init__(self, values: Mapping):
        super().__init__()
        for name, v in values.items():
            if isinstance(v, Mapping):
                self.add_module(name, Tree(v))
            else:
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def tree(self) -> dict:
        """The parameters as a plain tree of dicts (no copy)."""
        out = dict(self.named_parameters(recurse=False))
        out.update((name, child.tree())
                   for name, child in self.named_children())
        return out
