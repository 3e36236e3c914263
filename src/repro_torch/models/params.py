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
child modules, tensor leaves parameters (frozen: the port serves and does
not train yet), and ``p["name"]`` reads either, so the layer functions
take a module or a plain dict of tensors alike.
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


def tree_map(fn, tree):
    """``fn`` on every leaf of a tree of dicts and lists (one entry per
    layer)."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def split_ptree(ptree):
    """P-tree -> (values tree, axes tree)."""
    return (tree_map(lambda p: p.value, ptree),
            tree_map(lambda p: p.axes, ptree))


def normal(generator: torch.Generator, shape, axes, dtype, scale=None) -> P:
    """Standard normal draws in ``dtype`` times ``scale`` (by default
    ``1/sqrt(fan_in)``, fan-in the leading dimension), on the generator's
    device."""
    fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
    scale = (1.0 / np.sqrt(fan_in)) if scale is None else scale
    value = torch.randn(shape, generator=generator, dtype=dtype,
                        device=generator.device)
    return P(value.mul_(torch.tensor(scale, dtype=dtype)), axes)


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
