"""Logical-axis sharding rules (MaxText-style), the JAX package's
``launch/sharding.py``.

Every parameter/activation dimension carries a *logical* axis name
(assigned at init); a rules table maps logical names -> mesh axes.
Changing distribution strategy = changing the table.

Baseline rules (paper-faithful FSDP+TP):
  batch         -> (pod, data)      data parallel
  embed         -> data (params)    FSDP: parameters all-gathered per step
  heads/kv/mlp  -> model            Megatron tensor parallel
  experts       -> model            expert parallel (MoE)
  vocab         -> model            sharded logits / embedding
  layers        -> None             stacked-layer axis, never sharded

The reference hands these to GSPMD as ``NamedSharding``s.  The port runs
one process over a :class:`~repro_torch.launch.mesh.ShardMesh`, a tuple of
devices, so a placement here is explicit: :meth:`Placement.split` cuts a
global tensor into one piece per mesh device (the counterpart of
``device_put(x, NamedSharding)``) and :meth:`Placement.join` puts the
pieces back together (the all-gather).  A :class:`Sharded` holds a
tensor's pieces beside its placement.  A spec is a tuple with one entry
per dimension (``None``, a mesh axis, or a tuple of mesh axes), the
entries of the reference's ``PartitionSpec``.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Mapping, Sequence

import torch

from repro_torch.launch.mesh import dp_axes

Rules = dict


def default_rules(mesh) -> Rules:
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)
    return {
        "batch": dp,
        "embed": "data",          # FSDP shard dim for params
        "embed_act": None,        # activation d_model dim (replicated)
        "heads": "model",
        "heads_flat": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "experts": "model",
        "router_experts": "model",
        "expert_mlp": None,       # expert FFN hidden (EP already uses model)
        "vocab": "model",
        "norm": None,
        "layers": None,
    }


def replicated_rules(mesh) -> Rules:
    """Pure DP baseline (small models / ablations)."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)
    return {"batch": dp}


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A tensor's layout on a mesh (the counterpart of ``NamedSharding``):
    dimension ``i`` is cut into equal blocks over the mesh axes of
    ``spec[i]`` and whole along the others.  Device ``n`` of
    ``mesh.devices`` (row-major over ``mesh.axis_names``) holds the block
    at its coordinates."""

    mesh: object
    spec: tuple

    def coords(self, n: int) -> dict:
        """Device ``n``'s coordinate on every mesh axis."""
        out = {}
        for a in reversed(self.mesh.axis_names):
            n, out[a] = divmod(n, self.mesh.shape[a])
        return out

    def block(self, n: int, shape: Sequence[int]) -> tuple:
        """Device ``n``'s block of a global ``shape``, as slices."""
        if len(shape) != len(self.spec):
            raise ValueError(f"shape {tuple(shape)} vs spec {self.spec}")
        c = self.coords(n)
        out = []
        for size, entry in zip(shape, self.spec):
            pos, count = 0, 1
            for a in _axes(entry):
                pos, count = pos * self.mesh.shape[a] + c[a], \
                    count * self.mesh.shape[a]
            if size % count:
                raise ValueError(f"dimension {size} does not divide over "
                                 f"the {count} devices of {entry}")
            step = size // count
            out.append(slice(pos * step, (pos + 1) * step))
        return tuple(out)

    def owners(self) -> tuple[int, ...]:
        """The devices holding one copy of every block: coordinate 0 on
        each mesh axis the spec does not use."""
        used = {a for entry in self.spec for a in _axes(entry)}
        return tuple(n for n in range(len(self.mesh.devices))
                     if all(v == 0 for a, v in self.coords(n).items()
                            if a not in used))

    def split(self, x: torch.Tensor, copy: bool = False) -> "Sharded":
        """``x`` cut into its blocks, one per mesh device, each on its
        device.  A block on ``x``'s own device is a view of ``x`` unless
        ``copy`` (then every piece is a contiguous tensor of its own, as
        state that is updated in place must be)."""
        pieces = []
        for n, dev in enumerate(self.mesh.devices):
            piece = x[self.block(n, x.shape)]
            if copy:
                piece = piece.to(dev, copy=True,
                                 memory_format=torch.contiguous_format)
            else:
                piece = piece.to(dev)
            pieces.append(piece)
        return Sharded(self, pieces, tuple(x.shape))

    def join(self, pieces: Sequence[torch.Tensor], shape: Sequence[int],
             device=None, out: torch.Tensor | None = None) -> torch.Tensor:
        """The global tensor from its pieces (an all-gather), on
        ``device`` (by default the first piece's) or written into ``out``
        in place.  Each block is read from a piece on the target device
        where one holds it."""
        if out is None:
            out = torch.empty(tuple(shape), dtype=pieces[0].dtype,
                              device=device or pieces[0].device)
        with torch.no_grad():
            for n in self.owners():
                sl = self.block(n, shape)
                src = pieces[n]
                for m, piece in enumerate(pieces):
                    if piece.device == out.device and \
                            self.block(m, shape) == sl:
                        src = piece
                        break
                out[sl].copy_(src)
        return out


@dataclasses.dataclass
class Sharded:
    """A global tensor of ``shape`` as its ``pieces``, one per mesh device
    of ``placement`` (a leaf of the data-parallel trees: parameters,
    gradients, moments, batches)."""

    placement: Placement
    pieces: list
    shape: tuple

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    def join(self, device=None, out: torch.Tensor | None = None
             ) -> torch.Tensor:
        return self.placement.join(self.pieces, self.shape, device, out)

    def load(self, x: torch.Tensor) -> None:
        """Copy the global tensor ``x`` into the pieces, in place."""
        with torch.no_grad():
            for n, piece in enumerate(self.pieces):
                piece.copy_(x[self.placement.block(n, self.shape)])


@dataclasses.dataclass
class Shd:
    """Carries (mesh, rules) to the code that places tensors.

    Spec resolution is SHAPE-AWARE: if a dimension is not divisible by the
    product of its mapped mesh axes, that dimension falls back to
    replication (Megatron-style, e.g. kv_heads=8 with model=16 replicates
    KV heads while Q heads stay sharded).  Fallbacks are what make one
    rules table serve all ten architectures.  ``mesh`` needs ``shape`` and
    ``axis_names``; :meth:`named` placements split onto its ``devices``.
    """
    mesh: object
    rules: Rules
    _placed: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    def _axis_size(self, axes) -> int:
        return math.prod(self.mesh.shape[a] for a in _axes(axes))

    def spec(self, names: Sequence[str | None],
             shape: Sequence[int] | None = None) -> tuple:
        entries = []
        for i, n in enumerate(names):
            ax = self.rules.get(n) if n is not None else None
            if ax is not None and shape is not None:
                if shape[i] % self._axis_size(ax) != 0:
                    ax = None          # divisibility fallback: replicate
            entries.append(ax)
        return tuple(entries)

    def named(self, names: Sequence[str | None],
              shape: Sequence[int] | None = None) -> Placement:
        return Placement(self.mesh, self.spec(names, shape))

    def constrain(self, x, names: Sequence[str | None]):
        """The reference's activation constraint: a layout hint to GSPMD,
        the identity on values.  The port places tensors explicitly, so
        only the rank check remains."""
        if x.ndim != len(names):
            raise ValueError(f"rank mismatch {tuple(x.shape)} vs {names}")
        return x

    def place(self, x: torch.Tensor, names: Sequence[str | None]
              ) -> Sharded:
        """``x`` split by the rules, once while it is unchanged: later
        calls with the same tensor return the same pieces (each
        contiguous; views of ``x`` where its blocks are contiguous on its
        own device) until ``x`` is written in place or given new storage
        (its ``_version`` or ``data_ptr()`` moves), which splits it
        again.  Only a weak reference to ``x`` is kept."""
        self._placed = {k: v for k, v in self._placed.items()
                        if v[0]() is not None}
        key = (id(x), tuple(names))
        stamp = (x._version, x.data_ptr())
        hit = self._placed.get(key)
        if hit is not None and hit[0]() is x and hit[1] == stamp:
            return hit[2]
        sh = self.named(names, x.shape).split(x)
        sh.pieces = [p.contiguous() for p in sh.pieces]
        self._placed[key] = (weakref.ref(x), stamp, sh)
        return sh


def data_cut(placement: Placement) -> int:
    """How many pieces a placement cuts a tensor into over the mesh's
    data-parallel axes (``pod``, ``data``)."""
    dp = set(dp_axes(placement.mesh))
    return math.prod(placement.mesh.shape[a] for entry in placement.spec
                     for a in _axes(entry) if a in dp)


def blocks_placement(shd: Shd, nblocks: int, block: int) -> Placement:
    """The placement of a leaf's 8-bit AdamW moments, ``(nblocks, block)``
    blocks of the flattened stacked leaf (and their ``(nblocks, 1)``
    scales): dim 0 over the ``"embed"`` rule, replicated where its mesh
    axes do not divide ``nblocks`` (the reference dry run's ``opt_8bit``
    sharding)."""
    return shd.named(("embed", None), (nblocks, block))


def take_rows(parts: Sequence[torch.Tensor], offsets: Sequence[int],
              lo: int, hi: int, device) -> torch.Tensor:
    """Rows ``[lo, hi)`` of the concatenation of ``parts`` (part ``r``
    holding rows from ``offsets[r]``) on ``device``: a view where one part
    holds them all, else the overlapping rows of each part copied there
    and concatenated (the rows of a row-sharded tensor gathered)."""
    pieces = []
    for part, off in zip(parts, offsets):
        a, b = max(lo, off), min(hi, off + part.shape[0])
        if a < b:
            pieces.append(part[a - off:b - off].to(device))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def _shape(v) -> tuple:
    if isinstance(v, list):              # a stacked-structure layer leaf
        return (len(v), *v[0].shape)
    return tuple(v.shape)


def params_shardings(shd: Shd, axes_tree, values_tree=None):
    """Axes tree (+ optional values tree of the same structure: tensors,
    anything with ``.shape``, or the lists of per-layer tensors of
    :func:`repro_torch.models.params.stack_tree`) -> a tree of
    :class:`Placement`s."""
    if isinstance(axes_tree, Mapping):
        return {k: params_shardings(
            shd, v, None if values_tree is None else values_tree[k])
            for k, v in axes_tree.items()}
    return shd.named(axes_tree, None if values_tree is None
                     else _shape(values_tree))


def row_sharding(mesh) -> tuple:
    """Leading-axis row sharding over the mesh's data axis — the placement
    of the padded fixpoint state in the sharded execution stack: shard
    ``i``'s padded rows are a tensor on the ``i``-th device of the data
    axis between sweeps, so the resident loop never rebuilds the full
    state on one device.  Returns those devices, one per shard."""
    dp = dp_axes(mesh)
    if len(dp) != 1:
        raise ValueError(f"row sharding needs one data axis (mesh axes "
                         f"{mesh.axis_names})")
    model = mesh.shape["model"]
    return tuple(mesh.devices[i * model] for i in range(mesh.shape[dp[0]]))


def batch_sharding(shd: Shd, batch_tree):
    """Shard every batch leaf on its leading (batch) dim (shape-aware:
    batch=1 long-context cells fall back to replicated)."""
    def one(x):
        names = ("batch",) + (None,) * (len(x.shape) - 1)
        return shd.named(names, tuple(x.shape))
    if isinstance(batch_tree, Mapping):
        return {k: batch_sharding(shd, v) for k, v in batch_tree.items()}
    return one(batch_tree)
