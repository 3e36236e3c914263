"""Device meshes of the sharded execution stack (DESIGN.md §10).

A port of the JAX package's ``launch/mesh.py``.  The reference drives
every device of a ``jax.sharding.Mesh`` from one process; here one
process drives a tuple of ``torch.device``s, a :class:`ShardMesh` with
the reference's axis names (``"data"``, ``"model"``), so
:func:`dp_axes`, :func:`shard_count` and the sharded executors read it as
the reference reads its mesh.  Nothing here starts a process or opens a
connection.

A *real* mesh takes ``cuda:0 ... cuda:k-1``.  A *simulated* mesh places
all ``k`` shards on one device (the counterpart of
``--xla_force_host_platform_device_count``); only
``make_shard_mesh(k, device=..., simulate=True)`` builds one, and nothing
else repeats a device.

The 256/512-chip production LM mesh of the reference's
``make_production_mesh`` exists here only as its shape,
:func:`production_mesh` (a :class:`MeshShape`, the counterpart of an
``AbstractMesh``): the dry run (``repro_torch.launch.dryrun``) reckons a
device's share of a step on it; running on it waits for a multi-card
machine (``ROADMAP.md`` items 21 and 6).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """``data x model`` devices, data-major: the device of data index
    ``i`` and model index ``j`` is ``devices[i * model + j]``."""

    devices: tuple
    data: int
    model: int = 1
    simulated: bool = False
    axis_names = ("data", "model")

    def __post_init__(self):
        if len(self.devices) != self.data * self.model:
            raise ValueError(f"{len(self.devices)} devices for a "
                             f"{self.data} x {self.model} mesh")

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no device (what ``Shd`` and a
    placement's bytes need)."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def production_mesh(multi_pod: bool = False) -> MeshShape:
    """The reference's production mesh, as a shape: 16 x 16 ``("data",
    "model")``, or 2 x 16 x 16 with ``"pod"`` in front."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def visible_devices(device_type: str = "cuda") -> list[torch.device]:
    """Every device of one type this process sees: the CUDA cards, or
    the one CPU."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def make_local_mesh(data: int | None = None, model: int = 1,
                    allow_subset: bool = False, device="cuda") -> ShardMesh:
    """Mesh over the visible devices of ``device``'s type.

    The mesh must account for EVERY visible device: a shape that covers
    only some of them raises a ValueError naming the dropped devices
    (work would otherwise run on a fraction of the machine with no sign
    why).  ``allow_subset=True`` is the explicit opt-in for deliberately
    smaller meshes (e.g. shard counts {1, 2, 4} on an 8-card host)."""
    devs = visible_devices(torch.device(device).type)
    n = len(devs)
    if data is None:
        data = n // model
    used = data * model
    if used > n:
        raise ValueError(
            f"mesh shape ({data} data x {model} model) needs {used} "
            f"devices but only {n} exist")
    if used < n and not allow_subset:
        raise ValueError(
            f"mesh shape ({data} data x {model} model) covers {used} of "
            f"{n} devices, silently dropping {n - used} "
            f"({[str(d) for d in devs[used:]]}); use a shape covering all "
            "devices, or pass allow_subset=True to opt in")
    return ShardMesh(devices=tuple(devs[:used]), data=data, model=model)


def make_shard_mesh(shards: int | None = None, device="cuda",
                    simulate: bool = False) -> ShardMesh:
    """The 1-D row-shard mesh: ``shards`` devices on the "data" axis
    (model axis trivial).  ``shards=None`` takes every visible device of
    ``device``'s type.  ``simulate=True`` places all ``shards`` shards on
    ``device`` itself.  Raises, naming the simulation recipe, when too
    few devices are visible."""
    if simulate:
        from repro_torch.core.engine import resolve_device
        if shards is None:
            raise ValueError("a simulated mesh needs an explicit shards=")
        if shards < 1:
            raise ValueError(f"shards must be >= 1 (got {shards})")
        return ShardMesh(devices=(resolve_device(device),) * shards,
                         data=shards, simulated=True)
    kind = torch.device(device).type
    n = len(visible_devices(kind))
    if shards is None:
        shards = n
    if shards < 1:
        raise ValueError(f"shards must be >= 1 (got {shards})")
    if shards > n:
        raise ValueError(
            f"shards={shards} but only {n} {kind} device(s) visible; to "
            f"simulate a {shards}-device mesh on one device, build it with "
            f"make_shard_mesh({shards}, device=..., simulate=True) and pass "
            "it as mesh= (SpMV and SpMM also take simulate_mesh=True next "
            "to shards=)")
    return make_local_mesh(data=shards, model=1, allow_subset=True,
                           device=kind)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axis names present in a mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def shard_count(mesh) -> int:
    """Number of row shards a mesh carries = product of its data axes."""
    k = 1
    for a in dp_axes(mesh):
        k *= int(mesh.shape[a])
    return k


def resolve_shard_mesh(mesh=None, shards: int | None = None, device="cuda",
                       simulate: bool = False):
    """Normalize the ``mesh=`` / ``shards=`` constructor surface of the
    sharded apps: ``(None, None)`` selects the single-device stack
    (returns ``(None, 1)``), ``shards`` alone builds the 1-D shard mesh
    on ``device``'s type (every shard on ``device`` when ``simulate``),
    and an explicit mesh is validated against ``shards`` when both are
    given.  Returns ``(mesh_or_None, num_shards)``."""
    if mesh is None and shards is None:
        if simulate:
            raise ValueError("simulate_mesh=True needs shards=")
        return None, 1
    if mesh is None:
        return make_shard_mesh(int(shards), device, simulate), int(shards)
    if simulate:
        raise ValueError("simulate_mesh=True applies to shards= alone; an "
                         "explicit mesh already names its devices")
    k = shard_count(mesh)
    if shards is not None and int(shards) != k:
        raise ValueError(f"shards={shards} does not match the mesh's "
                         f"{k} data-axis device(s)")
    return mesh, k
