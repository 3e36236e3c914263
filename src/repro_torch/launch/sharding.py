"""Placement of row-sharded state (DESIGN.md §10).

A port of ``row_sharding`` from the JAX package's ``launch/sharding.py``.
The LM's logical-axis rules (``Shd``, ``default_rules``,
``batch_sharding``) wait for data-parallel training and the vocab-sharded
embedding (``ROADMAP.md`` queue 1, item 19).
"""
from __future__ import annotations

from repro_torch.launch.mesh import dp_axes


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
