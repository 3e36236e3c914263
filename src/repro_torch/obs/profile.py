"""Static per-launch cost attribution + the ``app.report()`` surface.

A port of the JAX package's ``obs/profile.py``.  The cost view assembled
into one :class:`RunReport` is the **per-launch analytic table**
(:func:`launch_cost_table`): each lowered :class:`~repro_torch.core.ir.Launch`
leaf is costed from its plan metadata — FLOPs (combine + reduce-ladder
steps), bytes moved (gather idiom traffic + elementwise streams + metadata
+ write-back), and the resulting arithmetic intensity.  This is the
paper's Tables 1–3 accounting applied to the tree that actually executes,
so fused / coalesced lowering decisions show up as byte-count deltas per
leaf.  Every row equals the reference's for the same tree (the port's
``cuda`` backend is costed as the reference's ``pallas``).

The reference also reports whole-program totals read from XLA's
optimized HLO.  PyTorch has no HLO, so :attr:`RunReport.hlo` is always
``None`` here, and nothing stands in for it.

``build_report(app, ...)`` collects plan stats, pass provenance +
per-pass launch deltas, tuning choice and ``picked_by``, validation and
degradation trails, and sweep counts into a JSON-serializable report —
the ``app.report()`` method on every app surface delegates here.
"""
from __future__ import annotations

import dataclasses
import json

__all__ = ["RunReport", "launch_cost_table", "build_report"]

_ELEM_BYTES = 4   # float32 pipeline default (values, lanes, output)
_IDX_BYTES = 4    # int32 gather indices / offsets


def _launch_heads(plan, launch) -> int:
    """Number of segment heads (write-back rows) inside one launch's
    exec-order flat range — a binary search over the sorted head
    positions, no per-lane work."""
    import numpy as np
    n = plan.lane_width
    lo, hi = np.searchsorted(plan.head_pos,
                             [launch.start * n, launch.stop * n])
    return int(hi - lo)


def _launch_cost(plan, launch, num_elementwise: int,
                 backend: str = "torch") -> dict:
    """Analytic FLOPs/bytes for one Launch leaf (see module docstring).

    ``backend`` disambiguates the coalesced idiom: the reference's XLA
    lowering pays an 8-byte dynamic-slice base per block, while the
    dense-slice kernel (``cuda``, the reference's ``pallas``) takes an
    int32 base per block and loads one N-wide slice per block row."""
    from repro_torch.core import feature_table as ft

    n = plan.lane_width
    blocks = launch.num_blocks
    lanes = blocks * n
    heads = _launch_heads(plan, launch)

    # ---- gather traffic per idiom (paper §6.4 / Table 3 accounting)
    if launch.gather == "fallback":
        gather_bytes = lanes * (_ELEM_BYTES + _IDX_BYTES)
    elif launch.gather == "window":
        # ls aligned lane tiles per block + (slot, offset) permute bytes
        gather_bytes = (blocks * max(launch.ls_flag, 1) * n * _ELEM_BYTES
                        + lanes * 2)
    elif launch.gather == "stream":
        gather_bytes = blocks * n * _ELEM_BYTES
    elif launch.gather == "coalesced":
        if backend == "cuda":
            # dense-slice kernel: int32 base + one N-wide slice per block
            gather_bytes = blocks * (n * _ELEM_BYTES + _IDX_BYTES)
        else:
            gather_bytes = blocks * (n * _ELEM_BYTES + 8)  # slice + base
        if launch.local_offset is not None:
            gather_bytes += lanes * _IDX_BYTES          # static permute
    else:  # pragma: no cover - future idioms
        gather_bytes = lanes * _ELEM_BYTES
    if plan.seed.gather_index is None:
        gather_bytes = 0

    # ---- elementwise streams + combine
    elem_bytes = lanes * _ELEM_BYTES * num_elementwise
    combine_flops = lanes * max(1, num_elementwise)

    # ---- reduce ladder (paper §5 / Table 1): FULL_REDUCE is one native
    # lane reduction (~N-1 adds per block); a depth-d ladder runs d
    # masked shift-reduce steps over the full lane
    if launch.op_flag == ft.FULL_REDUCE:
        ladder_flops = blocks * (n - 1)
    else:
        depth = launch.op_flag if launch.op_flag > 0 else 0
        ladder_flops = depth * lanes
        if launch.full_mask is not None:
            # fused section keeping native reduce for single-segment blocks
            native = int(launch.full_mask.sum())
            ladder_flops += native * (n - 1) - depth * native * n
            ladder_flops = max(ladder_flops, blocks)

    # ---- write-back: heads gathered out (stage B gather form)
    write_bytes = heads * (_ELEM_BYTES + 2 * 8)  # value + head_pos/row idx

    flops = combine_flops + ladder_flops
    bytes_moved = gather_bytes + elem_bytes + write_bytes
    return {
        "start": launch.start, "stop": launch.stop, "blocks": blocks,
        "gather": launch.gather, "ls_flag": launch.ls_flag,
        "op_flag": launch.op_flag, "heads": heads,
        "flops": int(flops), "bytes": int(bytes_moved),
        "arithmetic_intensity": round(flops / max(bytes_moved, 1), 4),
    }


def launch_cost_table(tree) -> list[dict]:
    """Per-launch cost rows for one lowered CodeTree, exec order."""
    plan = tree.plan
    num_elem = len(getattr(plan.seed, "elementwise", ()))
    return [_launch_cost(plan, launch, num_elem, backend=tree.backend)
            for launch in tree.launches]


@dataclasses.dataclass
class RunReport:
    """Everything one app build + run decided, in one serializable
    object (schema: DESIGN.md §11).  ``hlo`` is always ``None`` (no HLO in
    PyTorch); ``shards`` is the shard count of a sharded app, else
    ``None``."""

    app: str
    backend: str | None
    plan: dict
    passes: tuple
    pass_deltas: tuple
    launches: list
    totals: dict
    hlo: dict | None
    tuning: dict | None
    validation: dict | None
    degradations: list
    sweeps: dict | None
    shards: int | None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True,
                          default=str)


def _maybe_asdict(obj):
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    return dict(obj) if isinstance(obj, dict) else str(obj)


def _plan_dict(plan) -> dict:
    d = dataclasses.asdict(plan.stats)
    d.update(lane_width=plan.lane_width, out_len=plan.out_len,
             data_len=plan.data_len)
    return d


def _tuning_dict(result) -> dict | None:
    if result is None:
        return None
    return {
        "picked_by": result.picked_by,
        "cache_hit": result.cache_hit,
        "best": _maybe_asdict(result.best),
        "best_us": result.best_us,
        "plans_built": result.plans_built,
        "platform": result.platform,
        "measurements": [m.to_dict() for m in result.measurements],
    }


def build_report(app, name: str, sweeps=None) -> RunReport:
    """Assemble a :class:`RunReport` from any app surface.  ``sweeps``
    carries the fixpoint convergence record where one exists.  A sharded
    app's launch rows are every shard's, each tagged with its ``shard``."""
    run = getattr(app, "_run", None)
    tree = getattr(run, "tree", None)
    parts = tuple(getattr(run, "parts", ()) or
                  getattr(app, "_shard_parts", ()))
    launches: list = []
    pass_deltas: tuple = ()
    passes: tuple = ()
    backend = None
    if tree is not None:
        launches = launch_cost_table(tree)
        passes = tuple(tree.passes)
        pass_deltas = tuple(tree.pass_deltas)
        backend = tree.backend
    elif parts:
        for part in parts:
            for row in launch_cost_table(part.tree):
                row["shard"] = part.index
                launches.append(row)
        passes = tuple(parts[0].tree.passes)
        pass_deltas = tuple(parts[0].tree.pass_deltas)
        backend = parts[0].tree.backend

    totals = {
        "launches": len(launches),
        "flops": int(sum(r["flops"] for r in launches)),
        "bytes": int(sum(r["bytes"] for r in launches)),
    }
    totals["arithmetic_intensity"] = round(
        totals["flops"] / max(totals["bytes"], 1), 4)

    return RunReport(
        app=name,
        backend=backend,
        plan=_plan_dict(app.plan),
        passes=passes,
        pass_deltas=pass_deltas,
        launches=launches,
        totals=totals,
        hlo=None,
        tuning=_tuning_dict(getattr(app, "tuning", None)),
        validation=_maybe_asdict(getattr(app, "validation", None)),
        degradations=[_maybe_asdict(e)
                      for e in getattr(app, "degradations", ())],
        sweeps=_maybe_asdict(sweeps),
        shards=len(parts) if parts else None,
    )
