"""SpMM: sparse x dense matrix product on the Intelligent-Unroll plan.

``Y = A_sparse @ B`` is the SpMV program run with 2-D lanes: stage A and
stage B are rank-polymorphic over trailing lane axes (DESIGN.md §8), so the
gather through ``col`` fetches whole rows of ``B`` (``(Bc, N, D)`` lanes
instead of ``(Bc, N)``), the per-nnz ``value`` broadcasts over ``D``, and
the ladder and the write-back reduce along the lane axis only.  ``from_coo``
builds the same :func:`repro_torch.core.engine.make_executor` as
:class:`~repro_torch.core.apps.SpMV`, with the full semiring reduce set
(``reduce="add" | "mul" | "min" | "max"``), fused and per-class launch lists,
the gather-coalescing pass and every backend: ``"torch"``, ``"segsum"``,
``"cuda"`` (whose stage-A kernels take the trailing axis) and ``"auto"``
(the tuner, timing candidates on an ``(n, 8)`` operand), with the plan
cache and ``report()`` as :class:`~repro_torch.core.apps.SpMV`'s.

``mesh=`` / ``shards=`` / ``simulate_mesh=`` shard it as
:meth:`~repro_torch.core.apps.SpMV.from_coo`'s do, for every semiring, and
under ``backend="auto"`` ``shards=k`` is a tuned axis over ``{1, k}``.

A port of ``SpMM`` from the JAX package's ``core/spmm.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.core import validate as validation
from repro_torch.core.graphs import build_or_tune
from repro_torch.core.plan import BlockPlan, CostModel
from repro_torch.core.seed import reduce_identity_for, spmv_seed
from repro_torch.obs import trace as _trace


@dataclasses.dataclass
class SpMM:
    plan: BlockPlan
    shape: tuple[int, int]
    _run: object
    device: torch.device
    reduce: str = "add"
    tuning: object | None = None   # TuningResult when built via backend="auto"
    validation: object | None = None    # ValidationReport from from_coo
    degradations: tuple = ()            # DegradationEvents from the build
    # sharded execution (DESIGN.md §10)
    mesh: object | None = None
    _shard_parts: tuple = dataclasses.field(default=(), repr=False)

    @classmethod
    def from_coo(cls, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 shape: tuple[int, int], lane_width: int = 128,
                 backend: str = "torch",
                 cost: CostModel | None = None,
                 fused: bool = True,
                 stage_b: str = "auto",
                 coalesce: bool = False,
                 reduce: str = "add",
                 plan_cache_dir: str | None = None,
                 tune: bool = False,
                 tune_cache_dir: str | None = None,
                 validate: str = "strict",
                 mesh=None, shards: int | None = None,
                 simulate_mesh: bool = False,
                 device="cuda") -> "SpMM":
        """Build the plan and the executor on ``device`` (default
        ``"cuda"``, which raises when no CUDA device exists).  ``backend``
        is ``"torch"``, ``"segsum"``, ``"cuda"`` or ``"auto"`` (measured on
        an ``(n, 8)`` float32 operand, cached in ``tune_cache_dir``);
        ``reduce`` picks the semiring, and ``validate="repair"`` combines
        duplicate entries with it (DESIGN.md §9).  ``mesh=`` / ``shards=``
        / ``simulate_mesh=`` select sharded execution as in
        :meth:`~repro_torch.core.apps.SpMV.from_coo`."""
        dev = eng.resolve_device(device)
        with _trace.span("app.spmm.build", backend=backend,
                         nnz=int(np.asarray(vals).size)):
            seed = spmv_seed(reduce=reduce)
            rows, cols, vals, vreport = validation.validate_coo(
                rows, cols, np.asarray(vals), shape, policy=validate,
                reduce=reduce)
            access = {"row": rows, "col": cols}

            def example():
                b_ex = torch.as_tensor(np.random.default_rng(0)
                                       .standard_normal((shape[1], 8))
                                       .astype(np.float32), device=dev)
                return {"x": b_ex}, torch.full(
                    (shape[0], 8), seed.reduce_identity,
                    dtype=torch.float32, device=dev)
            with validation.collect_degradations() as events:
                plan, run, tuning, mesh, parts = build_or_tune(
                    "SpMM.from_coo", seed, access, shape[0], shape[1],
                    {"value": vals}, backend=backend, tune=tune,
                    lane_width=lane_width, cost=cost, fused=fused,
                    stage_b=stage_b, coalesce=coalesce, device=dev,
                    plan_cache_dir=plan_cache_dir,
                    tune_cache_dir=tune_cache_dir, example=example,
                    mesh=mesh, shards=shards, simulate_mesh=simulate_mesh,
                    tuned_shards=True, cache_extra="spmm:d8")
        return cls(plan=plan, shape=shape, _run=run, device=dev,
                   reduce=reduce, tuning=tuning, validation=vreport,
                   degradations=tuple(events), mesh=mesh,
                   _shard_parts=parts)

    def matmat(self, bmat, y_init: torch.Tensor | None = None
               ) -> torch.Tensor:
        """``Y = y_init (+) A B`` for ``B`` of shape ``(n, D)`` (a numpy
        array, copied to the device, or a tensor already there);
        ``y_init`` defaults to the reduce's identity in ``B``'s dtype.
        Dtypes follow :meth:`~repro_torch.core.apps.SpMV.matvec`: the
        product runs in ``torch.promote_types(values, B)`` and the result
        has ``y_init``'s dtype, by default ``B``'s."""
        if isinstance(bmat, torch.Tensor):
            if bmat.device != self.device:
                raise ValueError(f"B is on {bmat.device}, the SpMM on "
                                 f"{self.device}")
        else:
            bmat = torch.as_tensor(np.asarray(bmat), device=self.device)
        if y_init is None:
            y_init = torch.full(
                (self.shape[0],) + tuple(bmat.shape[1:]),
                reduce_identity_for(self.reduce, bmat.dtype).item(),
                dtype=bmat.dtype, device=self.device)
        return self._run({"x": bmat.contiguous()}, y_init)

    def report(self):
        """Structured :class:`~repro_torch.obs.profile.RunReport`: plan
        stats, IR pass deltas, per-launch cost attribution, tuning choice,
        validation summary, and recorded degradations."""
        from repro_torch.obs.profile import build_report
        return build_report(self, "SpMM")
