"""SpMM: sparse x dense matrix product on the Intelligent-Unroll plan.

``Y = A_sparse @ B`` is the SpMV program run with 2-D lanes: stage A and
stage B are rank-polymorphic over trailing lane axes (DESIGN.md §8), so the
gather through ``col`` fetches whole rows of ``B`` (``(Bc, N, D)`` lanes
instead of ``(Bc, N)``), the per-nnz ``value`` broadcasts over ``D``, and
the ladder and the write-back reduce along the lane axis only.  ``from_coo``
builds the same :func:`repro_torch.core.engine.make_executor` as
:class:`~repro_torch.core.apps.SpMV`, with the full semiring reduce set
(``reduce="add" | "mul" | "min" | "max"``), fused and per-class launch lists,
the gather-coalescing pass and both backends: ``"torch"`` and ``"cuda"``,
whose stage-A kernels take the trailing axis.

A port of ``SpMM`` from the JAX package's ``core/spmm.py``.  The tuner
(``backend="auto"`` / ``tune=True``), sharded execution (``mesh=`` /
``shards=``), the plan cache (``plan_cache_dir=``) and ``report()`` are later
slices of the port and raise ``NotImplementedError`` naming their
``ROADMAP.md`` item, as :class:`~repro_torch.core.apps.SpMV`'s do.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.core import validate as validation
from repro_torch.core.apps import _check_ported, _not_ported
from repro_torch.core.plan import BlockPlan, CostModel, build_plan
from repro_torch.core.seed import reduce_identity_for, spmv_seed
from repro_torch.obs import trace as _trace


@dataclasses.dataclass
class SpMM:
    plan: BlockPlan
    shape: tuple[int, int]
    _run: object
    device: torch.device
    reduce: str = "add"
    validation: object | None = None    # ValidationReport from from_coo
    degradations: tuple = ()            # DegradationEvents from the build

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
                 validate: str = "strict",
                 mesh=None, shards: int | None = None,
                 device="cuda") -> "SpMM":
        """Build the plan and the executor on ``device`` (default
        ``"cuda"``, which raises when no CUDA device exists).  ``backend``
        is ``"torch"`` or ``"cuda"``; ``reduce`` picks the semiring, and
        ``validate="repair"`` combines duplicate entries with it (DESIGN.md
        §9)."""
        _check_ported(backend, tune, mesh, shards, plan_cache_dir)
        dev = eng.resolve_device(device)
        with _trace.span("app.spmm.build", backend=backend,
                         nnz=int(np.asarray(vals).size)):
            seed = spmv_seed(reduce=reduce)
            rows, cols, vals, vreport = validation.validate_coo(
                rows, cols, np.asarray(vals), shape, policy=validate,
                reduce=reduce)
            with validation.collect_degradations() as events:
                plan = build_plan(seed, {"row": rows, "col": cols},
                                  shape[0], shape[1],
                                  cost=cost or CostModel(
                                      lane_width=lane_width))
                run = eng.make_executor(plan, {"value": vals},
                                        backend=backend, fused=fused,
                                        stage_b=stage_b, coalesce=coalesce,
                                        device=dev)
        return cls(plan=plan, shape=shape, _run=run, device=dev,
                   reduce=reduce, validation=vreport,
                   degradations=tuple(events))

    def matmat(self, bmat, y_init: torch.Tensor | None = None
               ) -> torch.Tensor:
        """``Y = y_init (+) A B`` for ``B`` of shape ``(n, D)`` (a numpy
        array, copied to the device, or a tensor already there);
        ``y_init`` defaults to the reduce's identity."""
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
        raise _not_ported("SpMM.report()", "queue 1, item 8")
