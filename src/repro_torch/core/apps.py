"""Applications built on the Intelligent-Unroll engine (paper §7).

* :class:`SpMV` — COO sparse matrix-vector product (paper Alg. 5).  The plan
  is built once per matrix (access arrays immutable); ``matvec`` runs the
  executor over the mutable ``x`` with a cached per-dtype zero ``y_init``.

A port of ``SpMV`` from the JAX package's ``core/apps.py``: ``from_coo``,
``from_csr`` and ``matvec``.  The tuner (``backend="auto"`` / ``tune=True``),
sharded execution (``mesh=`` / ``shards=``), the plan cache
(``plan_cache_dir=``), ``matvec_many`` and ``report()`` are later slices of
the port; asking for one raises ``NotImplementedError`` naming its
``ROADMAP.md`` item.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.core import validate as validation
from repro_torch.core.plan import BlockPlan, CostModel, build_plan
from repro_torch.core.seed import spmv_seed
from repro_torch.obs import trace as _trace


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md {item})")


@dataclasses.dataclass
class SpMV:
    plan: BlockPlan
    shape: tuple[int, int]
    _run: object
    dtype: np.dtype
    device: torch.device
    validation: object | None = None    # ValidationReport from from_coo
    degradations: tuple = ()            # DegradationEvents from the build
    # cached zero y_init per dtype: repeated matvecs share one device
    # tensor instead of allocating a fresh zeros per call
    _y0: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def from_coo(cls, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 shape: tuple[int, int], lane_width: int = 128,
                 backend: str = "torch",
                 cost: CostModel | None = None,
                 fused: bool = True,
                 stage_b: str = "auto",
                 coalesce: bool = False,
                 plan_cache_dir: str | None = None,
                 tune: bool = False,
                 validate: str = "strict",
                 mesh=None, shards: int | None = None,
                 device="cuda") -> "SpMV":
        """Build the plan and the executor on ``device`` (default
        ``"cuda"``, which raises when no CUDA device exists).  ``backend``
        is ``"torch"`` (plain torch ops) or ``"cuda"`` (the hand-written
        stage-A kernels).  ``coalesce=True`` opts in to the
        gather-coalescing lowering pass (DESIGN.md §8).  ``validate`` is the
        ingestion policy (DESIGN.md §9): ``"strict"`` (default) raises
        :class:`~repro_torch.core.validate.InputError` on out-of-range
        indices or non-finite values, ``"repair"`` drops or combines them
        into a canonical matrix (report on ``.validation``), ``"off"`` skips
        the checks."""
        if backend == "auto" or tune:
            raise _not_ported("the tuner (backend='auto' / tune=True)",
                              "queue 1, item 7")
        if mesh is not None or shards is not None:
            raise _not_ported("sharded execution (mesh= / shards=)",
                              "queue 1, items 3.4 and 10")
        if plan_cache_dir is not None:
            raise _not_ported("the plan cache (plan_cache_dir=)",
                              "queue 1, item 7")
        dev = eng.resolve_device(device)
        with _trace.span("app.spmv.build", backend=backend,
                         nnz=int(np.asarray(vals).size)):
            return cls._from_coo(
                rows, cols, vals, shape, lane_width=lane_width,
                backend=backend, cost=cost, fused=fused, stage_b=stage_b,
                coalesce=coalesce, validate=validate, device=dev)

    @classmethod
    def _from_coo(cls, rows, cols, vals, shape, *, lane_width, backend,
                  cost, fused, stage_b, coalesce, validate,
                  device) -> "SpMV":
        seed = spmv_seed()
        rows, cols, vals, vreport = validation.validate_coo(
            rows, cols, np.asarray(vals), shape, policy=validate)
        access = {"row": rows, "col": cols}
        with validation.collect_degradations() as events:
            cost = cost or CostModel(lane_width=lane_width)
            plan = build_plan(seed, access, shape[0], shape[1], cost=cost)
            run = eng.make_executor(plan, {"value": vals}, backend=backend,
                                    fused=fused, stage_b=stage_b,
                                    coalesce=coalesce, device=device)
        return cls(plan=plan, shape=shape, _run=run, dtype=vals.dtype,
                   device=device, validation=vreport,
                   degradations=tuple(events))

    @classmethod
    def from_csr(cls, indptr: np.ndarray, indices: np.ndarray,
                 vals: np.ndarray, shape: tuple[int, int],
                 validate: str = "strict", **kw) -> "SpMV":
        """CSR ingestion.  The row partition is validated BEFORE the
        ``np.repeat`` expansion: a non-monotone or wrong-length ``indptr``
        raises a structured :class:`~repro_torch.core.validate.InputError`
        under any policy but ``"off"``.  Entry-level defects follow
        ``validate`` exactly as :meth:`from_coo` does."""
        indptr, indices, vals, vreport = validation.validate_csr(
            indptr, indices, vals, shape, policy=validate)
        rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
        # entries were already validated/repaired above — do not repeat
        # (or re-repair) the work in from_coo
        app = cls.from_coo(rows, indices, vals, shape, validate="off", **kw)
        app.validation = vreport
        return app

    def matvec(self, x, y_init: torch.Tensor | None = None) -> torch.Tensor:
        """``y = y_init (+) A x`` on the app's device.  ``x`` may be a
        numpy array (copied to the device) or a tensor already there."""
        if isinstance(x, torch.Tensor):
            if x.device != self.device:
                raise ValueError(f"x is on {x.device}, the SpMV on "
                                 f"{self.device}")
        else:
            x = torch.as_tensor(np.asarray(x), device=self.device)
        if y_init is None:
            y_init = self._y0.get(x.dtype)
            if y_init is None:
                y_init = self._y0[x.dtype] = torch.zeros(
                    self.shape[0], dtype=x.dtype, device=self.device)
        return self._run({"x": x}, y_init)

    def matvec_many(self, xs, bucket: bool = True):
        raise _not_ported("SpMV.matvec_many", "queue 1, item 3.2")

    def report(self):
        raise _not_ported("SpMV.report()", "queue 1, item 3.5")
