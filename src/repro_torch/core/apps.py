"""Applications built on the Intelligent-Unroll engine (paper §7).

* :class:`SpMV` — COO sparse matrix-vector product (paper Alg. 5).  The plan
  is built once per matrix (access arrays immutable); ``matvec`` runs the
  executor over the mutable ``x`` with a cached per-dtype zero ``y_init``,
  and ``matvec_many`` runs it once over ``S`` stacked vectors.

A port of ``SpMV`` from the JAX package's ``core/apps.py``: ``from_coo``,
``from_csr``, ``matvec`` and ``matvec_many``.  The tuner (``backend="auto"``
/ ``tune=True``), sharded execution (``mesh=`` / ``shards=``), the plan
cache (``plan_cache_dir=``) and ``report()`` are later slices of the port;
asking for one raises ``NotImplementedError`` naming its ``ROADMAP.md``
item.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.core import validate as validation
from repro_torch.core.plan import BlockPlan, CostModel, build_plan
from repro_torch.core.seed import spmv_seed
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

# Batch-size bucket ladder of the batched entry points (the JAX package's
# ``core/graphs.py`` ``BATCH_BUCKETS``): a batch of S rows is padded up to
# the next rung by replicating its last row, so distinct arrival counts
# share one batched shape.
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md {item})")


def _check_ported(backend, tune, mesh, shards, plan_cache_dir) -> None:
    """Raise for the ``from_coo`` options that later slices port."""
    if backend == "auto" or tune:
        raise _not_ported("the tuner (backend='auto' / tune=True)",
                          "queue 1, item 7")
    if mesh is not None or shards is not None:
        raise _not_ported("sharded execution (mesh= / shards=)",
                          "queue 1, items 3.4 and 10")
    if plan_cache_dir is not None:
        raise _not_ported("the plan cache (plan_cache_dir=)",
                          "queue 1, item 7")


def bucket_size(n: int, ladder: tuple = BATCH_BUCKETS) -> int:
    """Round a batch count up the bucket ladder; above the top rung, up to
    a multiple of it."""
    if n <= 0:
        raise ValueError(f"batch count must be positive, got {n}")
    for b in ladder:
        if n <= b:
            return int(b)
    top = int(ladder[-1])
    return ((n + top - 1) // top) * top


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
    # distinct (S, dtype) shapes matvec_many has run
    _batched_shapes: set = dataclasses.field(default_factory=set,
                                             repr=False)

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
        _check_ported(backend, tune, mesh, shards, plan_cache_dir)
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

    def matvec_many(self, xs, bucket: bool = True) -> torch.Tensor:
        """Batched matvec ``(S, n) -> (S, m)``: ONE run of the executor with
        the ``S`` vectors as a trailing lane axis (``x`` as ``(n, S)``, the
        SpMM program), where the reference vmaps the 1-D program.  Every
        lane of column ``i`` runs exactly the arithmetic of ``matvec(xs[i])``
        in the same order, so row ``i`` is bitwise equal to it.
        ``bucket=True`` pads ``S`` up :data:`BATCH_BUCKETS` by replicating
        the last row (sliced off the result); each distinct padded shape
        counts once in the ``spmv.batched_shapes`` counter."""
        if isinstance(xs, torch.Tensor):
            if xs.device != self.device:
                raise ValueError(f"xs is on {xs.device}, the SpMV on "
                                 f"{self.device}")
        else:
            xs = torch.as_tensor(np.asarray(xs), device=self.device)
        if xs.ndim != 2 or xs.shape[1] != self.shape[1]:
            raise ValueError(
                f"matvec_many expects (S, {self.shape[1]}) inputs, "
                f"got {tuple(xs.shape)}")
        n = xs.shape[0]
        if bucket and bucket_size(n) > n:
            xs = torch.cat([xs, xs[-1:].expand(bucket_size(n) - n, -1)])
        key = (xs.shape[0], xs.dtype)
        if key not in self._batched_shapes:
            self._batched_shapes.add(key)
            _metrics.inc("spmv.batched_shapes")
        x = xs.T.contiguous()
        y0 = torch.zeros((self.shape[0], xs.shape[0]), dtype=x.dtype,
                         device=self.device)
        return self._run({"x": x}, y0).T[:n].contiguous()

    def report(self):
        raise _not_ported("SpMV.report()", "queue 1, item 3.5")
