"""Applications built on the Intelligent-Unroll engine (paper §7).

* :class:`SpMV` — COO sparse matrix-vector product (paper Alg. 5).  The plan
  is built once per matrix (access arrays immutable); ``matvec`` runs the
  executor over the mutable ``x`` with a cached per-dtype zero ``y_init``,
  and ``matvec_many`` runs it once over ``S`` stacked vectors.
* :class:`PageRank` — edge-push power iteration (paper Alg. 4); one plan for
  the whole run, reused every iteration.  ``driver="resident"`` (default)
  queues all iterations without waiting; ``driver="host"`` waits for each
  (the A/B baseline); both return bitwise-identical ranks.
* :class:`BFS` / :class:`SSSP` / :class:`ConnectedComponents` — the graph
  applications (non-add semirings), re-exported from
  :mod:`repro_torch.core.graphs`.

A port of the JAX package's ``core/apps.py``.  The tuner
(``backend="auto"`` / ``tune=True``), sharded execution (``mesh=`` /
``shards=``), the plan cache (``plan_cache_dir=``) and ``report()`` are
later slices of the port; asking for one raises ``NotImplementedError``
naming its ``ROADMAP.md`` item.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.core import validate as validation
from repro_torch.core.graphs import bucket_size, check_ported, not_ported
from repro_torch.core.plan import BlockPlan, CostModel, build_plan
from repro_torch.core.seed import pagerank_seed, spmv_seed
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace


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
        check_ported(backend, tune, mesh, shards, plan_cache_dir)
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
        numpy array (copied to the device) or a tensor already there.

        Dtypes, on both backends alike: the product runs in
        ``torch.promote_types(values, x)`` (float32 values with a float64
        ``x`` in float64, with a float16 or int32 ``x`` in float32) and the
        result has ``y_init``'s dtype, by default ``x``'s, as the
        reference's.  The ``"cuda"`` backend has kernels for float32,
        float64 and int32 products and raises for any other."""
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
        ``bucket=True`` pads ``S`` up ``graphs.BATCH_BUCKETS`` by replicating
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
        raise not_ported("SpMV.report()", "queue 1, item 3.5")


@dataclasses.dataclass
class PageRank:
    plan: BlockPlan
    num_nodes: int
    inv_deg: torch.Tensor
    dangling: torch.Tensor
    damping: float
    _run: object
    device: torch.device
    driver: str = "resident"
    validation: object | None = None    # ValidationReport from from_edges
    degradations: tuple = ()            # DegradationEvents from the build
    # cached zero out_init
    _zero: torch.Tensor | None = dataclasses.field(default=None, repr=False)

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray, num_nodes: int,
                   damping: float = 0.85, lane_width: int = 128,
                   backend: str = "torch",
                   cost: CostModel | None = None,
                   fused: bool = True,
                   plan_cache_dir: str | None = None,
                   tune: bool = False,
                   driver: str = "resident",
                   validate: str = "strict",
                   mesh=None, shards: int | None = None,
                   device="cuda") -> "PageRank":
        """Build the plan and the contribution sweep on ``device`` (default
        ``"cuda"``, which raises when no CUDA device exists).  ``backend``
        is ``"torch"`` or ``"cuda"``; ranks are float32."""
        check_ported(backend, tune, mesh, shards, plan_cache_dir)
        dev = eng.resolve_device(device)
        with _trace.span("app.pagerank.build", backend=backend,
                         num_nodes=num_nodes):
            src, dst, _, vreport = validation.validate_edges(
                src, dst, num_nodes, policy=validate)
            deg = np.bincount(src, minlength=num_nodes).astype(np.float64)
            inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
            with validation.collect_degradations() as events:
                plan = build_plan(pagerank_seed(), {"n2": dst, "n1": src},
                                  num_nodes, num_nodes,
                                  cost=cost or CostModel(
                                      lane_width=lane_width))
                run = eng.make_executor(plan, {}, backend=backend,
                                        fused=fused, device=dev)
        return cls(plan=plan, num_nodes=num_nodes,
                   inv_deg=torch.as_tensor(inv, dtype=torch.float32,
                                           device=dev),
                   dangling=torch.as_tensor(deg == 0, device=dev),
                   damping=damping, _run=run, device=dev, driver=driver,
                   validation=vreport, degradations=tuple(events))

    def sweep(self, rank: torch.Tensor,
              out_init: torch.Tensor | None = None) -> torch.Tensor:
        """One contribution pass: sum[n2] += rank[n1] * inv_deg[n1],
        folded into ``out_init`` (default: the cached zero vector)."""
        if out_init is None:
            if self._zero is None:
                self._zero = torch.zeros(self.num_nodes, dtype=torch.float32,
                                         device=self.device)
            out_init = self._zero
        return self._run({"rank": rank, "inv_nneighbor": self.inv_deg},
                         out_init)

    def _step(self, rank: torch.Tensor) -> torch.Tensor:
        """One power iteration: contribution sweep, dangling-mass
        reduction by the pinned-order :func:`engine.tree_sum`, damping
        fold.  Both drivers run exactly this, so their ranks are bitwise
        equal."""
        n, damping = self.num_nodes, self.damping
        mass = eng.tree_sum(torch.where(self.dangling, rank, 0.0))
        return (1.0 - damping) / n + damping * (self.sweep(rank) + mass / n)

    def run(self, iters: int = 20, driver: str | None = None
            ) -> torch.Tensor:
        """``iters`` power iterations from the uniform distribution;
        (num_nodes,) float32 ranks on the app's device.

        ``driver="resident"`` (default) queues every iteration and returns
        without waiting for the device; ``driver="host"`` waits for each
        iteration to finish before it queues the next (the stepwise
        baseline)."""
        driver = driver or self.driver
        if driver not in ("resident", "host"):
            raise ValueError(f"unknown driver {driver!r}; "
                             "expected 'resident' or 'host'")
        with _trace.span("pagerank.run", iters=iters, driver=driver):
            rank = torch.full((self.num_nodes,), 1.0 / self.num_nodes,
                              dtype=torch.float32, device=self.device)
            for _ in range(iters):
                rank = self._step(rank)
                if driver == "host" and rank.is_cuda:
                    torch.cuda.synchronize(rank.device)
            return rank

    def report(self):
        raise not_ported("PageRank.report()", "queue 1, items 3.5 and 8")


def pagerank_reference(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                       damping: float = 0.85, iters: int = 20) -> np.ndarray:
    """Dense numpy oracle for PageRank (float64)."""
    deg = np.bincount(src, minlength=num_nodes).astype(np.float64)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    rank = np.full(num_nodes, 1.0 / num_nodes)
    for _ in range(iters):
        contrib = np.zeros(num_nodes)
        np.add.at(contrib, dst, rank[src] * inv[src])
        dangling_mass = rank[deg == 0].sum()
        rank = (1 - damping) / num_nodes + damping * (
            contrib + dangling_mass / num_nodes)
    return rank


# graph applications live in their own module; re-exported here so callers
# have one `repro_torch.core.apps` entry point for every paper §7 workload.
from repro_torch.core.graphs import (BFS, SSSP,  # noqa: E402,F401
                                     ConnectedComponents)
