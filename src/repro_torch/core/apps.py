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

``backend="auto"`` (or ``tune=True``) picks the execution variant per
input by measurement on the app's device (:mod:`repro_torch.tune`), the
choice recorded in ``.tuning`` and cached in ``tune_cache_dir``;
``plan_cache_dir`` holds content-addressed plans
(:mod:`repro_torch.core.planio`); ``report()`` returns a
:class:`~repro_torch.obs.profile.RunReport`.

``mesh=`` / ``shards=`` select sharded execution (DESIGN.md §10): the
plan is partitioned along row ranges and each shard's subtree runs on its
own device of a :class:`~repro_torch.launch.mesh.ShardMesh`, bitwise equal
to single-device execution of the same backend (``torch`` or ``segsum``;
the ``cuda`` kernels are single-device).  A simulated mesh places every
shard on one device: ``mesh=make_shard_mesh(k, device=..., simulate=True)``,
or for ``SpMV`` (and ``SpMM``) ``simulate_mesh=True`` next to ``shards=``,
which is also how their tuner, whose ``shards=k`` under
``backend="auto"`` is a tuned axis over ``{1, k}``, simulates one.

A port of the JAX package's ``core/apps.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.core import validate as validation
from repro_torch.core.graphs import bucket_size, build_or_tune
from repro_torch.core.plan import BlockPlan, CostModel
from repro_torch.core.seed import pagerank_seed, spmv_seed
from repro_torch.launch.sharding import row_sharding
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace


@dataclasses.dataclass
class SpMV:
    plan: BlockPlan
    shape: tuple[int, int]
    _run: object
    dtype: np.dtype
    device: torch.device
    tuning: object | None = None   # TuningResult when built via backend="auto"
    validation: object | None = None    # ValidationReport from from_coo
    degradations: tuple = ()            # DegradationEvents from the build
    # sharded execution (DESIGN.md §10): the mesh the executor runs over
    # (None = single device) and the per-shard plan subtrees
    mesh: object | None = None
    _shard_parts: tuple = dataclasses.field(default=(), repr=False)
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
                 tune_cache_dir: str | None = None,
                 validate: str = "strict",
                 mesh=None, shards: int | None = None,
                 simulate_mesh: bool = False,
                 device="cuda") -> "SpMV":
        """Build the plan and the executor on ``device`` (default
        ``"cuda"``, which raises when no CUDA device exists).  ``backend``
        is ``"torch"`` (plain torch ops), ``"segsum"`` (one segment
        reduce), ``"cuda"`` (the hand-written stage-A kernels) or
        ``"auto"``: ``backend="auto"`` (or ``tune=True``) selects the
        variant per matrix by measurement on ``device``, cached in
        ``tune_cache_dir`` so warm processes skip the measurements; the
        decision is recorded in ``.tuning``.  ``coalesce=True`` opts in to
        the gather-coalescing lowering pass (DESIGN.md §8); under
        ``backend="auto"`` it is a tuned axis.  ``plan_cache_dir`` holds
        content-addressed plans (needs the optional ``msgpack``; without
        it the plan is built each time).  ``validate`` is the ingestion
        policy (DESIGN.md §9): ``"strict"`` (default) raises
        :class:`~repro_torch.core.validate.InputError` on out-of-range
        indices or non-finite values, ``"repair"`` drops or combines them
        into a canonical matrix (report on ``.validation``), ``"off"`` skips
        the checks.

        ``mesh=`` / ``shards=`` select sharded execution (DESIGN.md §10):
        the plan is partitioned along row ranges and each shard's subtree
        runs on its own mesh device, bitwise equal to single-device
        execution.  ``shards=k`` builds a mesh of ``k`` devices of
        ``device``'s type, or with ``simulate_mesh=True`` places all ``k``
        shards on ``device``.  Under ``backend="auto"`` the shard count
        becomes a *tuned axis* (the space gains ``{1, shards}``
        candidates and the measured winner decides); an explicit ``mesh``
        cannot be combined with the tuner, and ``backend="cuda"`` cannot
        be sharded."""
        dev = eng.resolve_device(device)
        with _trace.span("app.spmv.build", backend=backend,
                         nnz=int(np.asarray(vals).size)):
            return cls._from_coo(
                rows, cols, vals, shape, lane_width=lane_width,
                backend=backend, cost=cost, fused=fused, stage_b=stage_b,
                coalesce=coalesce, plan_cache_dir=plan_cache_dir, tune=tune,
                tune_cache_dir=tune_cache_dir, validate=validate, mesh=mesh,
                shards=shards, simulate_mesh=simulate_mesh, device=dev)

    @classmethod
    def _from_coo(cls, rows, cols, vals, shape, *, lane_width, backend,
                  cost, fused, stage_b, coalesce, plan_cache_dir, tune,
                  tune_cache_dir, validate, mesh, shards, simulate_mesh,
                  device) -> "SpMV":
        seed = spmv_seed()
        rows, cols, vals, vreport = validation.validate_coo(
            rows, cols, np.asarray(vals), shape, policy=validate)
        access = {"row": rows, "col": cols}

        def example():
            dt = vals.dtype if np.issubdtype(vals.dtype, np.inexact) \
                else np.float32
            x_ex = torch.as_tensor(np.random.default_rng(0)
                                   .standard_normal(shape[1]).astype(dt),
                                   device=device)
            return {"x": x_ex}, torch.zeros(shape[0], dtype=x_ex.dtype,
                                            device=device)
        with validation.collect_degradations() as events:
            plan, run, tuning, mesh, parts = build_or_tune(
                "SpMV.from_coo", seed, access, shape[0], shape[1],
                {"value": vals}, backend=backend, tune=tune,
                lane_width=lane_width, cost=cost, fused=fused,
                stage_b=stage_b, coalesce=coalesce, device=device,
                plan_cache_dir=plan_cache_dir,
                tune_cache_dir=tune_cache_dir, example=example, mesh=mesh,
                shards=shards, simulate_mesh=simulate_mesh,
                tuned_shards=True)
        return cls(plan=plan, shape=shape, _run=run, dtype=vals.dtype,
                   device=device, tuning=tuning, validation=vreport,
                   degradations=tuple(events), mesh=mesh,
                   _shard_parts=parts)

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
        counts once in the ``spmv.batched_shapes`` counter.  A sharded
        SpMV raises ``NotImplementedError``, as the reference's does."""
        if self._shard_parts:
            raise NotImplementedError(
                "matvec_many on a sharded SpMV; build without "
                "mesh=/shards= for batched serving")
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
        """Structured :class:`~repro_torch.obs.profile.RunReport`: plan
        stats, IR pass deltas, per-launch cost attribution, tuning choice,
        validation summary, and recorded degradations."""
        from repro_torch.obs.profile import build_report
        return build_report(self, "SpMV")


@dataclasses.dataclass
class PageRank:
    plan: BlockPlan
    num_nodes: int
    inv_deg: torch.Tensor
    dangling: torch.Tensor
    damping: float
    _run: object
    device: torch.device
    tuning: object | None = None   # TuningResult when built via backend="auto"
    driver: str = "resident"
    validation: object | None = None    # ValidationReport from from_edges
    degradations: tuple = ()            # DegradationEvents from the build
    # sharded execution (DESIGN.md §10), and the sharded resident step
    # (:meth:`_sharded_step`)
    mesh: object | None = None
    _shard_parts: tuple = dataclasses.field(default=(), repr=False)
    _shard_step: object = dataclasses.field(default=None, repr=False)
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
                   tune_cache_dir: str | None = None,
                   driver: str = "resident",
                   validate: str = "strict",
                   mesh=None, shards: int | None = None,
                   device="cuda") -> "PageRank":
        """Build the plan and the contribution sweep on ``device`` (default
        ``"cuda"``, which raises when no CUDA device exists).  ``backend``
        is ``"torch"``, ``"segsum"``, ``"cuda"`` or ``"auto"`` (measured,
        as :meth:`SpMV.from_coo`); ranks are float32.  ``mesh=`` /
        ``shards=`` shard the contribution sweep as :meth:`SpMV.from_coo`'s
        (not with the tuner; a simulated mesh is
        ``mesh=make_shard_mesh(k, device=..., simulate=True)``)."""
        dev = eng.resolve_device(device)
        with _trace.span("app.pagerank.build", backend=backend,
                         num_nodes=num_nodes):
            src, dst, _, vreport = validation.validate_edges(
                src, dst, num_nodes, policy=validate)
            seed = pagerank_seed()
            access = {"n2": dst, "n1": src}
            deg = np.bincount(src, minlength=num_nodes).astype(np.float64)
            inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
            inv_t = torch.as_tensor(inv, dtype=torch.float32, device=dev)

            def example():
                rank_ex = torch.full((num_nodes,), 1.0 / max(num_nodes, 1),
                                     dtype=torch.float32, device=dev)
                return ({"rank": rank_ex, "inv_nneighbor": inv_t},
                        torch.zeros(num_nodes, dtype=torch.float32,
                                    device=dev))
            with validation.collect_degradations() as events:
                plan, run, tuning, mesh, parts = build_or_tune(
                    "PageRank.from_edges", seed, access, num_nodes,
                    num_nodes, {}, backend=backend, tune=tune,
                    lane_width=lane_width, cost=cost, fused=fused,
                    device=dev, plan_cache_dir=plan_cache_dir,
                    tune_cache_dir=tune_cache_dir, example=example,
                    mesh=mesh, shards=shards)
        app = cls(plan=plan, num_nodes=num_nodes, inv_deg=inv_t,
                  dangling=torch.as_tensor(deg == 0, device=dev),
                  damping=damping, _run=run, device=dev, tuning=tuning,
                  driver=driver, validation=vreport,
                  degradations=tuple(events), mesh=mesh, _shard_parts=parts)
        if parts:
            app._shard_step = app._sharded_step()
        return app

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
        baseline).  On a sharded app the resident driver carries the
        ranks row-sharded (:meth:`_resident_sharded`) and the host driver
        runs :meth:`_step` over the full-array sharded executor."""
        driver = driver or self.driver
        if driver not in ("resident", "host"):
            raise ValueError(f"unknown driver {driver!r}; "
                             "expected 'resident' or 'host'")
        with _trace.span("pagerank.run", iters=iters, driver=driver):
            rank = torch.full((self.num_nodes,), 1.0 / self.num_nodes,
                              dtype=torch.float32, device=self.device)
            if driver == "resident" and self._shard_parts:
                return self._resident_sharded(rank, iters)
            for _ in range(iters):
                rank = self._step(rank)
                if driver == "host" and rank.is_cuda:
                    torch.cuda.synchronize(rank.device)
            return rank

    def _resident_sharded(self, rank: torch.Tensor, iters: int
                          ) -> torch.Tensor:
        """The sharded resident driver (DESIGN.md §10): the ranks live
        row-sharded as padded per-shard pieces; each iteration all-gathers
        the pieces into the full rank vector and every shard applies the
        damping fold to its own rows.  Bitwise vs single-device: the
        dangling mass is :func:`engine.tree_sum` over the SAME reassembled
        full vector on every shard (the combine order of :meth:`_step`),
        never a sum of per-shard partial sums."""
        step = self._shard_step
        pieces = eng.pad_rows(rank, step.widths, step.padded_width,
                              step.devices)
        for _ in range(iters):
            pieces = step(pieces)
        return eng.unpad_rows(pieces, step.widths, rank.device)

    def _sharded_step(self):
        """The sharded resident iteration: the sharded executor's sweep
        bodies, each wrapped in the damping fold of :meth:`_step` on its
        shard's device."""
        n, damping = self.num_nodes, self.damping

        def mk(body, dev):
            inv, dangling = self.inv_deg.to(dev), self.dangling.to(dev)

            def f(full_rank, local_prev):
                contrib = body({"rank": full_rank, "inv_nneighbor": inv},
                               torch.zeros_like(local_prev))
                mass = eng.tree_sum(torch.where(dangling, full_rank, 0.0))
                return (1.0 - damping) / n + damping * (contrib + mass / n)
            return f
        return eng.make_sharded_fixpoint_step(
            self._run, "rank", with_convergence=False,
            local_steps=[mk(b, d) for b, d in
                         zip(self._run.bodies, row_sharding(self.mesh))])

    def report(self):
        """Structured :class:`~repro_torch.obs.profile.RunReport`: plan
        stats, IR pass deltas, per-launch cost attribution, tuning choice,
        validation summary, and recorded degradations."""
        from repro_torch.obs.profile import build_report
        return build_report(self, "PageRank")


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
