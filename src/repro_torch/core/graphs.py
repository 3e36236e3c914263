"""Graph applications on the Intelligent-Unroll engine (paper §7).

The paper's headline evaluation is "SpMV and graph applications" (Alg. 4):
this module supplies the graph side.  Each application is one
:class:`~repro_torch.core.seed.CodeSeed` over the edge list, executed
through the plan/executor stack, and each exercises a *non-add* reduce:

* :class:`BFS` — frontier-free level relaxation, ``min`` reduce over int32
  levels (``level[dst] = min(level[dst], level[src] + 1)``),
* :class:`SSSP` — Bellman-Ford over the (min, +) semiring
  (``dist[dst] = min(dist[dst], dist[src] + w)``),
* :class:`ConnectedComponents` — min-label propagation over the
  symmetrized edge list (``label[dst] = min(label[dst], label[src])``).

The plan is a pure function of the immutable edge list, built ONCE in
``from_edges`` and reused by every sweep (``plan_build_count()`` lets tests
assert exactly that).  A sweep is the executor the SpMV path uses, folded
into ``out_init`` = the previous state, so rows with no incoming edge keep
their value and a fixpoint is exact equality: the convergence check needs
no tolerance.  On ``backend="cuda"`` every vload launch of a sweep runs on
the stage-A kernels, in their ``"add_all"`` combine.

Two convergence drivers, bitwise equal in states, sweep counts and
:class:`ConvergenceReport`:

* ``driver="resident"`` (default) queues the sweeps on the device in
  chunks of :data:`SYNC_EVERY` with no host read between them: each sweep
  folds its changed and healthy flags into device-side flags, and a sweep
  after the run stopped leaves the state as it was (``torch.where``), so
  the host reads the flags once per chunk (:func:`read_flags`), where the
  reference runs one ``lax.while_loop``.
* ``driver="host"`` reads the flags after every sweep (the A/B baseline).

``backend="auto"`` (or ``tune=True``) picks the sweep's variant per graph
by measurement (:mod:`repro_torch.tune`); under the resident driver each
candidate is timed over :data:`_TUNE_RUN_SWEEPS` queued sweeps.
``plan_cache_dir=`` routes the plan build through the content-addressed
plan cache (:mod:`repro_torch.core.planio`), and ``report()`` returns a
:class:`~repro_torch.obs.profile.RunReport`.

``mesh=`` / ``shards=`` select sharded execution (DESIGN.md §10): the
plan is partitioned along row ranges (``ir.partition_plan``) and each
shard's subtree runs on its own device of a
:class:`~repro_torch.launch.mesh.ShardMesh`; the resident driver carries
the state row-sharded, the host driver runs the full-array sharded
executor, and both are bitwise the single-device run of the same backend
in states, sweep counts and :class:`ConvergenceReport`.
``mesh=make_shard_mesh(k, device=..., simulate=True)`` places every shard
on one device (a simulated mesh).  The ``cuda`` backend is single-device,
and ``run_multi`` raises on a sharded app, as in the reference.

A port of the JAX package's ``core/graphs.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.core import ir
from repro_torch.core import validate as validation
from repro_torch.core.plan import BlockPlan, CostModel
from repro_torch.core.planio import cached_build_plan
from repro_torch.core.seed import CodeSeed, bfs_seed, cc_seed, sssp_seed
from repro_torch.launch.mesh import make_shard_mesh, resolve_shard_mesh
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

# int32 "infinity" for BFS levels / CC labels of unreached nodes: large
# enough to dominate every real level (< num_nodes), small enough that
# ``UNREACHED + 1`` in the combine can never wrap int32 (the reduce
# *identity* iinfo(int32).max is reserved for pad lanes, which are never
# fed back into a combine).
UNREACHED = np.int32(1 << 30)

# Sweeps the resident driver queues between two reads of its flags: a run
# of s sweeps reads the device ceil(s / SYNC_EVERY) times (once when s is
# 0), and runs at most SYNC_EVERY - 1 sweeps past its stop, whose results
# it discards.
SYNC_EVERY = 4

# Batch-size bucket ladder of the batched entry points (``run_multi``,
# ``SpMV.matvec_many``): a batch of S rows is padded up to the next rung by
# replicating its last row, so distinct arrival counts share one batched
# shape.
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


@dataclasses.dataclass(frozen=True)
class ConvergenceReport:
    """How a fixpoint run ended (DESIGN.md §9).

    Exactly one of the three terminal flags is set on a completed run:

    * ``converged`` — exact fixpoint reached on a healthy state,
    * ``diverged`` — the state went numerically unhealthy (NaN, or a
      wrong-direction infinity for the semiring: see
      :func:`engine.state_healthy`); the run stopped at that sweep,
    * ``exhausted`` — ``max_sweeps`` elapsed on a healthy,
      still-changing state.

    ``negative_cycle`` refines ``exhausted`` for Bellman-Ford SSSP: a
    synchronous sweep that still relaxes something after ``num_nodes``
    rounds proves a reachable negative cycle, so exhaustion at the
    default bound (``num_nodes + 1``) is a detection, not a timeout.
    ``sweeps`` is the number of sweeps the run's result went through."""

    sweeps: int = 0
    converged: bool = False
    diverged: bool = False
    exhausted: bool = False
    negative_cycle: bool = False


def check_auto_kwargs(name: str, *, backend: str = "auto",
                      fused: bool = True, stage_b: str = "auto",
                      cost=None, coalesce: bool = False, mesh=None,
                      shards: int | None = None) -> None:
    """``backend="auto"`` / ``tune=True`` hand variant selection to the
    tuner — an explicit ``fused`` / ``stage_b`` / ``cost`` / ``coalesce``
    (or a non-default backend next to ``tune=True``) alongside it would be
    dropped without a word.  Raise instead: the caller either wants the
    tuner (drop the variant kwargs) or a specific variant (name the
    backend explicitly, without ``tune``)."""
    conflicts = []
    # "torch" is the signature default, so it cannot signal an explicit
    # request; any OTHER backend next to tune=True clearly does
    if backend not in ("auto", "torch"):
        conflicts.append(f"backend={backend!r}")
    if fused is not True:
        conflicts.append("fused")
    if stage_b != "auto":
        conflicts.append("stage_b")
    if cost is not None:
        conflicts.append("cost")
    if coalesce is not False:
        conflicts.append("coalesce")
    # an explicit mesh pins placement, but the tuner owns placement when a
    # shard-count axis is in play; graph apps additionally reject shards=
    # here (their tuner has no shard axis — SpMV/SpMM carry that)
    if mesh is not None:
        conflicts.append("mesh")
    if shards is not None:
        conflicts.append("shards")
    if conflicts:
        raise ValueError(
            f"{name}: backend='auto'/tune=True selects the execution "
            f"variant by measurement, but explicit {', '.join(conflicts)} "
            "was also given and would be silently ignored — drop it, or "
            "pick an explicit backend (without tune=True) to pin the "
            "variant")


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


def bucket_ladder_upto(n: int, ladder: tuple = BATCH_BUCKETS) -> list:
    """Every distinct batch size the bucket padding can produce for
    request counts in ``1..n``."""
    top = bucket_size(n, ladder)
    return [int(b) for b in ladder if b <= top] + (
        [top] if top > ladder[-1] else [])


def pad_to_bucket(batch: np.ndarray, ladder: tuple = BATCH_BUCKETS
                  ) -> tuple[np.ndarray, int]:
    """Pad ``batch`` (leading axis = requests) up to :func:`bucket_size`
    by replicating the last row.  Returns ``(padded, original_count)``;
    callers slice ``result[:original_count]``.  Replicating a REAL row
    keeps padded fixpoint rows on the trajectory of their source row, so
    padding can never add sweeps."""
    batch = np.asarray(batch)
    s = batch.shape[0]
    b = bucket_size(s, ladder)
    if b == s:
        return batch, s
    pad = np.repeat(batch[-1:], b - s, axis=0)
    return np.concatenate([batch, pad], axis=0), s


def batched_shape_count() -> int:
    """Distinct batched state shapes that entered a batched convergence
    across all fixpoint apps (the ``graphs.batched_shapes`` counter)."""
    return int(_metrics.value("graphs.batched_shapes"))


def plan_build_count() -> int:
    """Total ``build_plan`` invocations made by this module (the
    ``graphs.plan_builds`` counter): one per graph across all sweeps."""
    return int(_metrics.value("graphs.plan_builds"))


def build_or_tune(name: str, seed: CodeSeed, access, out_len: int,
                  data_len: int, static, *, backend: str, tune: bool,
                  lane_width: int, cost, fused: bool = True,
                  stage_b: str = "auto", coalesce: bool = False, device,
                  plan_cache_dir, tune_cache_dir, example, mesh=None,
                  shards: int | None = None, simulate_mesh: bool = False,
                  tuned_shards: bool = False, **tune_kw):
    """Every app's one build policy; returns ``(plan, run, tuning, mesh,
    shard_parts)``.

    Under ``backend="auto"`` / ``tune=True`` the tuner picks the plan and
    the executor, timing candidates on ``example() -> (mutable_example,
    out_init)``, tensors on ``device``; ``tune_kw`` goes on to
    :func:`~repro_torch.tune.autotune`.  ``tuned_shards`` (SpMV, SpMM)
    makes ``shards=k`` a tuned axis over ``{1, k}``; an explicit ``mesh``
    always conflicts with the tuner.  Otherwise one plan, through the plan
    cache when ``plan_cache_dir`` is given, and ``backend``'s executor —
    the sharded one over the mesh that ``mesh`` / ``shards`` select
    (:func:`~repro_torch.launch.mesh.resolve_shard_mesh`), else the
    single-device one with ``mesh`` None and ``shard_parts`` empty."""
    if backend == "auto" or tune:
        check_auto_kwargs(name, backend=backend, fused=fused,
                          stage_b=stage_b, cost=cost, coalesce=coalesce,
                          mesh=mesh, shards=None if tuned_shards else shards)
        from repro_torch.tune import autotune
        shard_counts = None
        if shards is not None:
            make_shard_mesh(int(shards), device, simulate_mesh)  # validate
            shard_counts = tuple(sorted({1, int(shards)}))
        elif simulate_mesh:
            raise ValueError("simulate_mesh=True needs shards=")
        mutable_example, out_init = example()
        plan, run, tuning = autotune(
            seed, access, out_len, data_len, static, mutable_example,
            out_init, lane_widths=(lane_width,), shard_counts=shard_counts,
            simulate_mesh=simulate_mesh, tune_cache_dir=tune_cache_dir,
            plan_cache_dir=plan_cache_dir, **tune_kw)
        return (plan, run, tuning, getattr(run, "mesh", None),
                tuple(getattr(run, "parts", ())))
    mesh, num_shards = resolve_shard_mesh(mesh, shards, device,
                                          simulate_mesh)
    if mesh is not None:
        eng.check_shard_backend(backend)
    plan = cached_build_plan(seed, access, out_len, data_len,
                             cost=cost or CostModel(lane_width=lane_width),
                             cache_dir=plan_cache_dir)
    if mesh is None:
        run = eng.make_executor(plan, static, backend=backend, fused=fused,
                                stage_b=stage_b, coalesce=coalesce,
                                device=device)
        return plan, run, None, None, ()
    tree = ir.lower(plan, backend=backend, fused=fused, stage_b=stage_b,
                    coalesce=coalesce)
    parts = tuple(ir.partition_plan(tree, num_shards))
    return (plan, eng.make_sharded_executor(parts, static, mesh), None,
            mesh, parts)


# sweeps per timed whole-run tuning candidate under the resident driver:
# enough that the per-call dispatch a resident run amortizes is visible in
# the ranking, few enough that tuning stays cheap (the count is part of
# the tuning-cache key, so a changed discipline re-tunes)
_TUNE_RUN_SWEEPS = 8


def _sweep_measurement(state_key: str, driver: str) -> dict:
    """What a graph app's tuner TIMES follows its driver (DESIGN.md §7):
    under the resident driver each candidate is measured as
    :data:`_TUNE_RUN_SWEEPS` sweep-body calls queued back to back with no
    host read (the reference runs a ``fori_loop``), so the winner is the
    variant that wins once per-sweep waits vanish.  The host driver keeps
    the one-sweep measurement.  Every candidate's single-sweep output is
    checked against the scatter oracle either way."""
    if driver != "resident":
        return {}

    def measure_wrap(run):
        body = getattr(run, "sweep_body", None) or run

        def whole_run(mutable, _out_init):
            state = mutable[state_key]
            for _ in range(_TUNE_RUN_SWEEPS):
                state = body({state_key: state}, state)
            return state
        return whole_run
    return {"measure_wrap": measure_wrap,
            "cache_extra": f"measure=resident_run:{_TUNE_RUN_SWEEPS}"}


def read_flags(*flags: torch.Tensor) -> list[int]:
    """The convergence drivers' one way to the host: 0-d bool or int
    device tensors as Python ints, in one synchronising copy."""
    return torch.stack([f.int() for f in flags]).tolist()


@dataclasses.dataclass
class _FixpointApp:
    """Shared convergence driver: one plan, one sweep program, iterate the
    sweep until exact fixpoint (or ``max_sweeps``).  A batched run
    (``run_multi``) carries its S states as a trailing lane axis,
    ``(num_nodes, S)``, through the same sweep program; its fixpoint is
    equality over the whole batch."""

    plan: BlockPlan
    num_nodes: int
    _run: object
    _state_key: str
    device: torch.device
    tuning: object | None = None   # TuningResult when built via backend="auto"
    driver: str = "resident"
    # how the last run() ended; sweeps_run/converged stay as properties
    convergence: ConvergenceReport = dataclasses.field(
        default_factory=ConvergenceReport)
    validation: object | None = None    # ValidationReport from from_edges
    degradations: tuple = ()            # DegradationEvents from the build
    # distinct batched state shapes this app has converged, mirrored into
    # the ``graphs.batched_shapes`` counter
    _batched_shapes: set = dataclasses.field(default_factory=set,
                                             repr=False)
    # sharded execution (DESIGN.md §10): the mesh the app was built for
    # (None = single device), the per-shard plan subtrees and the resident
    # driver's step over the sharded executor's sweep bodies
    mesh: object | None = None
    _shard_parts: tuple = dataclasses.field(default=(), repr=False)
    _shard_step: object = dataclasses.field(default=None, repr=False)

    # SSSP overrides: exhaustion at >= num_nodes + 1 synchronous sweeps
    # proves a reachable negative cycle (Bellman-Ford), nothing else does
    _detects_negative_cycle = False

    @classmethod
    def _build_app(cls, seed, access, static, state_key, num_nodes, vreport,
                   *, lane_width, backend, cost, fused, stage_b, driver,
                   device, plan_cache_dir, tune, tune_cache_dir,
                   state_example, mesh, shards):
        """One plan and one sweep program; under ``backend="auto"`` /
        ``tune=True`` the tuner picks both, timing candidates on
        ``state_example()`` (a representative state on ``device``)."""
        def example():
            state = state_example()
            return {state_key: state}, state
        with validation.collect_degradations() as events:
            plan, run, tuning, mesh, parts = build_or_tune(
                f"{cls.__name__}.from_edges", seed, access, num_nodes,
                num_nodes, static, backend=backend, tune=tune,
                lane_width=lane_width, cost=cost, fused=fused,
                stage_b=stage_b, device=device,
                plan_cache_dir=plan_cache_dir,
                tune_cache_dir=tune_cache_dir, example=example, mesh=mesh,
                shards=shards, **_sweep_measurement(state_key, driver))
        _metrics.inc("graphs.plan_builds",
                     1 if tuning is None else tuning.plans_built)
        return cls(plan=plan, num_nodes=num_nodes, _run=run,
                   _state_key=state_key, device=device, tuning=tuning,
                   driver=driver, validation=vreport,
                   degradations=tuple(events), mesh=mesh,
                   _shard_parts=parts,
                   _shard_step=eng.make_sharded_fixpoint_step(run, state_key)
                   if parts else None)

    @property
    def sweeps_run(self) -> int:
        """Back-compatible alias of ``convergence.sweeps``."""
        return self.convergence.sweeps

    @property
    def converged(self) -> bool:
        """Back-compatible alias of ``convergence.converged``."""
        return self.convergence.converged

    def sweep(self, state: torch.Tensor) -> torch.Tensor:
        """One relaxation pass folded into the previous state."""
        return self._run({self._state_key: state}, state)

    def report(self):
        """Structured :class:`~repro_torch.obs.profile.RunReport` for this
        app: plan stats, IR pass deltas, per-launch cost attribution,
        tuning choice, degradations, and the last run's convergence
        story."""
        from repro_torch.obs.profile import build_report
        return build_report(self, type(self).__name__,
                            sweeps=self.convergence)

    def _report(self, sweeps: int, changed: bool, healthy: bool,
                max_sweeps: int) -> ConvergenceReport:
        """Fold a run's terminal flags into a :class:`ConvergenceReport` —
        one classification shared by both drivers."""
        converged = healthy and not changed
        diverged = not healthy
        exhausted = healthy and changed and sweeps >= max_sweeps
        negative_cycle = bool(exhausted and self._detects_negative_cycle
                              and max_sweeps >= self.num_nodes + 1)
        return ConvergenceReport(sweeps=sweeps, converged=converged,
                                 diverged=diverged, exhausted=exhausted,
                                 negative_cycle=negative_cycle)

    def _converge(self, state: torch.Tensor, max_sweeps: int | None,
                  driver: str | None = None,
                  batched: bool = False) -> torch.Tensor:
        """Iterate the sweep to exact fixpoint; ``self.convergence``
        records how the run ended: a fixpoint (``converged``), a
        numerically unhealthy state (``diverged``: the run stops at that
        sweep instead of burning ``max_sweeps``), or the sweep cap on a
        healthy, still-changing state (``exhausted``, refined to
        ``negative_cycle`` for Bellman-Ford at the full bound).  Returns
        the state at the stopping sweep."""
        driver = driver or self.driver
        with _trace.span("graphs.converge", app=type(self).__name__,
                         driver=driver, batched=batched) as sp:
            if max_sweeps is None:
                max_sweeps = self.num_nodes + 1
            self.convergence = ConvergenceReport()
            if batched and self._shard_parts:
                raise NotImplementedError(
                    "batched multi-source runs are not supported on a "
                    "sharded app; build without mesh=/shards= for "
                    "run_multi")
            if batched:
                shape_key = (tuple(state.shape), str(state.dtype))
                if shape_key not in self._batched_shapes:
                    self._batched_shapes.add(shape_key)
                    _metrics.inc("graphs.batched_shapes")
            if driver == "resident":
                out = self._converge_resident(state, max_sweeps)
            elif driver == "host":
                out = self._converge_host(state, max_sweeps)
            else:
                raise ValueError(f"unknown driver {driver!r}; "
                                 "expected 'resident' or 'host'")
            sp.set(sweeps=self.convergence.sweeps,
                   converged=self.convergence.converged,
                   diverged=self.convergence.diverged,
                   exhausted=self.convergence.exhausted)
            return out

    def _converge_resident(self, state, max_sweeps):
        """Queue the sweeps in chunks of :data:`SYNC_EVERY` and read the flags
        once per chunk.  ``active`` stays true while the run has not
        stopped; the sweep that stops it (unchanged or unhealthy) is the
        last one whose state, count and flags are kept.  On a sharded app
        the carried state is the row-sharded pieces of
        :meth:`_sharded_resident`, every other part of the loop the same,
        so sweep counts and terminal flags equal the single-device run's."""
        reduce = self.plan.seed.reduce
        if self._shard_parts:
            carry, healthy, step, keep, finish = \
                self._sharded_resident(state)
        else:
            def step(s):
                new = self.sweep(s)
                return new, (new != s).any(), eng.state_healthy(new, reduce)
            carry, healthy, keep = state, eng.state_healthy(state, reduce), \
                torch.where

            def finish(s):
                return s
        active = healthy
        changed = torch.ones((), dtype=torch.bool, device=healthy.device)
        count = torch.zeros((), dtype=torch.int32, device=healthy.device)
        queued = 0
        while True:
            for _ in range(min(SYNC_EVERY, max_sweeps - queued)):
                new, step_changed, step_healthy = step(carry)
                carry = keep(active, new, carry)
                count = count + active.int()
                changed = torch.where(active, step_changed, changed)
                healthy = torch.where(active, step_healthy, healthy)
                active = active & step_changed & step_healthy
                queued += 1
            sweeps, still, chg, ok = read_flags(count, active, changed,
                                                healthy)
            if not still or queued >= max_sweeps:
                self.convergence = self._report(sweeps, bool(chg), bool(ok),
                                                max_sweeps)
                return finish(carry)

    def _sharded_resident(self, state):
        """The sharded resident carry (DESIGN.md §10): ``state`` split into
        padded per-shard pieces, shard ``i``'s on its mesh device
        (``row_sharding``), the step of
        :func:`engine.make_sharded_fixpoint_step` (all-gather, local sweep,
        verdicts summed on shard 0's device), the ``torch.where`` that
        keeps a stopped run's pieces, and the reassembly of the full state
        on ``state``'s device.  Pad rows are constant zeros, so the initial
        health check over the pieces equals the full-state check."""
        step = self._shard_step
        widths, devices = step.widths, step.devices
        pieces = eng.pad_rows(state, widths, step.padded_width, devices)
        reduce = self.plan.seed.reduce
        healthy = torch.stack([eng.state_healthy(p, reduce).to(devices[0])
                               for p in pieces]).all()

        def keep(active, new, old):
            return [torch.where(active.to(o.device), n, o)
                    for n, o in zip(new, old)]

        def finish(carry):
            return eng.unpad_rows(carry, widths, state.device)
        return pieces, healthy, step, keep, finish

    def _converge_host(self, state, max_sweeps):
        """One sweep, one read of its flags, per iteration.  An already
        unhealthy initial state never enters the loop, as in the resident
        driver, whose state stays frozen from the start."""
        reduce = self.plan.seed.reduce
        if not read_flags(eng.state_healthy(state, reduce))[0]:
            self.convergence = self._report(0, True, False, max_sweeps)
            return state
        for count in range(1, max_sweeps + 1):
            new = self.sweep(state)
            healthy, changed = read_flags(eng.state_healthy(new, reduce),
                                          (new != state).any())
            if not healthy or not changed:
                self.convergence = self._report(count, bool(changed),
                                                bool(healthy), max_sweeps)
                return new
            state = new
        self.convergence = self._report(max_sweeps, True, True, max_sweeps)
        return state

    def _start(self, sources, fill, start, dtype) -> torch.Tensor:
        """(num_nodes, S) initial states: ``fill`` everywhere, ``start`` at
        ``sources[i]`` in column ``i``."""
        sources = torch.as_tensor(np.asarray(sources), device=self.device)
        state = torch.full((self.num_nodes, sources.shape[0]), fill,
                           dtype=dtype, device=self.device)
        state[sources.long(), torch.arange(sources.shape[0],
                                           device=self.device)] = start
        return state

    def _run_one(self, source, fill, start, dtype, max_sweeps):
        state = self._start([source], fill, start, dtype)[:, 0]
        return self._converge(state.contiguous(), max_sweeps)

    def _run_many(self, sources, fill, start, dtype, max_sweeps, bucket):
        """Converge S sources at once as a (num_nodes, S) state; returns
        (S, num_nodes), S padded up :data:`BATCH_BUCKETS` on the way when
        ``bucket``."""
        sources = np.asarray(sources)
        n = sources.shape[0]
        if bucket:
            sources, n = pad_to_bucket(sources)
        state = self._converge(self._start(sources, fill, start, dtype),
                               max_sweeps, batched=True)
        return state.T[:n].contiguous()


def _levels(lv: torch.Tensor) -> torch.Tensor:
    return torch.where(lv >= int(UNREACHED), -1, lv)


@dataclasses.dataclass
class BFS(_FixpointApp):
    """Breadth-first levels via min-reduce relaxation over int32.

    Unit-weight Bellman-Ford: each sweep relaxes every edge at once, so
    after ``k`` sweeps all nodes within ``k`` hops hold exact levels;
    convergence takes eccentricity+1 sweeps.  Levels are int32 on the
    app's device, -1 where unreachable."""

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray, num_nodes: int,
                   lane_width: int = 128, backend: str = "torch",
                   cost: CostModel | None = None, fused: bool = True,
                   stage_b: str = "auto", plan_cache_dir: str | None = None,
                   tune: bool = False, tune_cache_dir: str | None = None,
                   driver: str = "resident", validate: str = "strict",
                   mesh=None, shards: int | None = None,
                   device="cuda") -> "BFS":
        """Build the plan and the sweep program on ``device`` (default
        ``"cuda"``, which raises when no CUDA device exists).  ``backend``
        is ``"torch"`` (plain torch ops), ``"segsum"`` (one segment
        reduce), ``"cuda"`` (the stage-A kernels) or ``"auto"`` (measured
        per graph, the choice cached in ``tune_cache_dir``); ``driver`` is
        ``"resident"`` or ``"host"``; ``validate`` is the ingestion policy
        (DESIGN.md §9); ``plan_cache_dir`` holds content-addressed
        plans.  ``mesh=`` (a :class:`~repro_torch.launch.mesh.ShardMesh`,
        simulated or not) or ``shards=k`` (``k`` devices of ``device``'s
        type) shard the sweep (module docstring); neither goes with the
        tuner, nor with ``backend="cuda"``."""
        dev = eng.resolve_device(device)
        with _trace.span("app.bfs.build", backend=backend,
                         num_nodes=num_nodes):
            src, dst, _, vreport = validation.validate_edges(
                src, dst, num_nodes, policy=validate)

            def example():
                lv = torch.full((num_nodes,), int(UNREACHED),
                                dtype=torch.int32, device=dev)
                lv[0] = 0
                return lv
            return cls._build_app(
                bfs_seed(), {"dst": np.asarray(dst), "src": np.asarray(src)},
                {}, "level", num_nodes, vreport, lane_width=lane_width,
                backend=backend, cost=cost, fused=fused, stage_b=stage_b,
                driver=driver, device=dev, plan_cache_dir=plan_cache_dir,
                tune=tune, tune_cache_dir=tune_cache_dir,
                state_example=example, mesh=mesh, shards=shards)

    def run(self, source: int, max_sweeps: int | None = None
            ) -> torch.Tensor:
        """(num_nodes,) int32 levels from ``source``; -1 where
        unreachable."""
        return _levels(self._run_one(source, int(UNREACHED), 0,
                                     torch.int32, max_sweeps))

    def run_multi(self, sources, max_sweeps: int | None = None,
                  bucket: bool = True) -> torch.Tensor:
        """Batched multi-source BFS: ONE sweep program over the S sources
        at once, their levels the trailing lane axis of a (num_nodes, S)
        state (where the reference vmaps the 1-D sweep); convergence is
        equality over the whole batch.  Row ``i`` of the (S, num_nodes)
        result is bitwise ``run(sources[i])``.  ``bucket=True`` pads S up
        :data:`BATCH_BUCKETS` (replicating the last source) and slices the
        result back."""
        return _levels(self._run_many(sources, int(UNREACHED), 0,
                                      torch.int32, max_sweeps, bucket))


@dataclasses.dataclass
class SSSP(_FixpointApp):
    """Single-source shortest paths (Bellman-Ford, (min, +) semiring).

    float32 distances (weights are cast to float32 at build time); ``inf``
    marks unreachable nodes.  Edge weights ride the seed's *elementwise*
    slot, reordered once into exec order on the device.

    Negative weights are legal; a *reachable negative cycle* is detected,
    not looped on: a run that exhausts the default ``num_nodes + 1`` bound
    on a healthy state reports ``convergence.negative_cycle=True``, and the
    distances are then cycle-tainted lower bounds."""

    _detects_negative_cycle = True

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray,
                   weight: np.ndarray, num_nodes: int,
                   lane_width: int = 128, backend: str = "torch",
                   cost: CostModel | None = None, fused: bool = True,
                   stage_b: str = "auto", plan_cache_dir: str | None = None,
                   tune: bool = False, tune_cache_dir: str | None = None,
                   driver: str = "resident", validate: str = "strict",
                   mesh=None, shards: int | None = None,
                   device="cuda") -> "SSSP":
        """As :meth:`BFS.from_edges`; ``weight`` is cast to float32."""
        dev = eng.resolve_device(device)
        with _trace.span("app.sssp.build", backend=backend,
                         num_nodes=num_nodes):
            src, dst, weight, vreport = validation.validate_edges(
                src, dst, num_nodes, weight=weight, policy=validate)

            def example():
                d0 = torch.full((num_nodes,), float("inf"),
                                dtype=torch.float32, device=dev)
                d0[0] = 0.0
                return d0
            return cls._build_app(
                sssp_seed(), {"dst": np.asarray(dst), "src": np.asarray(src)},
                {"weight": np.asarray(weight, np.float32)}, "dist",
                num_nodes, vreport, lane_width=lane_width, backend=backend,
                cost=cost, fused=fused, stage_b=stage_b, driver=driver,
                device=dev, plan_cache_dir=plan_cache_dir, tune=tune,
                tune_cache_dir=tune_cache_dir, state_example=example,
                mesh=mesh, shards=shards)

    def run(self, source: int, max_sweeps: int | None = None
            ) -> torch.Tensor:
        """(num_nodes,) float32 distances from ``source``."""
        return self._run_one(source, float("inf"), 0.0, torch.float32,
                             max_sweeps)

    def run_multi(self, sources, max_sweeps: int | None = None,
                  bucket: bool = True) -> torch.Tensor:
        """Batched multi-source Bellman-Ford, as :meth:`BFS.run_multi`:
        (S, num_nodes) float32 distances, row ``i`` bitwise
        ``run(sources[i])``."""
        return self._run_many(sources, float("inf"), 0.0, torch.float32,
                              max_sweeps, bucket)


@dataclasses.dataclass
class ConnectedComponents(_FixpointApp):
    """Connected components by min-label propagation (int32 labels).

    The edge list is symmetrized at plan-build time (connectivity is
    undirected); every node starts labeled with its own id and converges to
    the minimum node id of its component."""

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray, num_nodes: int,
                   lane_width: int = 128, backend: str = "torch",
                   cost: CostModel | None = None, fused: bool = True,
                   stage_b: str = "auto", plan_cache_dir: str | None = None,
                   tune: bool = False, tune_cache_dir: str | None = None,
                   driver: str = "resident", validate: str = "strict",
                   mesh=None, shards: int | None = None,
                   device="cuda") -> "ConnectedComponents":
        """As :meth:`BFS.from_edges`, over the symmetrized edges."""
        dev = eng.resolve_device(device)
        with _trace.span("app.cc.build", backend=backend,
                         num_nodes=num_nodes):
            src, dst, _, vreport = validation.validate_edges(
                src, dst, num_nodes, policy=validate)
            s = np.concatenate([np.asarray(src), np.asarray(dst)])
            d = np.concatenate([np.asarray(dst), np.asarray(src)])
            return cls._build_app(
                cc_seed(), {"dst": d, "src": s}, {}, "label", num_nodes,
                vreport, lane_width=lane_width, backend=backend, cost=cost,
                fused=fused, stage_b=stage_b, driver=driver, device=dev,
                plan_cache_dir=plan_cache_dir, tune=tune,
                tune_cache_dir=tune_cache_dir,
                state_example=lambda: torch.arange(
                    num_nodes, dtype=torch.int32, device=dev),
                mesh=mesh, shards=shards)

    def run(self, max_sweeps: int | None = None) -> torch.Tensor:
        """(num_nodes,) int32 labels: ``label[v]`` = min node id in v's
        component."""
        state = torch.arange(self.num_nodes, dtype=torch.int32,
                             device=self.device)
        return self._converge(state, max_sweeps)


# --------------------------------------------------------------- oracles
# Plain-numpy references, independent of the engine.

def bfs_reference(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                  source: int) -> np.ndarray:
    """Frontier BFS; int32 levels, -1 where unreachable."""
    level = np.full(num_nodes, -1, np.int32)
    level[source] = 0
    frontier = np.asarray([source])
    d = 0
    src = np.asarray(src)
    dst = np.asarray(dst)
    while frontier.size:
        on_front = np.isin(src, frontier)
        nxt = np.unique(dst[on_front])
        nxt = nxt[level[nxt] == -1]
        d += 1
        level[nxt] = d
        frontier = nxt
    return level


def sssp_reference(src: np.ndarray, dst: np.ndarray, weight: np.ndarray,
                   num_nodes: int, source: int) -> np.ndarray:
    """Synchronous Bellman-Ford in float64; inf where unreachable."""
    dist = np.full(num_nodes, np.inf)
    dist[source] = 0.0
    src = np.asarray(src)
    dst = np.asarray(dst)
    w = np.asarray(weight, np.float64)
    for _ in range(num_nodes + 1):
        new = dist.copy()
        np.minimum.at(new, dst, dist[src] + w)
        if np.array_equal(new, dist):
            break
        dist = new
    return dist


def cc_reference(src: np.ndarray, dst: np.ndarray, num_nodes: int
                 ) -> np.ndarray:
    """Union-find; labels are the min node id per component."""
    parent = np.arange(num_nodes)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b in zip(np.asarray(src).tolist(), np.asarray(dst).tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    return np.asarray([find(v) for v in range(num_nodes)], np.int32)
