"""Measurement-driven variant search (the tuner's ground truth).

A port of the JAX package's ``tune/search.py``: the same paired
same-round measurement discipline, oracle check and live-reference
re-measure.  A timed round waits for the candidate's device
(``torch.cuda.synchronize`` on the card) where the reference blocks on
the JAX arrays.

The cost model (:mod:`repro_torch.tune.cost`) only *prunes*; the winner is
picked by timing real executors on the real device with the real plan.
The harness keeps the tuning bill small by construction:

* candidates that share a :attr:`Candidate.plan_key` share ONE plan build
  and ONE Data Transfer reorder (``engine.reorder_static``) — the plan is
  the expensive analysis, the candidates on top of it are cheap,
* plan builds go through the content-addressed plan cache when a
  ``plan_cache_dir`` is given, so even a cold *tuning* run reuses warm
  *plans*,
* the analytical top-K cut bounds the number of compile+measure cycles,
* a warm tuning cache (:mod:`repro_torch.tune.cache`) skips the measurement
  phase entirely — ``measurement_count()`` lets tests and benchmarks
  assert exactly that, mirroring ``graphs.plan_build_count()``.

Every measured candidate's warmup output is checked against the
reference-oracle output before its timing can compete: a variant that
cannot reproduce the semantics (however fast) is rejected with a
warning, never chosen.

A candidate that raises is disqualified with a warning, as in the
reference, with one exception: on the card (platform ``"cuda"``) a
``cuda`` candidate's exception is its kernel's fault and is raised as a
:class:`KernelCandidateError`, since disqualifying it would let a plain
torch form run in the kernel's place.
"""
from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.core import ir
from repro_torch.core.seed import CodeSeed, reference_execute
from repro_torch.launch.mesh import make_shard_mesh
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.tune import cache as tcache
from repro_torch.tune import cost as tcost
from repro_torch.tune import space as tspace
from repro_torch.tune.space import Candidate


class KernelCandidateError(RuntimeError):
    """A ``cuda`` candidate raised on the card while it was built,
    checked, timed or replayed from the tuning cache."""


def _kernel_fault(cand: Candidate, platform: str) -> bool:
    """True where ``cand``'s exception must be raised, not disqualify it:
    a ``cuda`` candidate on the card.  Off the card the kernels' wrappers
    run their plain versions by design, and a failure disqualifies."""
    return platform == "cuda" and cand.backend == "cuda"


def measurement_count() -> int:
    """Total timed candidate measurements made by this module — a warm
    tuning-cache hit must leave this counter unchanged.  Backed by the
    process-wide ``tune.measurements`` counter in
    :mod:`repro_torch.obs.metrics`
    (this function is the stable re-export)."""
    return int(_metrics.value("tune.measurements"))


@dataclasses.dataclass(frozen=True)
class Measurement:
    candidate: Candidate
    us_per_call: float
    predicted_us: float
    ok: bool                  # matched the oracle output
    error: str | None = None  # raised during build/warmup/measurement

    def to_dict(self) -> dict:
        d = {"candidate": self.candidate.to_dict(),
             "us_per_call": round(self.us_per_call, 2)
             if np.isfinite(self.us_per_call) else None,
             "predicted_us": round(self.predicted_us, 2),
             "ok": self.ok}
        if self.error is not None:
            d["error"] = self.error
        return d


@dataclasses.dataclass
class TuningResult:
    best: Candidate
    best_us: float | None          # None on a warm cache hit
    measurements: list             # [] on a warm cache hit
    cache_hit: bool
    key: str | None                # tuning-cache key (None when uncached)
    platform: str
    features: dict                 # plan_key -> PlanFeatures (measured run)
    plans_built: int = 1           # distinct plans constructed while tuning
    # how the winner was chosen: "measurement" (the normal path),
    # "cache" (warm replay), or "cost_model" (DEGRADED: the measurement
    # harness failed outright and the analytical ranking picked instead —
    # a DegradationEvent records why; the pick is never cached)
    picked_by: str = "measurement"

    @property
    def num_measured(self) -> int:
        return len(self.measurements)

    def choice_dict(self) -> dict:
        return self.best.to_dict()


def _build_plan(seed, access, out_len, data_len, cand: Candidate,
                plan_cache_dir):
    from repro_torch.core import planio
    return planio.cached_build_plan(seed, access, out_len, data_len,
                                    cost=cand.cost_model(),
                                    cache_dir=plan_cache_dir)


def _default_exec_factory(plan, cand: Candidate, static_data, elem_exec,
                          device="cuda", simulate_mesh: bool = False):
    if cand.shards > 1:
        # sharded candidates keep the full-array call contract, so the
        # oracle check and the paired measurement treat them like any
        # other executor; elem_exec is parent-plan-ordered and cannot
        # seed the shard plans (each shard re-reorders the full static
        # arrays through its own sliced flat_perm)
        tree = ir.lower(plan, backend=cand.backend, fused=cand.fused,
                        stage_b=cand.stage_b, coalesce=cand.coalesce)
        parts = ir.partition_plan(tree, cand.shards)
        return eng.make_sharded_executor(
            parts, static_data,
            make_shard_mesh(cand.shards, device, simulate_mesh))
    return eng.make_executor(plan, static_data, backend=cand.backend,
                             fused=cand.fused, stage_b=cand.stage_b,
                             elem_exec=elem_exec, coalesce=cand.coalesce,
                             kernel_params=cand.kernel_params,
                             device=device)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _outputs_match(got, want) -> bool:
    got = _host(got)
    want = _host(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if np.issubdtype(got.dtype, np.inexact):
        return bool(np.allclose(got, want, rtol=1e-4, atol=1e-5))
    return bool(np.array_equal(got, want))


def _reference_oracle(seed, access, static_data, mutable_example,
                      out_init):
    """The seed's scatter oracle on the example inputs.  A float output is
    accumulated in float64 and rounded once to its dtype, where the
    reference accumulates in the output's dtype: a float32 ``index_add``
    adds a hub row's thousands of terms one rounding at a time (in any
    order, on the card), and at the webbase-1M analogue's size that drift
    alone exceeds the tolerance every candidate is held to, so every
    candidate was rejected against it."""
    data = dict(static_data)
    data.update(mutable_example)
    if not out_init.is_floating_point():
        return reference_execute(seed, access, data, out_init)
    wide = {}
    for k, v in data.items():
        t = torch.as_tensor(v, device=out_init.device)
        wide[k] = t.double() if t.is_floating_point() else t
    return reference_execute(seed, access, wide,
                             out_init.double()).to(out_init.dtype)


def _block_until_ready(out):
    """Wait for the device that ``out`` lives on (a no-op off the card)."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)
    return out


def _timed_round(run, mutable, out_init, iters: int) -> float:
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run(mutable, out_init)
    _block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e6


def measure_paired(runs: list, mutable, out_init, warmup: int = 1,
                   iters: int = 5, rounds: int = 12,
                   ref_index: int = 0) -> list[float]:
    """Steady-state microseconds per call for a list of executors — the
    one measurement discipline shared by the tuner and the benchmark
    harness (``benchmarks.paper_tables``), so their numbers stay
    comparable.

    All executors are warmed first, then timed in many SHORT rounds with
    RANDOM within-round order (a deterministic rotation's short period
    can alias with periodic system noise like timer ticks and couple
    specific executors to the noisy slots).  The reported number is a
    PAIRED estimate: each executor's per-round ratio against
    ``runs[ref_index]``'s sample *from the same round*, median over
    rounds, scaled by the reference's min round.  Under the heavy
    scheduler drift of a shared machine, absolute per-executor minima
    were observed to disperse 30%+ between *identical* programs (flipping
    near-tie selections); paired same-round ratios cancel the drift
    because both sides of every ratio ran within milliseconds of each
    other.  The sample size adapts to ~1 ms of work per timed sample so
    fast calls (tens of us) are not dominated by per-sample jitter."""
    for run in runs:
        for _ in range(max(warmup, 1)):
            _block_until_ready(run(mutable, out_init))
    n = len(runs)
    samples = [[] for _ in range(n)]
    t1 = min(_timed_round(runs[ref_index], mutable, out_init, 3)
             for _ in range(5))
    iters = int(min(max(iters, 1000.0 / max(t1, 1.0)), 64))
    shuf = np.random.default_rng(12345)
    for r in range(max(rounds, 1)):
        for j in shuf.permutation(n):
            samples[j].append(_timed_round(runs[j], mutable, out_init,
                                           iters))
    ref = np.asarray(samples[ref_index])
    t_ref = float(ref.min())
    return [t_ref * float(np.median(np.asarray(s) / ref)) for s in samples]


def _measure_all(runs: list, mutable, out_init, warmup: int, iters: int,
                 rounds: int = 12) -> list[float]:
    """:func:`measure_paired` plus the measurement accounting the warm
    tuning-cache guarantee is asserted against."""
    with _trace.span("tune.measure", candidates=len(runs), rounds=rounds):
        out = measure_paired(runs, mutable, out_init, warmup, iters,
                             rounds)
    _metrics.inc("tune.measurements", len(runs))
    return out


def _guarded(i, fn, timed_fail: dict, fault: str | None = None):
    """Wrap one candidate's timed callable: the first exception records
    ``timed_fail[i]`` and every subsequent call no-ops (returns
    ``out_init``) instead of aborting the whole paired measurement.  A
    candidate whose ``fault`` label is given (a kernel on the card) raises
    a :class:`KernelCandidateError` instead."""
    def call(mutable, oi):
        if i in timed_fail:
            return oi
        try:
            return fn(mutable, oi)
        except Exception as e:          # noqa: BLE001 - fault boundary
            if fault is not None:
                raise KernelCandidateError(
                    f"tuning candidate {fault} raised on the card during "
                    f"measurement ({e!r})") from e
            timed_fail[i] = e
            return oi
    return call


def _paired_times_live_ref(timed: list, timed_fail: dict, labels: list,
                           mutable, out_init, warmup: int,
                           iters: int) -> list[float]:
    """Paired measurement that survives a failing REFERENCE candidate.

    :func:`measure_paired` scales every candidate's time by
    ``runs[0]``'s (the reference's) rounds.  If the reference fails
    mid-measurement, its guarded rounds collapse to near-instant no-ops,
    so ``t_ref`` tends toward timer noise and every reported
    ``us_per_call`` is garbage — the tuner could pick a slower winner
    and cache a bogus ``best_us``.  Whenever the round's reference ends
    up in ``timed_fail``, the whole estimate is discarded and the
    surviving candidates are re-measured with a live reference (failed
    candidates stay ``inf``); repeats until a reference survives or no
    candidate is left."""
    idx = list(range(len(timed)))
    times = [float("inf")] * len(timed)
    while idx:
        sub = _measure_all([timed[i] for i in idx], mutable, out_init,
                           warmup, iters)
        if idx[0] not in timed_fail:
            for i, us in zip(idx, sub):
                times[i] = us
            return times
        from repro_torch.core import validate as vmod
        vmod.record_degradation(
            "tune", "measurement_failed",
            f"reference candidate {labels[idx[0]]} failed "
            "mid-measurement; paired estimate discarded",
            "re-measured survivors against a live reference")
        warnings.warn(
            f"tuning reference candidate {labels[idx[0]]} failed during "
            "measurement; re-measuring the surviving candidates",
            RuntimeWarning)
        idx = [i for i in idx if i not in timed_fail]
    # every candidate failed: all-inf times make the caller's viable set
    # empty, which raises the canonical "every candidate failed" error
    return times


def autotune(seed: CodeSeed, access: dict, out_len: int, data_len: int,
             static_data: dict, mutable_example: dict, out_init,
             *, space: list | None = None,
             lane_widths: tuple | None = None,
             shard_counts: tuple | None = None,
             top_k: int = 4, warmup: int = 1, iters: int = 5,
             tune_cache_dir: str | None = None,
             plan_cache_dir: str | None = None, force: bool = False,
             exec_factory=None, oracle="reference",
             measure_wrap=None, cache_extra: str = "", device=None,
             simulate_mesh: bool = False):
    """Pick the best execution variant for this input; return
    ``(plan, run, TuningResult)`` where ``run(mutable, out_init)`` is the
    tuned executor on ``device`` (default: ``out_init``'s device, whose
    platform — ``"cpu"`` or ``"cuda"`` — also selects the space).

    ``mutable_example`` / ``out_init`` are representative inputs used for
    the timed calls (and the oracle check).  ``oracle="reference"``
    derives the expected output from the seed's scatter oracle;
    pass an explicit array for custom executors, or ``None`` to skip the
    check.  ``force=True`` ignores (but still refreshes) the tuning
    cache.  ``shard_counts`` widens the default space with a row-shard
    axis (DESIGN.md §10), capped at the visible device count; a sharded
    candidate's executor builds its own mesh of ``device``'s type, or,
    with ``simulate_mesh=True``, places every shard on ``device`` (the
    cap is then the largest shard count, and the tuning-cache key says
    the mesh was simulated).  Every shard count in the space reaches the
    measurement.

    ``measure_wrap(run) -> timed_callable`` changes what gets TIMED
    without changing what gets RETURNED or oracle-checked: the fixpoint
    apps pass a wrapper that embeds each candidate's sweep body in a
    device-resident loop, so the measurement matches how the winning
    executor will actually be driven (DESIGN.md §7).  ``cache_extra``
    must then name the measurement discipline — it is folded into the
    tuning-cache key so a per-sweep choice is never replayed as a
    per-run choice (or vice versa).

    A candidate that raises is disqualified, with a ``RuntimeWarning``
    and a recorded degradation, as in the reference, except a ``cuda``
    candidate on the card: its exception during build, oracle check,
    timing or cache replay raises :class:`KernelCandidateError`.  On the
    card a measurement-harness failure is raised too, not replaced by the
    cost model's pick: a kernel's fault can surface at the next
    synchronize, outside its own candidate's guard.  An oracle mismatch
    only rejects the candidate, with a warning.
    """
    with _trace.span("tune.autotune", seed=seed.name) as sp:
        plan, run, result = _autotune_impl(
            seed, access, out_len, data_len, static_data, mutable_example,
            out_init, space=space,
            lane_widths=lane_widths, shard_counts=shard_counts,
            top_k=top_k, warmup=warmup, iters=iters,
            tune_cache_dir=tune_cache_dir, plan_cache_dir=plan_cache_dir,
            force=force,
            exec_factory=exec_factory, oracle=oracle,
            measure_wrap=measure_wrap, cache_extra=cache_extra,
            device=device, simulate_mesh=simulate_mesh)
        sp.set(picked_by=result.picked_by, cache_hit=result.cache_hit,
               measured=result.num_measured,
               plans_built=result.plans_built, best=result.best.label)
        return plan, run, result


def _autotune_impl(seed: CodeSeed, access: dict, out_len: int,
                   data_len: int, static_data: dict, mutable_example: dict,
                   out_init, *, space, lane_widths, shard_counts,
                   top_k, warmup, iters, tune_cache_dir, plan_cache_dir,
                   force, exec_factory, oracle,
                   measure_wrap, cache_extra, device, simulate_mesh):
    dev = eng.resolve_device(out_init.device if device is None else device)
    platform = tspace.platform_of(dev)
    shard_counts = shard_counts if shard_counts else (1,)
    if space is None:
        space = tspace.candidate_space(
            seed, platform=platform,
            lane_widths=lane_widths if lane_widths else (128,),
            shard_counts=shard_counts,
            devices=max(shard_counts) if simulate_mesh else None)
    if not space:
        raise ValueError("empty candidate space")
    if simulate_mesh and any(c.shards > 1 for c in space):
        cache_extra += "|mesh=simulated"
    if exec_factory is None:
        def exec_factory(plan, cand, static_data, elem_exec):
            return _default_exec_factory(plan, cand, static_data, elem_exec,
                                         device=dev,
                                         simulate_mesh=simulate_mesh)
    sig = tspace.space_signature(space)

    from repro_torch.core import validate as vmod

    key = None
    if tune_cache_dir is not None:
        key = tcache.tuning_key(seed.name, seed.reduce, access, out_len,
                                data_len, platform, sig, extra=cache_extra,
                                device=dev if platform == "cuda" else None)
        if not force:
            entry = tcache.load_entry(tune_cache_dir, key)
            if entry is not None:
                try:
                    with _trace.span("tune.cache_replay", key=key):
                        best = Candidate.from_dict(entry["choice"])
                        plan = _build_plan(seed, access, out_len, data_len,
                                           best, plan_cache_dir)
                        elem_exec = eng.reorder_static(plan, static_data,
                                                       dev)
                        run = exec_factory(plan, best, static_data,
                                           elem_exec)
                    return plan, run, TuningResult(
                        best=best, best_us=None, measurements=[],
                        cache_hit=True, key=key, platform=platform,
                        features={}, plans_built=1, picked_by="cache")
                except Exception as e:
                    if _kernel_fault(best, platform):
                        raise KernelCandidateError(
                            f"cached tuning choice {best.label} raised on "
                            f"the card ({e!r})") from e
                    # a cached choice that no longer builds (backend
                    # gone, changed toolchain) costs a re-tune, not a run
                    vmod.record_degradation(
                        "tune_cache", "replay_failed",
                        f"{entry.get('choice')}: {e!r}", "full re-tune")
                    warnings.warn(
                        f"cached tuning choice failed to build ({e!r}); "
                        "re-tuning from scratch", RuntimeWarning)

    # ---- one plan (and one Data Transfer) per distinct plan key; a plan
    # key whose build raises disqualifies its candidates, not the tune
    plans, elems, features, plan_errors = {}, {}, {}, {}
    with _trace.span("tune.plan_builds",
                     candidates=len(space)) as sp_plans:
        for c in space:
            if c.plan_key in plans or c.plan_key in plan_errors:
                continue
            try:
                plan = _build_plan(seed, access, out_len, data_len, c,
                                   plan_cache_dir)
                plans[c.plan_key] = plan
                elems[c.plan_key] = eng.reorder_static(plan, static_data,
                                                       dev)
                features[c.plan_key] = tcost.plan_features(plan)
            except Exception as e:
                plan_errors[c.plan_key] = e
                vmod.record_degradation(
                    "tune", "candidate_failed",
                    f"plan build for {c.plan_key}: {e!r}",
                    "candidates on this plan disqualified")
                warnings.warn(f"tuning plan build for {c.plan_key} raised "
                              f"({e!r}); its candidates are disqualified",
                              RuntimeWarning)
        sp_plans.set(plans_built=len(plans), failed=len(plan_errors))
    if not plans:
        raise RuntimeError(
            "autotune: every plan build failed "
            f"({ {k: repr(v) for k, v in plan_errors.items()} })")
    space = [c for c in space if c.plan_key in plans]

    with _trace.span("tune.rank", candidates=len(space),
                     top_k=top_k) as sp_rank:
        ranked = tcost.rank_candidates(space, features, platform,
                                       top_k=top_k)
        # every shard count in the space must reach the measurement phase:
        # the caller opened that axis explicitly, and the cost model's
        # collective constant is far too coarse to close it analytically
        missing = {c.shards for c in space} - {c.shards for c, _ in ranked}
        if missing:
            full = tcost.rank_candidates(space, features, platform,
                                         top_k=None)
            ranked += [next(t for t in full if t[0].shards == k)
                       for k in sorted(missing)]
        sp_rank.set(ranked=len(ranked))

    if oracle == "reference":
        oracle = _reference_oracle(seed, access, static_data,
                                   mutable_example, out_init)

    # build + warmup + oracle-check every ranked candidate, then time them
    # all round-robin so no candidate is charged for its slot in the loop.
    # A candidate that RAISES anywhere — executor build, warmup, or a
    # timed call — is disqualified with a DegradationEvent, except a
    # kernel on the card, whose exception is raised.
    built, runs, dead = [], {}, []
    with _trace.span("tune.build_candidates",
                     ranked=len(ranked)) as sp_build:
        for cand, predicted in ranked:
            plan = plans[cand.plan_key]
            try:
                run = exec_factory(plan, cand, static_data,
                                   elems[cand.plan_key])
                ok = True
                if oracle is not None:
                    ok = _outputs_match(run(mutable_example, out_init),
                                        oracle)
                    if not ok:
                        warnings.warn(
                            f"tuning candidate {cand.label} diverges from "
                            "the oracle output; rejected", RuntimeWarning)
            except Exception as e:
                if _kernel_fault(cand, platform):
                    raise KernelCandidateError(
                        f"tuning candidate {cand.label} raised on the card "
                        f"during build/warmup ({e!r})") from e
                vmod.record_degradation(
                    "tune", "candidate_failed", f"{cand.label}: {e!r}",
                    "candidate disqualified")
                warnings.warn(
                    f"tuning candidate {cand.label} raised during "
                    f"build/warmup ({e!r}); disqualified", RuntimeWarning)
                dead.append(Measurement(candidate=cand,
                                        us_per_call=float("inf"),
                                        predicted_us=predicted, ok=False,
                                        error=repr(e)))
                continue
            built.append((cand, predicted, ok, run))
            runs[cand] = run
        sp_build.set(built=len(built), dead=len(dead))
    if not built:
        raise RuntimeError(
            "autotune: every ranked candidate failed to build "
            f"({[m.candidate.label for m in dead]})")

    # per-candidate guard: a backend exception inside a timed round marks
    # that one candidate failed (subsequent rounds no-op for it) instead
    # of aborting the whole paired measurement
    timed_fail: dict[int, Exception] = {}
    timed = [_guarded(i, b[3] if measure_wrap is None
                      else measure_wrap(b[3]), timed_fail,
                      b[0].label if _kernel_fault(b[0], platform) else None)
             for i, b in enumerate(built)]
    labels = [b[0].label for b in built]
    picked_by = "measurement"
    try:
        times = _paired_times_live_ref(timed, timed_fail, labels,
                                       mutable_example, out_init, warmup,
                                       iters)
    except Exception as e:
        if platform == "cuda":
            raise
        # total measurement failure (broken timer, dead device queue):
        # the analytical cost model already ranked the oracle-checked
        # candidates — degrade to its pick rather than failing the build
        times = None
        picked_by = "cost_model"
        vmod.record_degradation("tune", "measurement_failed", repr(e),
                                "analytical cost-model pick")
        warnings.warn(
            f"autotune: measurement harness failed ({e!r}); falling back "
            "to the analytical cost-model ranking", RuntimeWarning)

    measurements = list(dead)
    if times is None:
        measurements += [
            Measurement(candidate=cand, us_per_call=float("inf"),
                        predicted_us=predicted, ok=ok,
                        error="measurement harness failed")
            for cand, predicted, ok, _ in built]
        viable_built = [b for b in built if b[2]]
        if not viable_built:
            raise RuntimeError(
                "autotune: measurement failed and no candidate passed "
                "the oracle check — nothing safe to fall back to")
        best, best_pred, _, _ = min(viable_built, key=lambda b: b[1])
        best_us = None
    else:
        for i, ((cand, predicted, ok, _), us) in enumerate(
                zip(built, times)):
            err = timed_fail.get(i)
            if err is not None:
                vmod.record_degradation(
                    "tune", "candidate_failed",
                    f"{cand.label} (during measurement): {err!r}",
                    "candidate disqualified")
                warnings.warn(
                    f"tuning candidate {cand.label} raised during "
                    f"measurement ({err!r}); disqualified",
                    RuntimeWarning)
                measurements.append(Measurement(
                    candidate=cand, us_per_call=float("inf"),
                    predicted_us=predicted, ok=False, error=repr(err)))
            else:
                if np.isfinite(us):
                    _metrics.observe("tune.candidate_us", float(us))
                measurements.append(Measurement(
                    candidate=cand, us_per_call=us,
                    predicted_us=predicted, ok=ok))
        viable = [m for m in measurements
                  if m.ok and np.isfinite(m.us_per_call)]
        if not viable:
            raise RuntimeError(
                "autotune: every measured candidate diverged from the "
                "oracle or failed "
                f"({[m.candidate.label for m in measurements]})")
        best_m = min(viable, key=lambda m: m.us_per_call)
        best = best_m.candidate
        best_us = best_m.us_per_call

    # a degraded (cost-model) pick is never cached: the next process
    # should measure for real, not replay a guess
    if tune_cache_dir is not None and picked_by == "measurement":
        tcache.store_entry(tune_cache_dir, key, {
            "choice": best.to_dict(),
            "best_us": round(best_us, 2),
            "platform": platform,
            "torch": torch.__version__,
            "space": sig,
            "measurements": [m.to_dict() for m in measurements],
            "features": {str(k): f.to_dict() for k, f in features.items()},
        })

    return plans[best.plan_key], runs[best], TuningResult(
        best=best, best_us=best_us, measurements=measurements,
        cache_hit=False, key=key, platform=platform, features=features,
        plans_built=len(plans), picked_by=picked_by)
