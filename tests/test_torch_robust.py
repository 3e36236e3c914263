"""Robustness-model tests of the port (DESIGN.md §9), through
``repro_torch.testing.faults``, on the CPU.

Mirrors of the sections of ``tests/test_robust.py`` that exercise code the
port has: the degradation trail's collectors, the thread scope of the
filesystem faults, the plan and tuning caches under read-only and full
disks, torn plan files and corrupt or wrong-schema tuning entries, the
tuner under a raising candidate, a dead measurement harness, a flaky
reference and timing spikes, and fixpoint health (poisoned fixpoints,
negative cycles, capped sweeps, both drivers).  The invariant throughout:
a degraded build still produces the bitwise-correct result, leaves a
structured DegradationEvent trail, and never lets an exception escape the
constructor.  For the cache and tuner faults, the reference's SpMV also
runs under the reference's injector on the same inputs: the two packages
must record the same ``(layer, kind)`` events and the same ``cache_hit``,
``picked_by`` and failed backends.
"""
import json
import os
import threading
import warnings

import numpy as np
import pytest
import torch

from repro_torch import tune as T
from repro_torch.core import validate as V
from repro_torch.core.apps import SpMV
from repro_torch.core.graphs import BFS, SSSP
from repro_torch.core.seed import spmv_seed
from repro_torch.testing import faults
from repro_torch.tune import search

pytestmark = pytest.mark.robust


def _coo(rng, m, n, nnz):
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return rows, cols, vals


def _small_spmv(**kw):
    rng = np.random.default_rng(0)
    rows, cols, vals = _coo(rng, 48, 48, 256)
    x = rng.standard_normal(48).astype(np.float32)
    A = SpMV.from_coo(rows, cols, vals, (48, 48), device="cpu", **kw)
    return A, A.matvec(torch.as_tensor(x)).numpy()


# ------------------------------------------------------- degradation trail
class TestDegradationTrail:
    def test_nested_empty_collector_pops_itself_only(self):
        # sinks are removed by identity: an inner collector that recorded
        # nothing must not pop the (equal, empty) OUTER sink
        with V.collect_degradations() as outer:
            with V.collect_degradations() as inner:
                pass
            V.record_degradation("tune", "candidate_failed", "d", "f")
        assert len(outer) == 1 and inner == []

    def test_outer_collector_survives_clean_app_builds(self):
        # every constructor opens its own (possibly empty) collector;
        # wrapping two clean builds must not corrupt the caller's sink
        with V.collect_degradations() as trail:
            _small_spmv()
            _small_spmv()
        assert trail == []

    def test_outer_collector_sees_nested_app_events(self, tmp_path):
        V.reset_warn_once()
        cache = tmp_path / "plans"
        with V.collect_degradations() as trail:
            with faults.deny_writes(cache):
                with pytest.warns(RuntimeWarning):
                    A, _ = _small_spmv(plan_cache_dir=str(cache))
        assert any(e.kind == "write_failed" for e in trail)
        assert set(A.degradations) <= set(trail)


def test_fs_faults_scoped_to_injecting_thread(tmp_path):
    # the monkeypatches are process-global; the fault must hit only the
    # thread that entered the context, or concurrent writers (a kernel
    # build, parallel runners) absorb injected faults
    root = tmp_path / "cache"
    os.makedirs(root)
    got = {}

    def other_thread():
        try:
            with open(root / "other.txt", "w") as f:
                f.write("ok")
            got["result"] = "ok"
        except OSError as e:            # pragma: no cover - failure path
            got["result"] = e

    with faults.deny_writes(root):
        with pytest.raises(OSError):
            open(root / "mine.txt", "w")
        t = threading.Thread(target=other_thread)
        t.start()
        t.join(30)
        assert not t.is_alive()
    assert got["result"] == "ok"
    assert (root / "other.txt").read_text() == "ok"


# ------------------------------------------------------- cache degradation
class TestCacheDegradation:
    def test_readonly_plan_cache_degrades_with_event(self, tmp_path):
        V.reset_warn_once()
        cache = tmp_path / "plans"
        _, y_ref = _small_spmv()                 # no cache: reference
        with faults.deny_writes(cache):
            with pytest.warns(RuntimeWarning, match="plan cache dir"):
                A, y = _small_spmv(plan_cache_dir=str(cache))
        assert np.array_equal(y, y_ref)          # bitwise-equal output
        kinds = {(e.layer, e.kind) for e in A.degradations}
        assert ("plan_cache", "write_failed") in kinds
        assert not os.path.exists(cache)         # nothing was persisted

    def test_readonly_warns_once_per_dir(self, tmp_path):
        V.reset_warn_once()
        cache = tmp_path / "plans"
        with faults.deny_writes(cache):
            with pytest.warns(RuntimeWarning):
                _small_spmv(plan_cache_dir=str(cache))
            with warnings.catch_warnings():      # second build: silent
                warnings.simplefilter("error")
                A, _ = _small_spmv(plan_cache_dir=str(cache))
        # ... but the DegradationEvent trail is still recorded
        assert any(e.kind == "write_failed" for e in A.degradations)

    def test_disk_full_tune_cache_degrades(self, tmp_path):
        V.reset_warn_once()
        cache = tmp_path / "tune"
        os.makedirs(cache)
        with faults.disk_full(cache):
            with pytest.warns(RuntimeWarning, match="tuning cache dir"):
                A, y = _small_spmv(backend="auto",
                                   tune_cache_dir=str(cache))
        assert A.tuning is not None and not A.tuning.cache_hit
        kinds = {(e.layer, e.kind) for e in A.degradations}
        assert ("tune_cache", "write_failed") in kinds
        assert list(cache.iterdir()) == []       # no entry, no leftover tmp

    def test_torn_plan_cache_entry_rebuilds(self, tmp_path):
        V.reset_warn_once()
        cache = tmp_path / "plans"
        with faults.torn_writes(cache):
            _, y1 = _small_spmv(plan_cache_dir=str(cache))
        files = list(cache.glob("*.plan"))
        assert len(files) == 1                   # torn entry was published
        with pytest.warns(RuntimeWarning, match="unreadable"):
            A, y2 = _small_spmv(plan_cache_dir=str(cache))
        assert np.array_equal(y1, y2)
        assert any(e.layer == "plan_cache" and e.kind == "corrupt_entry"
                   for e in A.degradations)
        # the rebuild republished a GOOD entry: third build is silent
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            _small_spmv(plan_cache_dir=str(cache))

    def test_corrupt_tune_cache_entry_retunes(self, tmp_path):
        cache = tmp_path / "tune"
        A, y1 = _small_spmv(backend="auto", tune_cache_dir=str(cache))
        entries = list(cache.glob("tune-*.json"))
        assert len(entries) == 1
        entries[0].write_text("{not json")
        with pytest.warns(RuntimeWarning, match="unreadable"):
            B, y2 = _small_spmv(backend="auto", tune_cache_dir=str(cache))
        assert np.array_equal(y1, y2)
        assert not B.tuning.cache_hit            # re-tuned for real
        assert any(e.layer == "tune_cache" and e.kind == "corrupt_entry"
                   for e in B.degradations)
        # and republished: a third build is a clean cache hit
        C, _ = _small_spmv(backend="auto", tune_cache_dir=str(cache))
        assert C.tuning.cache_hit

    def test_wrong_schema_tune_entry_retunes(self, tmp_path):
        cache = tmp_path / "tune"
        A, _ = _small_spmv(backend="auto", tune_cache_dir=str(cache))
        entry = list(cache.glob("tune-*.json"))[0]
        entry.write_text(json.dumps({"schema": "tune.v999"}))
        with pytest.warns(RuntimeWarning):
            B, _ = _small_spmv(backend="auto", tune_cache_dir=str(cache))
        assert not B.tuning.cache_hit


# -------------------------------------------------------- tuner degradation
class TestTunerDegradation:
    def test_raising_candidate_disqualified(self):
        with faults.backend_failure("segsum"):
            with pytest.warns(RuntimeWarning, match="disqualified"):
                A, y = _small_spmv(backend="auto")
        assert A.tuning.best.backend != "segsum"
        failed = [m for m in A.tuning.measurements if m.error is not None]
        assert failed and all(m.candidate.backend == "segsum"
                              for m in failed)
        assert any(e.layer == "tune" and e.kind == "candidate_failed"
                   for e in A.degradations)
        _, y_ref = _small_spmv()                 # plain build agrees
        np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-5)

    def test_measurement_failure_falls_back_to_cost_model(self, tmp_path):
        cache = tmp_path / "tune"
        with faults.measurement_failure():
            with pytest.warns(RuntimeWarning, match="cost-model"):
                A, y = _small_spmv(backend="auto",
                                   tune_cache_dir=str(cache))
        assert A.tuning.picked_by == "cost_model"
        assert A.tuning.best_us is None
        assert any(e.kind == "measurement_failed"
                   for e in A.degradations)
        # a degraded pick is never cached: next process measures for real
        assert list(cache.glob("tune-*.json")) == []
        _, y_ref = _small_spmv()
        np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-5)

    def test_reference_failure_remeasures_with_live_ref(self):
        # measure_paired scales every time by the REFERENCE's rounds; a
        # reference that fails mid-measurement collapses t_ref to noise
        # and poisons every estimate — the harness must discard the
        # paired estimate and re-measure the survivors
        oi = torch.zeros(4)

        def good(mutable, o):
            return o

        def bad(mutable, o):
            raise RuntimeError("injected flaky reference")

        timed_fail = {}
        timed = [search._guarded(0, bad, timed_fail),
                 search._guarded(1, good, timed_fail),
                 search._guarded(2, good, timed_fail)]
        with V.collect_degradations() as trail:
            with pytest.warns(RuntimeWarning, match="re-measuring"):
                times = search._paired_times_live_ref(
                    timed, timed_fail, ["ref", "a", "b"], {}, oi, 1, 2)
        assert list(timed_fail) == [0]
        assert times[0] == float("inf")
        assert np.isfinite(times[1]) and np.isfinite(times[2])
        assert any(e.kind == "measurement_failed"
                   and "live reference" in e.fallback for e in trail)

        # every candidate failing leaves all-inf times (the caller then
        # raises its canonical every-candidate-failed error)
        timed_fail = {}
        timed = [search._guarded(i, bad, timed_fail) for i in range(2)]
        with pytest.warns(RuntimeWarning, match="re-measuring"):
            times = search._paired_times_live_ref(
                timed, timed_fail, ["x", "y"], {}, oi, 1, 2)
        assert times == [float("inf")] * 2

    def test_flaky_reference_candidate_end_to_end(self):
        rng = np.random.default_rng(3)
        rows, cols, vals = _coo(rng, 48, 48, 256)
        x = torch.as_tensor(rng.standard_normal(48).astype(np.float32))
        state = {"n": 0}

        def wrap(run):
            # measure_wrap is applied in ranked order, so the first
            # wrapped candidate is exactly the paired reference
            i = state["n"]
            state["n"] += 1
            if i == 0:
                def flaky(mutable, oi):
                    raise RuntimeError("injected flaky device queue")
                return flaky
            return run

        with pytest.warns(RuntimeWarning, match="re-measuring"):
            _, _, result = T.autotune(
                spmv_seed(), {"row": rows, "col": cols}, 48, 48,
                {"value": vals}, {"x": x}, torch.zeros(48),
                iters=2, measure_wrap=wrap, cache_extra="test:flaky-ref")
        assert result.picked_by == "measurement"
        assert np.isfinite(result.best_us)
        errs = [m for m in result.measurements if m.error is not None]
        assert len(errs) == 1
        assert result.best != errs[0].candidate
        assert all(np.isfinite(m.us_per_call) for m in result.measurements
                   if m.error is None)

    def test_timing_outliers_still_pick_viable(self):
        with faults.timing_outliers(period=3, spike_us=50_000.0):
            A, y = _small_spmv(backend="auto")
        assert A.tuning.picked_by == "measurement"
        best = [m for m in A.tuning.measurements
                if m.candidate == A.tuning.best]
        assert best[0].ok and np.isfinite(best[0].us_per_call)
        _, y_ref = _small_spmv()
        np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-5)

    def test_faults_restore_the_hooks(self):
        from repro_torch.core import engine as eng
        hooks = (eng.make_executor, search._measure_all,
                 search._timed_round)
        with faults.backend_failure("cuda"), faults.measurement_failure(), \
                faults.timing_outliers():
            assert (eng.make_executor, search._measure_all,
                    search._timed_round) != hooks
        assert (eng.make_executor, search._measure_all,
                search._timed_round) == hooks


# ------------------------------------------- the reference's trail
def _port_pkg():
    return dict(V=V, faults=faults, names={},
                build=lambda rows, cols, vals, **kw: SpMV.from_coo(
                    rows, cols, vals, (48, 48), device="cpu", **kw))


def _reference_pkg():
    from repro.core import validate as RV
    from repro.core.apps import SpMV as RSpMV
    from repro.testing import faults as RF
    # the port's counterparts of the reference's backends
    return dict(V=RV, faults=RF, names={"jax": "torch", "pallas": "cuda"},
                build=lambda rows, cols, vals, **kw: RSpMV.from_coo(
                    rows, cols, vals, (48, 48), **kw))


def _story(app, names) -> dict:
    """What a build's degradation story is made of, in either package
    (backend names in the port's words)."""
    t = app.tuning
    return {"events": sorted({(e.layer, e.kind) for e in app.degradations}),
            "cache_hit": None if t is None else t.cache_hit,
            "picked_by": None if t is None else t.picked_by,
            "failed": None if t is None else sorted(
                {names.get(m.candidate.backend, m.candidate.backend)
                 for m in t.measurements
                 if m.error is not None})}


def _readonly_plan_cache(pkg, tmp, build):
    cache = tmp / "plans"
    with pkg["faults"].deny_writes(cache):
        first = build(plan_cache_dir=str(cache))
        second = build(plan_cache_dir=str(cache))   # warned once already
    return [first, second], os.path.exists(cache)


def _disk_full_tune_cache(pkg, tmp, build):
    cache = tmp / "tune"
    os.makedirs(cache)
    with pkg["faults"].disk_full(cache):
        a = build(backend="auto", tune_cache_dir=str(cache))
    return [a], sorted(p.name for p in cache.iterdir())


def _torn_plan_cache(pkg, tmp, build):
    cache = tmp / "plans"
    with pkg["faults"].torn_writes(cache):
        a = build(plan_cache_dir=str(cache))
    return [a, build(plan_cache_dir=str(cache)),
            build(plan_cache_dir=str(cache))], len(list(cache.glob("*.plan")))


def _bad_tune_entry(text):
    def scenario(pkg, tmp, build):
        cache = tmp / "tune"
        a = build(backend="auto", tune_cache_dir=str(cache))
        entries = list(cache.glob("tune-*.json"))
        entries[0].write_text(text)
        return [a, build(backend="auto", tune_cache_dir=str(cache)),
                build(backend="auto", tune_cache_dir=str(cache))], \
            len(entries)
    return scenario


def _raising_candidate(pkg, tmp, build):
    with pkg["faults"].backend_failure("segsum"):
        return [build(backend="auto")], None


def _measurement_failure(pkg, tmp, build):
    cache = tmp / "tune"
    with pkg["faults"].measurement_failure():
        a = build(backend="auto", tune_cache_dir=str(cache))
    return [a], len(list(cache.glob("tune-*.json")))


def _timing_outliers(pkg, tmp, build):
    with pkg["faults"].timing_outliers(period=3, spike_us=50_000.0):
        return [build(backend="auto")], None


@pytest.mark.parametrize("scenario", [
    _readonly_plan_cache, _disk_full_tune_cache, _torn_plan_cache,
    _bad_tune_entry("{not json"),
    _bad_tune_entry(json.dumps({"schema": "tune.v999"})),
    _raising_candidate, _measurement_failure, _timing_outliers],
    ids=["readonly_plan_cache", "disk_full_tune_cache", "torn_plan_cache",
         "corrupt_tune_entry", "wrong_schema_tune_entry",
         "raising_candidate", "measurement_failure", "timing_outliers"])
def test_degradation_story_equals_reference(scenario, tmp_path):
    """The same inputs and the same fault through each package's app and
    injector: every build of the scenario records the same ``(layer,
    kind)`` events, ``cache_hit``, ``picked_by`` and failed backends, and
    the cache directory ends in the same state."""
    rng = np.random.default_rng(0)
    rows, cols, vals = _coo(rng, 48, 48, 256)
    got = {}
    for name, pkg in (("reference", _reference_pkg()), ("port", _port_pkg())):
        pkg["V"].reset_warn_once()
        tmp = tmp_path / name
        tmp.mkdir()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            apps, disk = scenario(
                pkg, tmp, lambda **kw: pkg["build"](rows, cols, vals, **kw))
        got[name] = ([_story(a, pkg["names"]) for a in apps], disk)
    assert got["port"] == got["reference"]


# --------------------------------------------------------- fixpoint health
class TestFixpointHealth:
    def _poisoned_sssp(self, driver):
        # -inf weight: relaxing through it produces -inf, and from an
        # unreached source inf + (-inf) = NaN — either poisons (min, +)
        src = np.array([0, 1]); dst = np.array([1, 2])
        w = np.array([1.0, -np.inf], np.float32)
        return SSSP.from_edges(src, dst, w, 3, validate="off",
                               driver=driver, device="cpu")

    @pytest.mark.parametrize("driver", ["resident", "host"])
    def test_poisoned_fixpoint_stops_early(self, driver):
        s = self._poisoned_sssp(driver)
        s.run(0)
        rep = s.convergence
        assert rep.diverged and not rep.converged and not rep.exhausted
        # the health flag stops the loop at the first poisoned sweep
        # instead of burning the full num_nodes+1 bound
        assert rep.sweeps == 1

    def test_poisoned_parity_host_vs_resident(self):
        a = self._poisoned_sssp("resident"); da = a.run(0)
        b = self._poisoned_sssp("host"); db = b.run(0)
        assert a.convergence == b.convergence
        np.testing.assert_array_equal(da.numpy(), db.numpy())

    def test_default_strict_rejects_poison_at_ingestion(self):
        with pytest.raises(V.InputError):
            SSSP.from_edges(np.array([0]), np.array([1]),
                            np.array([np.inf], np.float32), 2, device="cpu")

    @pytest.mark.parametrize("driver", ["resident", "host"])
    def test_negative_cycle_detected(self, driver):
        src = np.array([0, 1, 2]); dst = np.array([1, 2, 0])
        w = np.array([1.0, 1.0, -3.0], np.float32)
        s = SSSP.from_edges(src, dst, w, 3, driver=driver, device="cpu")
        s.run(0)
        rep = s.convergence
        assert rep.negative_cycle and rep.exhausted
        assert not rep.converged and not rep.diverged

    def test_negative_weights_without_cycle_converge(self):
        src = np.array([0, 1]); dst = np.array([1, 2])
        w = np.array([-2.0, -3.0], np.float32)
        s = SSSP.from_edges(src, dst, w, 3, device="cpu")
        d = s.run(0)
        assert s.convergence.converged and not s.convergence.negative_cycle
        np.testing.assert_array_equal(d.numpy(), [0.0, -2.0, -5.0])

    def test_capped_sweeps_report_exhausted_not_negative_cycle(self):
        # an exhausted run BELOW the Bellman-Ford bound proves nothing
        src = np.array([0, 1, 2, 3]); dst = np.array([1, 2, 3, 4])
        w = np.ones(4, np.float32)
        s = SSSP.from_edges(src, dst, w, 5, device="cpu")
        s.run(0, max_sweeps=2)
        rep = s.convergence
        assert rep.exhausted and not rep.negative_cycle

    def test_convergence_report_backcompat_aliases(self):
        src = np.array([0, 1]); dst = np.array([1, 2])
        b = BFS.from_edges(src, dst, 3, device="cpu")
        b.run(0)
        assert b.sweeps_run == b.convergence.sweeps > 0
        assert b.converged is True
