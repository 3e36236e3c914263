"""``repro_torch.serve.query`` (concurrent query serving, DESIGN.md §12) on
the CPU, ``backend="torch"``.

* Mirrors of the query-serving tests of ``tests/test_serve.py``:
  batched == sequential bitwise on all three endpoints, coalescing, both
  deadline stages, shedding, retry and exhausted retries, the
  non-retryable fault, the breaker and its half-open single probe, 2x
  overload, multithreaded clients, the health schema, the unknown
  endpoint, both ``slow_calls`` modes — with the port's
  ``testing.faults``.
* Against the reference's ``QueryEngine`` on the same seeded graph and
  payloads: BFS and SSSP exactly equal, SpMV within the reference's rule
  (``allclose(rtol=1e-5, atol=1e-6)``, ``tests/test_pallas.py``), and
  ``plan_fingerprint`` the same string.
* A batch whose host copy raises (where an asynchronous kernel fault
  surfaces on the card) fails or retries its tickets and leaves none
  pending; a faulting ``backend="cuda"`` batch is never re-run elsewhere.
* The launcher, driven in process on ``--device cpu``.

Every engine is closed (``with``), so no dispatcher thread outlives its
test.
"""
import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import graphs as RGR
from repro.core.apps import SpMV as RSpMV
from repro.serve import query as RQ
from repro.sparse import generators as RG

from repro_torch.core import graphs as GR
from repro_torch.core.apps import SpMV
from repro_torch.launch import serve_queries
from repro_torch.obs import metrics as M
from repro_torch.serve import query as Q
from repro_torch.sparse import generators as G
from repro_torch.testing import faults


@pytest.fixture(scope="module")
def graph_case():
    return G.graph_case("powerlaw", 192, avg_deg=6, seed=7)


@pytest.fixture(scope="module")
def bfs_app(graph_case):
    c = graph_case
    return GR.BFS.from_edges(c.src, c.dst, c.num_nodes, device="cpu")


@pytest.fixture(scope="module")
def sssp_app(graph_case):
    c = graph_case
    return GR.SSSP.from_edges(c.src, c.dst, c.weight, c.num_nodes,
                              device="cpu")


@pytest.fixture(scope="module")
def spmv_app():
    m = G.power_law(256, 6, seed=9)
    return SpMV.from_coo(m.rows, m.cols, m.vals, m.shape, device="cpu")


def _wait(ticket, clk=None, advance=0.0, timeout=30.0):
    """Poll a ticket to completion, optionally advancing a VirtualClock
    so backoff/cooldown gates pass without real sleeps."""
    deadline = time.monotonic() + timeout
    while not ticket.done():
        if clk is not None and advance:
            clk.advance(advance)
        time.sleep(0.002)
        if time.monotonic() > deadline:
            raise AssertionError("ticket never resolved")
    return ticket


# ----------------------------------------------------- correctness
def test_batched_equals_sequential_bitwise(bfs_app, sssp_app, spmv_app):
    """Every admitted request's result is bitwise-equal to its
    sequential single-request execution, across all three endpoints."""
    eng = Q.QueryEngine([Q.bfs_endpoint(bfs_app),
                         Q.sssp_endpoint(sssp_app),
                         Q.spmv_endpoint(spmv_app)],
                        queue_capacity=256)
    rng = np.random.default_rng(0)
    bfs_srcs = rng.integers(0, bfs_app.num_nodes, 9)
    sssp_srcs = rng.integers(0, sssp_app.num_nodes, 7)
    xs = rng.standard_normal(
        (5, spmv_app.shape[1])).astype(np.float32)
    with eng:
        tickets = ([("bfs", int(s), eng.submit("bfs", int(s)))
                    for s in bfs_srcs]
                   + [("sssp", int(s), eng.submit("sssp", int(s)))
                      for s in sssp_srcs]
                   + [("spmv", x, eng.submit("spmv", x)) for x in xs])
        for kind, payload, t in tickets:
            r = _wait(t).result(1)
            assert isinstance(r.value, np.ndarray)
            if kind == "bfs":
                assert np.array_equal(r.value, bfs_app.run(payload).numpy())
            elif kind == "sssp":
                assert np.array_equal(r.value,
                                      sssp_app.run(payload).numpy())
            else:
                ref = spmv_app.matvec(torch.as_tensor(payload)).numpy()
                assert np.array_equal(r.value, ref)
            assert r.attempts == 1


def test_continuous_batching_coalesces(bfs_app):
    """Back-to-back requests ride one batched dispatch (batch_size > 1
    observed), and per-request slicing still matches sequential runs."""
    eng = Q.QueryEngine([Q.bfs_endpoint(bfs_app)], queue_capacity=64)
    with eng:
        eng.warmup("bfs", 0)
        tickets = [eng.submit("bfs", s) for s in range(12)]
        sizes = {_wait(t).result(1).batch_size for t in tickets}
    assert max(sizes) > 1, f"no coalescing observed: {sizes}"


def test_endpoints_run_unpadded_batches(bfs_app, spmv_app, monkeypatch):
    """The endpoints ask for ``bucket=False``: a batch of 3 runs 3 lane
    columns, not the 4 of the bucket ladder."""
    seen = []
    real_multi, real_many = bfs_app.run_multi, spmv_app.matvec_many

    def run_multi(sources, bucket=True, **kw):
        seen.append(("bfs", len(sources), bucket))
        return real_multi(sources, bucket=bucket, **kw)

    def matvec_many(xs, bucket=True):
        seen.append(("spmv", len(xs), bucket))
        return real_many(xs, bucket=bucket)
    monkeypatch.setattr(bfs_app, "run_multi", run_multi)
    monkeypatch.setattr(spmv_app, "matvec_many", matvec_many)
    xs = list(np.ones((3, spmv_app.shape[1]), np.float32))
    out = Q.bfs_endpoint(bfs_app).batch_fn([0, 1, 2])
    assert tuple(out.shape) == (3, bfs_app.num_nodes)
    out = Q.spmv_endpoint(spmv_app).batch_fn(xs)
    assert tuple(out.shape) == (3, spmv_app.shape[0])
    assert seen == [("bfs", 3, False), ("spmv", 3, False)]


def test_warmup_makes_one_direct_call_at_batch(bfs_app):
    """``warmup(batch=b)`` calls ``batch_fn`` once directly with ``b``
    payloads (no walk of the bucket ladder: the port compiles nothing per
    shape), then serves one request through the queue."""
    sizes = []
    real = Q.bfs_endpoint(bfs_app, max_batch=8)

    def batch_fn(sources):
        sizes.append(len(sources))
        return real.batch_fn(sources)
    ep = dataclasses.replace(real, batch_fn=batch_fn)
    with Q.QueryEngine([ep]) as eng:
        r = eng.warmup("bfs", 3, batch=16)
        health = eng.health()
    assert sizes == [8, 1]                   # capped at max_batch, then 1
    assert np.array_equal(r.value, bfs_app.run(3).numpy())
    assert health["endpoints"]["bfs"]["warm"]


# ----------------------------------------------------- deadlines
def test_deadline_expired_in_queue_never_dispatched():
    clk = faults.VirtualClock()
    calls = []
    ep = Q.Endpoint(name="echo", batch_fn=lambda ps: calls.append(
        list(ps)) or list(ps))
    eng = Q.QueryEngine([ep], clock=clk, poll_interval_s=0.05)
    with eng:
        t = eng.submit("echo", 1, deadline_s=0.01)
        clk.advance(1.0)      # expires before the dispatcher wakes
        _wait(t)
        with pytest.raises(Q.DeadlineExceeded) as ei:
            t.result(1)
    assert ei.value.stage == "queued"
    assert ei.value.request_id
    assert not any(1 in c for c in calls), "expired request was dispatched"


def test_inflight_overrun_is_recorded_straggler():
    clk = faults.VirtualClock()
    ep = Q.Endpoint(name="echo", batch_fn=lambda ps: list(ps))
    eng = Q.QueryEngine([ep], clock=clk)
    before = M.value("serve.deadline.inflight")
    with eng, faults.slow_calls((ep, "batch_fn"), 0.5, clock=clk):
        t = eng.submit("echo", 1, deadline_s=0.1)
        _wait(t)
        with pytest.raises(Q.DeadlineExceeded) as ei:
            t.result(1)
    assert ei.value.stage == "inflight"
    assert ei.value.overrun_s == pytest.approx(0.4)
    assert M.value("serve.deadline.inflight") == before + 1


# ----------------------------------------------------- shedding
def test_bounded_queue_sheds_loudly():
    clk = faults.VirtualClock()
    ep = Q.Endpoint(name="echo", batch_fn=lambda ps: list(ps))
    # poll_interval long enough that nothing drains while we flood
    eng = Q.QueryEngine([ep], clock=clk, queue_capacity=3,
                        poll_interval_s=5.0)
    shed = []
    admitted = []
    for i in range(10):
        try:
            admitted.append(eng.submit("echo", i))
        except Q.RejectedError as e:
            shed.append(e)
    assert len(shed) == 7 and len(admitted) == 3
    assert all(e.capacity == 3 and e.queue_depth == 3 for e in shed)
    h = eng.health()
    assert h["counters"]["shed"] == 7
    assert h["ready"] is False      # queue full => not ready
    eng.close()
    # admitted requests were still served on close(drain=True)
    assert [t.result(5).value for t in admitted] == [0, 1, 2]


# ----------------------------------------------------- retry/backoff
def test_retry_with_backoff_on_degradable_fault():
    clk = faults.VirtualClock()
    state = {"calls": 0}

    def torn_then_fine(ps):
        state["calls"] += 1
        if state["calls"] <= 2:
            raise OSError("torn tuning cache entry mid-flight")
        return [p * 10 for p in ps]

    ep = Q.Endpoint(name="flaky", batch_fn=torn_then_fine)
    eng = Q.QueryEngine([ep], clock=clk, backoff_s=0.01,
                        backoff_cap_s=0.05, max_retries=3,
                        breaker_threshold=10)
    before = M.value("degradation.serve.retryable_fault")
    with eng:
        t = eng.submit("flaky", 7)
        r = _wait(t, clk=clk, advance=0.05).result(1)
    assert r.value == 70
    assert r.attempts == 3
    assert M.value("degradation.serve.retryable_fault") == before + 2
    kinds = [e.kind for e in eng.degradations]
    assert kinds.count("retryable_fault") == 2


def test_retries_exhausted_surfaces_original_error():
    clk = faults.VirtualClock()

    def always_torn(ps):
        raise OSError("torn forever")

    ep = Q.Endpoint(name="torn", batch_fn=always_torn)
    eng = Q.QueryEngine([ep], clock=clk, backoff_s=0.01, max_retries=1,
                        breaker_threshold=100)
    with eng:
        t = eng.submit("torn", 1)
        _wait(t, clk=clk, advance=0.05)
        with pytest.raises(OSError, match="torn forever"):
            t.result(1)


def test_nonretryable_fault_fails_fast():
    clk = faults.VirtualClock()

    def boom(ps):
        raise RuntimeError("executor exploded")

    ep = Q.Endpoint(name="boom", batch_fn=boom)
    eng = Q.QueryEngine([ep], clock=clk, breaker_threshold=100)
    with eng:
        t = eng.submit("boom", 1)
        _wait(t)
        with pytest.raises(RuntimeError, match="executor exploded"):
            t.result(1)


# ----------------------------------------------------- host copy faults
def _faulty(n, error):
    """A batch result whose host copy raises ``error``, as a kernel fault
    on the card surfaces at the first synchronize after its launch."""
    class FaultyCopy(torch.Tensor):
        def cpu(self, *a, **k):
            raise error("CUDA error: an illegal memory access was "
                        "encountered")
    return torch.zeros((n, 4)).as_subclass(FaultyCopy)


def test_host_copy_fault_fails_the_batch_not_the_dispatcher():
    """A fault at the one host copy fails every ticket of its batch with
    that error, counts toward the breaker, and the dispatcher serves the
    next batch."""
    clk = faults.VirtualClock()
    state = {"fault": True}

    def fn(ps):
        if state["fault"]:
            return _faulty(len(ps), RuntimeError)
        return torch.arange(len(ps) * 4.0).reshape(len(ps), 4)

    ep = Q.Endpoint(name="card", batch_fn=fn, max_batch=8)
    eng = Q.QueryEngine([ep], clock=clk, breaker_threshold=100,
                        poll_interval_s=0.5)
    with eng:
        tickets = [eng.submit("card", i) for i in range(5)]
        for t in tickets:
            _wait(t)
            with pytest.raises(RuntimeError, match="illegal memory"):
                t.result(1)
        h = eng.health()
        assert h["counters"]["faults"] >= 1
        assert h["breaker"]["consecutive_faults"] >= 1
        assert "illegal memory" in h["breaker"]["last_fault"]
        assert h["inflight"] == 0 and h["queue_depth"] == 0
        state["fault"] = False
        r = _wait(eng.submit("card", 9)).result(1)
    assert isinstance(r.value, np.ndarray)
    assert np.array_equal(r.value, np.arange(4.0))
    assert all(t.done() for t in tickets)


def test_host_copy_oserror_is_retried():
    clk = faults.VirtualClock()
    state = {"calls": 0}

    def fn(ps):
        state["calls"] += 1
        if state["calls"] == 1:
            return _faulty(len(ps), OSError)
        return torch.full((len(ps), 2), 3.0)

    ep = Q.Endpoint(name="card", batch_fn=fn)
    eng = Q.QueryEngine([ep], clock=clk, backoff_s=0.01, max_retries=2,
                        breaker_threshold=10)
    with eng:
        r = _wait(eng.submit("card", 0), clk=clk, advance=0.05).result(1)
    assert r.attempts == 2
    assert np.array_equal(r.value, [3.0, 3.0])
    assert [e.kind for e in eng.degradations] == ["retryable_fault"]


def test_cuda_backend_fault_is_never_served_elsewhere(graph_case,
                                                       monkeypatch):
    """A ``backend="cuda"`` BFS (the kernels' plain versions on the CPU)
    whose window kernel raises: every ticket fails with the kernel's
    error and no other emitter runs the batch."""
    from repro_torch.core import engine as peng
    from repro_torch.core import ir
    from repro_torch.kernels.unroll_spmv import ops
    c = graph_case
    app = GR.BFS.from_edges(c.src, c.dst, c.num_nodes, lane_width=16,
                            backend="cuda", device="cpu")
    assert any(la.gather == ir.WINDOW for la in app._run.tree.launches)
    built = []
    real_make = peng.make_executor

    def make_executor(*a, **k):
        built.append(k.get("backend"))
        return real_make(*a, **k)

    def broken(*a, **k):
        raise RuntimeError("window kernel launch failed: CUDA error 700")
    monkeypatch.setattr(peng, "make_executor", make_executor)
    monkeypatch.setattr(ops, "window_stage_a", broken)
    eng = Q.QueryEngine([Q.bfs_endpoint(app, max_batch=4)],
                        breaker_threshold=100)
    with eng:
        tickets = [eng.submit("bfs", s) for s in range(6)]
        for t in tickets:
            _wait(t)
            with pytest.raises(RuntimeError, match="CUDA error 700"):
                t.result(1)
        h = eng.health()
    assert h["counters"]["faults"] >= 2 and "served" not in h["counters"]
    assert built == []


# ----------------------------------------------------- circuit breaker
def test_breaker_trips_serves_unavailable_and_half_open_recovers():
    clk = faults.VirtualClock()
    state = {"fail": True}

    def sometimes(ps):
        if state["fail"]:
            raise RuntimeError("backend fault")
        return list(ps)

    ep = Q.Endpoint(name="ep", batch_fn=sometimes)
    eng = Q.QueryEngine([ep], clock=clk, breaker_threshold=2,
                        breaker_cooldown_s=10.0)
    with eng:
        for i in range(2):
            t = eng.submit("ep", i)
            _wait(t)
            with pytest.raises(RuntimeError):
                t.result(1)
        h = eng.health()
        assert h["breaker"]["state"] == "open"
        assert h["breaker"]["consecutive_faults"] == 2
        assert "backend fault" in h["breaker"]["last_fault"]
        assert h["ready"] is False
        with pytest.raises(Q.Unavailable) as ei:
            eng.submit("ep", 9)
        assert ei.value.breaker == "open"
        assert ei.value.retry_after_s > 0
        assert any(e.kind == "breaker_open" for e in eng.degradations)

        # half-open probe: a still-failing probe re-opens the breaker
        clk.advance(11.0)
        t = eng.submit("ep", 1)
        _wait(t)
        with pytest.raises(RuntimeError):
            t.result(1)
        assert eng.health()["breaker"]["state"] == "open"

        # a succeeding probe closes it and traffic resumes
        state["fail"] = False
        clk.advance(11.0)
        t = eng.submit("ep", 5)
        assert _wait(t).result(1).value == 5
        assert eng.health()["breaker"]["state"] == "closed"
        assert eng.health()["ready"] is True


def test_half_open_probes_one_request_at_a_time():
    clk = faults.VirtualClock()
    sizes = []
    state = {"fail": True}

    def fn(ps):
        if state["fail"]:
            raise RuntimeError("x")
        sizes.append(len(ps))
        return list(ps)

    ep = Q.Endpoint(name="ep", batch_fn=fn)
    eng = Q.QueryEngine([ep], clock=clk, breaker_threshold=1,
                        breaker_cooldown_s=5.0, poll_interval_s=0.005)
    with eng:
        t0 = eng.submit("ep", 0)
        _wait(t0)
        with pytest.raises(RuntimeError):
            t0.result(1)
        assert eng.health()["breaker"]["state"] == "open"
        state["fail"] = False
        clk.advance(6.0)           # half-open on next tick
        ts = [eng.submit("ep", i) for i in range(4)]
        for t in ts:
            _wait(t)
        assert sizes[0] == 1, f"probe batched {sizes[0]} requests"
        assert [t.result(1).value for t in ts] == [0, 1, 2, 3]


# ----------------------------------------------------- overload e2e
def test_overload_2x_sheds_and_serves_admitted_bitwise(bfs_app):
    """The acceptance scenario: 2x overload with injected latency —
    the excess is shed/deadline-failed loudly (structured errors with
    queue state) while every ADMITTED request returns a result
    bitwise-equal to its sequential execution."""
    clk = faults.VirtualClock()
    cap = 8
    ep = Q.bfs_endpoint(bfs_app, max_batch=4)
    eng = Q.QueryEngine([ep], clock=clk, queue_capacity=cap,
                        poll_interval_s=5.0)   # hold dispatch: flood first
    outcomes = {"served": [], "shed": [], "deadline": []}
    with eng, faults.slow_calls((ep, "batch_fn"), 0.2, clock=clk):
        tickets = []
        for s in range(2 * cap):               # 2x the queue capacity
            try:
                tickets.append((s, eng.submit("bfs", s, deadline_s=30.0)))
            except Q.RejectedError as e:
                assert e.queue_depth == cap
                outcomes["shed"].append(s)
        for s, t in tickets:
            try:
                r = _wait(t).result(1)
                assert np.array_equal(r.value, bfs_app.run(s).numpy()), s
                outcomes["served"].append(s)
            except Q.DeadlineExceeded:
                outcomes["deadline"].append(s)
    assert len(outcomes["shed"]) == cap            # the 2x excess shed
    assert len(outcomes["served"]) == cap          # everyone admitted served
    assert not outcomes["deadline"]
    h = eng.health()
    assert h["counters"]["shed"] == cap


# ----------------------------------------------------- client stress
def test_multithreaded_clients_no_lost_or_duplicated_responses(bfs_app):
    """>= 4 producer threads hammering one engine: every request gets
    exactly one response, ids are unique, and each response is correct
    for ITS request (no cross-request slicing mixups)."""
    eng = Q.QueryEngine([Q.bfs_endpoint(bfs_app, max_batch=16)],
                        queue_capacity=512)
    n_threads, per_thread = 6, 20
    results: dict[str, tuple] = {}
    errors: list = []
    lock = threading.Lock()

    def client(tid):
        rng = np.random.default_rng(tid)
        pairs = []
        for i in range(per_thread):
            s = int(rng.integers(0, bfs_app.num_nodes))
            pairs.append((s, eng.submit(
                "bfs", s, request_id=f"t{tid}-{i}")))
        for s, t in pairs:
            try:
                r = t.result(60)
                with lock:
                    results[r.request_id] = (s, r)
            except Exception as e:  # noqa: BLE001 — collected for assert
                with lock:
                    errors.append(e)

    with eng:
        eng.warmup("bfs", 0)
        threads = [threading.Thread(target=client, args=(tid,))
                   for tid in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert len(results) == n_threads * per_thread    # none lost, none duped
    served = eng.health()["counters"]["served"]
    assert served == n_threads * per_thread + 1      # + warmup
    by_source: dict[int, np.ndarray] = {}
    for rid, (s, r) in results.items():
        ref = by_source.setdefault(s, bfs_app.run(s).numpy())
        assert np.array_equal(r.value, ref), rid


# ----------------------------------------------------- health schema
def test_health_report_schema(bfs_app):
    eng = Q.QueryEngine([Q.bfs_endpoint(bfs_app)], queue_capacity=4)
    with eng:
        eng.warmup("bfs", 0)
        h = eng.health()
    assert set(h) >= {"ready", "queue_depth", "capacity", "inflight",
                      "closed", "breaker", "endpoints", "counters"}
    assert set(h["breaker"]) == {"state", "consecutive_faults",
                                 "cooldown_remaining_s", "last_fault"}
    ep = h["endpoints"]["bfs"]
    assert set(ep) == {"fingerprint", "max_batch", "tuned", "warm",
                       "batches_served"}
    assert ep["warm"] is True and ep["batches_served"] >= 1
    assert ep["fingerprint"].startswith("bfs_relax:")
    assert isinstance(h["counters"], dict)
    assert h["ready"] in (True, False)
    # closed engine is not ready and rejects with EngineClosed
    assert eng.health()["closed"] is True
    with pytest.raises(Q.EngineClosed):
        eng.submit("bfs", 0)


def test_unknown_endpoint_rejected(bfs_app):
    with Q.QueryEngine([Q.bfs_endpoint(bfs_app)]) as eng:
        with pytest.raises(ValueError, match="unknown endpoint"):
            eng.submit("nope", 0)
        with pytest.raises(ValueError, match="unknown endpoint"):
            eng.warmup("nope", 0)


# ----------------------------------------------------- fault injectors
def test_slow_calls_path_mode_advances_virtual_clock(tmp_path):
    clk = faults.VirtualClock()
    p = tmp_path / "cache" / "entry.bin"
    p.parent.mkdir()
    p.write_bytes(b"x")
    with faults.slow_calls(tmp_path, 0.25, clock=clk):
        with open(p, "rb") as f:
            f.read()
    assert clk() == pytest.approx(0.25)
    # thread-scoped: another thread's opens are NOT delayed
    t0 = clk()

    def other():
        with open(p, "rb") as f:
            f.read()

    with faults.slow_calls(tmp_path, 0.25, clock=clk):
        th = threading.Thread(target=other)
        th.start()
        th.join(30)
    assert clk() == t0


def test_slow_calls_restores_on_exit():
    ep = Q.Endpoint(name="e", batch_fn=lambda ps: list(ps))
    original = ep.batch_fn
    with faults.slow_calls((ep, "batch_fn"), 0.1,
                           clock=faults.VirtualClock()):
        assert ep.batch_fn is not original
    assert ep.batch_fn is original


# ----------------------------------------------------- vs the reference
@pytest.fixture(scope="module")
def reference_apps():
    c = RG.graph_case("powerlaw", 192, avg_deg=6, seed=7)
    m = RG.power_law(256, 6, seed=9)
    return {"bfs": RGR.BFS.from_edges(c.src, c.dst, c.num_nodes),
            "sssp": RGR.SSSP.from_edges(c.src, c.dst, c.weight,
                                        c.num_nodes),
            "spmv": RSpMV.from_coo(m.rows, m.cols, m.vals, m.shape)}


def _serve_all(q, endpoints, payloads):
    """Every payload through one engine of package ``q``; the values in
    submission order."""
    with q.QueryEngine(endpoints, queue_capacity=256) as eng:
        tickets = [(kind, eng.submit(kind, p)) for kind, p in payloads]
        return [(kind, np.asarray(t.result(60).value))
                for kind, t in tickets]


def test_results_equal_reference_engine(bfs_app, sssp_app, spmv_app,
                                        reference_apps):
    """The same payloads through the reference's engine and the port's:
    BFS and SSSP exactly equal, SpMV within the reference's rule."""
    rng = np.random.default_rng(3)
    payloads = ([("bfs", int(s)) for s in rng.integers(0, 192, 11)]
                + [("sssp", int(s)) for s in rng.integers(0, 192, 6)]
                + [("spmv", x) for x in rng.standard_normal(
                    (5, 256)).astype(np.float32)])
    ref = _serve_all(RQ, [RQ.bfs_endpoint(reference_apps["bfs"]),
                          RQ.sssp_endpoint(reference_apps["sssp"]),
                          RQ.spmv_endpoint(reference_apps["spmv"])],
                     payloads)
    port = _serve_all(Q, [Q.bfs_endpoint(bfs_app),
                          Q.sssp_endpoint(sssp_app),
                          Q.spmv_endpoint(spmv_app)], payloads)
    for (kind, want), (_, got) in zip(ref, port):
        assert got.shape == want.shape and got.dtype == want.dtype, kind
        if kind == "spmv":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["bfs", "sssp", "spmv"])
def test_plan_fingerprint_equals_reference(kind, bfs_app, sssp_app,
                                           spmv_app, reference_apps):
    port = {"bfs": bfs_app, "sssp": sssp_app, "spmv": spmv_app}[kind]
    want = RQ.plan_fingerprint(reference_apps[kind].plan)
    assert Q.plan_fingerprint(port.plan) == want
    assert getattr(Q, f"{kind}_endpoint")(port).fingerprint == want


# ----------------------------------------------------- launcher
@pytest.mark.parametrize("app", ["bfs", "sssp", "spmv"])
def test_launcher_serves_every_request_on_cpu(app, tmp_path, capsys):
    out = tmp_path / "serve.json"
    summary = serve_queries.main([
        "--app", app, "--device", "cpu", "--backend", "torch",
        "--nodes", "300", "--avg-deg", "4", "--requests", "48",
        "--threads", "4", "--max-batch", "8", "--json", str(out)])
    data = json.loads(out.read_text())
    assert data["served"] == data["requests"] == 48
    assert data["errors"] == {"shed": 0, "deadline": 0, "other": 0}
    assert data["health"]["breaker"]["state"] == "closed"
    assert data["health"]["closed"] is False
    assert data["device"] == "cpu" and data["backend"] == "torch"
    assert summary["served"] == 48
    assert "[serve] served=48/48" in capsys.readouterr().out


@pytest.mark.parametrize("app", ["bfs", "sssp", "spmv"])
def test_launcher_check_holds_sampled_responses(app, tmp_path):
    """``--check`` holds sampled responses of a ``segsum`` build against a
    ``torch`` build: BFS/SSSP bitwise, SpMV (summed in another order)
    within the reference's rule."""
    out = tmp_path / "serve.json"
    summary = serve_queries.main([
        "--app", app, "--device", "cpu", "--backend", "segsum",
        "--nodes", "300", "--avg-deg", "4", "--requests", "48",
        "--threads", "4", "--max-batch", "8", "--check", "8",
        "--json", str(out)])
    check = json.loads(out.read_text())["check"]
    assert check == summary["check"]
    assert check["checked"] == 8 and check["mismatched"] == 0
    if app != "spmv":
        assert check["bitwise"] == 8


def test_launcher_check_fails_on_a_wrong_response(tmp_path, monkeypatch):
    """A served value that differs from the ``torch`` build makes the
    launcher exit non-zero, after it wrote its JSON summary."""
    real = serve_queries._build_endpoint

    def build(args, device):
        ep, payloads = real(args, device)
        if args.backend != "torch":
            fn = ep.batch_fn
            ep = dataclasses.replace(ep, batch_fn=lambda ps: fn(ps) + 1)
        return ep, payloads
    monkeypatch.setattr(serve_queries, "_build_endpoint", build)
    out = tmp_path / "serve.json"
    with pytest.raises(SystemExit, match="8 of 8 sampled responses"):
        serve_queries.main([
            "--app", "bfs", "--device", "cpu", "--backend", "segsum",
            "--nodes", "300", "--avg-deg", "4", "--requests", "16",
            "--threads", "2", "--max-batch", "8", "--check", "8",
            "--json", str(out)])
    assert json.loads(out.read_text())["check"]["mismatched"] == 8
