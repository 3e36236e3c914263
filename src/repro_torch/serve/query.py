"""Concurrent query serving over shared plans (DESIGN.md §12).

The paper's amortization argument — one inspected plan pays for many
executions — has to survive concurrent traffic: many simultaneous small
queries (multi-source BFS, personalized SSSP, SpMV lookups) over ONE
shared graph, arriving faster than they can be served one at a time.
:class:`QueryEngine` is that serving layer, built robustness-first:

* **Admission control.**  A bounded queue; a full queue sheds the
  request LOUDLY (:class:`RejectedError` carrying the queue depth),
  never buffers unboundedly.
* **Continuous batching.**  A dispatcher thread drains compatible
  requests (same endpoint — same app + graph fingerprint) into ONE
  batched dispatch through the app's batched entry points
  (``run_multi`` / ``matvec_many``, the requests as lane columns), with
  per-request result slicing on completion.  The endpoints call them
  with ``bucket=False``: the reference pads a batch up the bucket ladder
  so distinct arrival counts share compiled XLA programs, the port
  compiles nothing per shape, and a padded column costs a kernel's full
  work.  Every admitted request's result is bitwise-equal to its
  sequential single-request execution (each lane column runs the
  arithmetic of one request in the same order).
* **One host copy per batch, inside the guard.**  A ``torch.Tensor``
  result is copied to the host once (``.cpu().numpy()``) inside the same
  ``try`` as the batch's call: a kernel fault on the card is asynchronous
  and surfaces at the first synchronize, which is that copy, so it takes
  the batch-fault path (retry, breaker) like any executor fault and never
  kills the dispatcher with admitted tickets pending.  Per-request values
  are numpy row views of that copy.
* **No fallback.**  An endpoint calls its app and nothing else: a fault
  on a ``backend="cuda"`` app is the batch's error, never re-run on the
  ``"torch"`` backend or the CPU.
* **Deadlines.**  A request past its deadline is never dispatched
  (:class:`DeadlineExceeded` with ``stage="queued"``); a request whose
  batch overran its deadline in flight gets the same error with
  ``stage="inflight"`` and the overrun recorded — the result is
  computed but a late answer is a wrong answer to the client.
* **Retry with jittered backoff.**  A batch that fails on a
  *degradable* fault (default: ``OSError`` — the cache-layer fault
  class of DESIGN.md §9, e.g. a torn tuning-cache entry mid-flight) is
  requeued with exponential backoff and deterministic per-request
  jitter, up to ``max_retries``; the retry is recorded on the
  degradation trail.
* **Circuit breaker.**  ``breaker_threshold`` consecutive executor
  faults trip the breaker: every submit fails fast with a loud
  :class:`Unavailable` (carrying breaker state + cooldown) until the
  cooldown elapses, then ONE half-open probe batch decides between
  closing and re-opening.
* **Health.**  :meth:`QueryEngine.health` reports queue depth, breaker
  state, per-endpoint warm-plan status (the cold-start story: the kernel
  library builds at its first launch), and the engine's counters.

All timing runs against an injectable ``clock`` (default
``time.monotonic``), so tests drive deadline/straggler/breaker paths
deterministically with :class:`repro_torch.testing.faults.VirtualClock`
and ``slow_calls`` — no real sleeps in the hot path.

A port of the JAX package's ``serve/query.py``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
import zlib

import numpy as np
import torch

from repro_torch.core import validate as validation
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

__all__ = [
    "ServeError", "RejectedError", "DeadlineExceeded", "Unavailable",
    "EngineClosed", "Endpoint", "Response", "Ticket", "QueryEngine",
    "bfs_endpoint", "sssp_endpoint", "spmv_endpoint", "plan_fingerprint",
]


# ------------------------------------------------------------ errors
class ServeError(RuntimeError):
    """Base class for structured serving errors.  Keyword details are
    stored on the instance (and rendered into the message), so clients
    and tests can branch on fields instead of parsing strings."""

    def __init__(self, message: str, **details):
        self.details = details
        if details:
            kv = ", ".join(f"{k}={v!r}" for k, v in sorted(details.items()))
            message = f"{message} [{kv}]"
        super().__init__(message)

    def __getattr__(self, name):
        try:
            return self.__dict__["details"][name]
        except KeyError:
            raise AttributeError(name) from None


class RejectedError(ServeError):
    """Load shed at admission: the bounded queue is full.  Carries
    ``queue_depth`` and ``capacity`` — backpressure is explicit, never
    an unbounded buffer."""


class DeadlineExceeded(ServeError):
    """The request missed its deadline — ``stage="queued"`` (expired
    before dispatch; never executed) or ``stage="inflight"`` (the batch
    overran; ``overrun_s`` records by how much)."""


class Unavailable(ServeError):
    """The circuit breaker is open after consecutive executor faults.
    Carries ``breaker`` state and ``retry_after_s``."""


class EngineClosed(ServeError):
    """The engine was closed; no further requests are admitted."""


# ------------------------------------------------------------ endpoints
def plan_fingerprint(plan) -> str:
    """Stable content fingerprint of a plan's access pattern: same graph
    + same seed => same fingerprint, across processes.  Requests are
    batchable only within one endpoint, i.e. one (app, fingerprint).
    The same string as the reference's for the same plan."""
    from repro_torch.core import planio
    h = planio.array_fingerprint(np.asarray(plan.flat_perm))
    return f"{plan.seed.name}:{plan.out_len}:{h.hex()[:16]}"


@dataclasses.dataclass(frozen=True)
class Endpoint:
    """One served application: a name, the batched entry point
    (``batch_fn(payloads) -> per-request results``, leading axis =
    request), and the plan fingerprint that defines compatibility."""

    name: str
    batch_fn: object
    fingerprint: str = ""
    max_batch: int = 32
    tuned: bool = False


@contextlib.contextmanager
def _on_device(device: torch.device):
    """Run a batch on its app's card and that card's default stream: the
    dispatcher is a thread of its own, and a thread's current CUDA device
    and stream are its own, where the kernels launch."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device), \
            torch.cuda.stream(torch.cuda.default_stream(device)):
        yield


def _sources_endpoint(app, name: str, max_batch: int) -> Endpoint:
    def batch_fn(sources):
        with _on_device(app.device):
            return app.run_multi(np.asarray(sources, np.int64),
                                 bucket=False)
    return Endpoint(name=name, batch_fn=batch_fn,
                    fingerprint=plan_fingerprint(app.plan),
                    max_batch=max_batch, tuned=app.tuning is not None)


def bfs_endpoint(app, name: str = "bfs", max_batch: int = 32) -> Endpoint:
    """Serve multi-source BFS queries (payload: source node id) through
    the app's batched resident driver; one batch = one convergence."""
    return _sources_endpoint(app, name, max_batch)


def sssp_endpoint(app, name: str = "sssp", max_batch: int = 32) -> Endpoint:
    """Serve single-source shortest-path queries (payload: source node
    id) through the batched Bellman-Ford entry."""
    return _sources_endpoint(app, name, max_batch)


def spmv_endpoint(app, name: str = "spmv", max_batch: int = 32) -> Endpoint:
    """Serve SpMV lookups (payload: a dense ``(n,)`` input vector)
    through the batched matvec (the vectors as lane columns)."""
    def batch_fn(xs):
        with _on_device(app.device):
            return app.matvec_many(np.stack(xs), bucket=False)
    return Endpoint(name=name, batch_fn=batch_fn,
                    fingerprint=plan_fingerprint(app.plan),
                    max_batch=max_batch, tuned=app.tuning is not None)


# ------------------------------------------------------------ requests
@dataclasses.dataclass
class Response:
    """A served result plus its service story (for latency accounting)."""

    value: object
    request_id: str
    endpoint: str
    attempts: int
    batch_size: int
    queued_s: float
    total_s: float


class _Future:
    """Minimal thread-safe one-shot future (no executor coupling)."""

    __slots__ = ("_ev", "_value", "_exc")

    def __init__(self):
        self._ev = threading.Event()
        self._value = None
        self._exc = None

    def set_result(self, v) -> None:
        self._value = v
        self._ev.set()

    def set_exception(self, e: BaseException) -> None:
        self._exc = e
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: float | None = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("request still pending")
        if self._exc is not None:
            raise self._exc
        return self._value


@dataclasses.dataclass
class _Request:
    rid: str
    endpoint: str
    payload: object
    deadline: float | None          # absolute, engine-clock seconds
    enqueued: float
    future: _Future
    attempts: int = 0
    not_before: float = 0.0         # retry backoff gate


class Ticket:
    """Client handle for a submitted request."""

    __slots__ = ("_req",)

    def __init__(self, req: _Request):
        self._req = req

    @property
    def request_id(self) -> str:
        return self._req.rid

    def done(self) -> bool:
        return self._req.future.done()

    def result(self, timeout: float | None = None) -> Response:
        """Block for the response.  Raises the structured serving error
        (:class:`DeadlineExceeded`, :class:`Unavailable`, ...) or the
        executor's own exception when the request failed."""
        return self._req.future.result(timeout)


# ------------------------------------------------------------ engine
class QueryEngine:
    """The concurrent query-serving engine (module docstring for the
    policy story).  One dispatcher thread owns all execution — an app's
    run state is not thread-safe anyway, and a single drain loop
    makes the continuous-batching policy (and its tests) deterministic.
    Producers only ever touch the admission queue under the lock."""

    def __init__(self, endpoints=(), *, queue_capacity: int = 128,
                 default_deadline_s: float | None = None,
                 max_retries: int = 2, backoff_s: float = 0.05,
                 backoff_cap_s: float = 1.0, breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 1.0,
                 retryable: tuple = (OSError,),
                 clock=time.monotonic, poll_interval_s: float = 0.002):
        if queue_capacity <= 0:
            raise ValueError("queue_capacity must be positive")
        self._endpoints: dict[str, Endpoint] = {}
        self._capacity = int(queue_capacity)
        self._default_deadline = default_deadline_s
        self._max_retries = int(max_retries)
        self._backoff = float(backoff_s)
        self._backoff_cap = float(backoff_cap_s)
        self._breaker_threshold = int(breaker_threshold)
        self._cooldown = float(breaker_cooldown_s)
        self._retryable = tuple(retryable)
        self._clock = clock
        self._poll = float(poll_interval_s)

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._q: collections.deque[_Request] = collections.deque()
        self._rid = itertools.count(1)
        self._closing = False
        self._inflight = 0

        # breaker state machine: closed -> open -> half_open -> ...
        self._breaker = "closed"
        self._consec_faults = 0
        self._opened_at = 0.0
        self._last_fault: str | None = None

        # engine-local counters (process metrics mirror them globally)
        self._counts = collections.Counter()
        self._ep_batches = collections.Counter()
        # degradation trail: record_degradation's thread-local sinks
        # live on the DISPATCHER thread, so the engine keeps its own
        # copy of every event it records (surfaced via .degradations,
        # same shape as app.degradations)
        self._degradations: list = []

        for ep in endpoints:
            self.register(ep)
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name="repro-serve-dispatcher")
        self._dispatcher.start()

    # ------------------------------------------------------ admission
    def register(self, ep: Endpoint) -> None:
        if not isinstance(ep, Endpoint):
            raise TypeError(f"expected an Endpoint, got {type(ep).__name__}")
        with self._lock:
            self._endpoints[ep.name] = ep

    def submit(self, endpoint: str, payload, *,
               deadline_s: float | None = None,
               request_id: str | None = None) -> Ticket:
        """Admit one request, or shed it loudly.  Raises
        :class:`RejectedError` (queue full), :class:`Unavailable`
        (breaker open), or :class:`EngineClosed`; never blocks."""
        now = self._clock()
        with self._lock:
            if self._closing:
                raise EngineClosed("engine is closed")
            ep = self._endpoints.get(endpoint)
            if ep is None:
                raise ValueError(
                    f"unknown endpoint {endpoint!r}; registered: "
                    f"{sorted(self._endpoints)}")
            self._tick_breaker_locked(now)
            if self._breaker == "open":
                retry_after = max(0.0,
                                  self._opened_at + self._cooldown - now)
                self._counts["unavailable"] += 1
                _metrics.inc("serve.unavailable")
                raise Unavailable(
                    "circuit breaker open after consecutive executor "
                    "faults", breaker="open",
                    consecutive_faults=self._consec_faults,
                    last_fault=self._last_fault,
                    retry_after_s=round(retry_after, 3))
            if len(self._q) >= self._capacity:
                self._counts["shed"] += 1
                _metrics.inc("serve.shed")
                raise RejectedError(
                    "admission queue full — request shed",
                    queue_depth=len(self._q), capacity=self._capacity)
            if deadline_s is None:
                deadline_s = self._default_deadline
            req = _Request(
                rid=request_id or f"r{next(self._rid)}",
                endpoint=endpoint, payload=payload,
                deadline=None if deadline_s is None else now + deadline_s,
                enqueued=now, future=_Future())
            self._q.append(req)
            self._counts["submitted"] += 1
            _metrics.inc("serve.requests")
            _metrics.set_gauge("serve.queue_depth", len(self._q))
            self._work.notify()
        return Ticket(req)

    def warmup(self, endpoint: str, payload,
               timeout: float | None = 120.0, batch: int = 1) -> Response:
        """Synchronously serve one request — the cold-start story: run
        this before opening traffic so the first real request doesn't
        pay the kernel library's build (minutes of ``nvcc`` on a cold
        build directory) or the first launches.  It first makes ONE
        direct ``batch_fn`` call of ``batch`` copies of ``payload``
        (capped at the endpoint's ``max_batch``) on the caller's thread —
        deterministic, outside the breaker's accounting and the ticket's
        ``timeout`` — then serves one request through the queue.  The
        reference instead walks every bucket-ladder size up to ``batch``
        to pre-trace one XLA program per size; the port compiles nothing
        per shape (one build holds every kernel), so one call is enough.
        Flips the endpoint's ``warm`` health bit on success."""
        with self._lock:
            ep = self._endpoints.get(endpoint)
        if ep is None:
            raise ValueError(f"unknown endpoint {endpoint!r}")
        ep.batch_fn([payload] * max(1, min(int(batch), ep.max_batch)))
        return self.submit(endpoint, payload).result(timeout)

    # ------------------------------------------------------ breaker
    def _tick_breaker_locked(self, now: float) -> None:
        if self._breaker == "open" and \
                now >= self._opened_at + self._cooldown:
            self._breaker = "half_open"
            _metrics.inc("serve.breaker.half_open")

    def _trip_breaker_locked(self, now: float, fault: str) -> None:
        reopened = self._breaker == "half_open"
        if self._consec_faults >= self._breaker_threshold or reopened:
            self._breaker = "open"
            self._opened_at = now
            self._counts["breaker_opened"] += 1
            _metrics.inc("serve.breaker.opened")
            self._degradations.append(validation.record_degradation(
                "serve", "breaker_open",
                f"{self._consec_faults} consecutive executor faults "
                f"(last: {fault})",
                "fail-fast Unavailable until half-open probe succeeds"))

    # ------------------------------------------------------ dispatch
    def _dispatch_loop(self) -> None:
        while True:
            with self._work:
                batch, ep = self._take_batch_locked()
                if batch is None:
                    if self._closing:
                        self._drain_closed_locked()
                        return
                    self._work.wait(self._poll)
                    continue
            self._run_batch(ep, batch)

    def _take_batch_locked(self):
        """Pop the next dispatchable batch: expired requests are failed
        in place (never dispatched), backoff-gated retries stay queued,
        and the first ready request's endpoint defines the batch —
        compatible requests behind it (same endpoint, ready, within
        deadline) ride along up to ``max_batch``."""
        now = self._clock()
        self._tick_breaker_locked(now)
        if self._breaker == "open":
            return None, None
        batch: list[_Request] = []
        target: Endpoint | None = None
        keep: list[_Request] = []
        while self._q:
            req = self._q.popleft()
            if req.deadline is not None and now > req.deadline:
                self._counts["deadline_queued"] += 1
                _metrics.inc("serve.deadline.queued")
                req.future.set_exception(DeadlineExceeded(
                    "deadline expired before dispatch", stage="queued",
                    request_id=req.rid, queue_depth=len(self._q)))
                continue
            if req.not_before > now:
                keep.append(req)
                continue
            if target is None:
                target = self._endpoints[req.endpoint]
            if req.endpoint != target.name:
                keep.append(req)
                continue
            batch.append(req)
            if len(batch) >= target.max_batch:
                break
        # unconsumed requests keep their arrival order at the front
        self._q.extendleft(reversed(keep))
        _metrics.set_gauge("serve.queue_depth", len(self._q))
        if not batch:
            return None, None
        if self._breaker == "half_open" and len(batch) > 1:
            # probe with ONE request; the rest re-queue ahead
            self._q.extendleft(reversed(batch[1:]))
            batch = batch[:1]
            _metrics.set_gauge("serve.queue_depth", len(self._q))
        self._inflight = len(batch)
        return batch, target

    def _run_batch(self, ep: Endpoint, batch: list[_Request]) -> None:
        t0 = self._clock()
        with _trace.span("serve.batch", endpoint=ep.name,
                         batch_size=len(batch)) as sp:
            try:
                results = ep.batch_fn([r.payload for r in batch])
                if isinstance(results, torch.Tensor):
                    # one host copy per batch, inside the guard: a kernel
                    # fault on the card surfaces at this first synchronize
                    # and must fail the batch, not the dispatcher.  The
                    # per-request rows handed out below are numpy views.
                    results = results.detach().cpu().numpy()
            except Exception as e:  # noqa: BLE001 — classified below
                sp.set(error=type(e).__name__)
                self._on_batch_fault(ep, batch, e)
                return
        self._on_batch_done(ep, batch, results, t0)

    def _on_batch_done(self, ep: Endpoint, batch, results,
                       t0: float) -> None:
        now = self._clock()
        with self._lock:
            self._inflight = 0
            self._consec_faults = 0
            if self._breaker == "half_open":
                self._breaker = "closed"
                self._counts["breaker_closed"] += 1
                _metrics.inc("serve.breaker.closed")
            self._ep_batches[ep.name] += 1
            self._counts["batches"] += 1
        _metrics.inc("serve.batches")
        _metrics.observe("serve.batch_size", len(batch))
        for i, req in enumerate(batch):
            if req.deadline is not None and now > req.deadline:
                overrun = now - req.deadline
                with self._lock:
                    self._counts["deadline_inflight"] += 1
                _metrics.inc("serve.deadline.inflight")
                _metrics.observe("serve.deadline.overrun_s", overrun)
                req.future.set_exception(DeadlineExceeded(
                    "batch overran the deadline in flight",
                    stage="inflight", request_id=req.rid,
                    overrun_s=round(overrun, 4),
                    batch_size=len(batch)))
                continue
            total = now - req.enqueued
            with self._lock:
                self._counts["served"] += 1
            _metrics.inc("serve.served")
            _metrics.observe("serve.latency_s", total)
            req.future.set_result(Response(
                value=results[i], request_id=req.rid, endpoint=req.endpoint,
                attempts=req.attempts + 1, batch_size=len(batch),
                queued_s=t0 - req.enqueued, total_s=total))

    def _on_batch_fault(self, ep: Endpoint, batch,
                        exc: Exception) -> None:
        now = self._clock()
        retryable = isinstance(exc, self._retryable)
        with self._lock:
            self._inflight = 0
            self._consec_faults += 1
            self._last_fault = f"{type(exc).__name__}: {exc}"
            self._counts["faults"] += 1
            _metrics.inc("serve.faults")
            self._trip_breaker_locked(now, self._last_fault)
            requeued = 0
            if retryable:
                self._degradations.append(validation.record_degradation(
                    "serve", "retryable_fault",
                    f"batch of {len(batch)} on {ep.name!r} failed: "
                    f"{self._last_fault}",
                    "requeued with jittered backoff"))
            for req in batch:
                if retryable and req.attempts < self._max_retries:
                    req.attempts += 1
                    req.not_before = now + self._backoff_for(req)
                    self._q.appendleft(req)
                    requeued += 1
                    self._counts["retries"] += 1
                    _metrics.inc("serve.retries")
                else:
                    req.future.set_exception(exc)
            _metrics.set_gauge("serve.queue_depth", len(self._q))
            if requeued:
                self._work.notify()

    def _backoff_for(self, req: _Request) -> float:
        """Exponential backoff with deterministic per-(request, attempt)
        jitter in [0.5, 1.5) — decorrelates retry herds without RNG
        state, and tests can predict the exact gate."""
        j = zlib.crc32(f"{req.rid}:{req.attempts}".encode()) % 1000
        factor = 0.5 + j / 1000.0
        return min(self._backoff * (2 ** (req.attempts - 1)) * factor,
                   self._backoff_cap)

    # ------------------------------------------------------ lifecycle
    def _drain_closed_locked(self) -> None:
        while self._q:
            req = self._q.popleft()
            req.future.set_exception(EngineClosed(
                "engine closed before the request could be served",
                request_id=req.rid))
        _metrics.set_gauge("serve.queue_depth", 0)

    def close(self, drain: bool = True,
              timeout: float | None = 30.0) -> None:
        """Stop admitting; serve what is queued (``drain=True``, unless
        the breaker is open) or fail it with :class:`EngineClosed`,
        then stop the dispatcher."""
        with self._lock:
            if not drain or self._breaker == "open":
                self._drain_closed_locked()
            self._closing = True
            self._work.notify_all()
        self._dispatcher.join(timeout)

    def __enter__(self) -> "QueryEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------ health
    @property
    def degradations(self) -> tuple:
        """DegradationEvents the engine recorded (retryable faults,
        breaker trips) — same shape as ``app.degradations``."""
        with self._lock:
            return tuple(self._degradations)

    def health(self) -> dict:
        """Structured readiness/health report: queue, breaker, warm-plan
        status per endpoint, and the engine's counters.  ``ready`` means
        requests submitted now would be admitted."""
        now = self._clock()
        with self._lock:
            self._tick_breaker_locked(now)
            cooldown = 0.0
            if self._breaker == "open":
                cooldown = max(0.0, self._opened_at + self._cooldown - now)
            return {
                "ready": (not self._closing and self._breaker != "open"
                          and len(self._q) < self._capacity),
                "queue_depth": len(self._q),
                "capacity": self._capacity,
                "inflight": self._inflight,
                "closed": self._closing,
                "breaker": {
                    "state": self._breaker,
                    "consecutive_faults": self._consec_faults,
                    "cooldown_remaining_s": round(cooldown, 4),
                    "last_fault": self._last_fault,
                },
                "endpoints": {
                    name: {
                        "fingerprint": ep.fingerprint,
                        "max_batch": ep.max_batch,
                        "tuned": ep.tuned,
                        "warm": self._ep_batches[name] > 0,
                        "batches_served": self._ep_batches[name],
                    } for name, ep in self._endpoints.items()
                },
                "counters": dict(self._counts),
            }
