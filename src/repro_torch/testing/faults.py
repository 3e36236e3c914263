"""Fault-injection context managers (DESIGN.md §9).

Every graceful-degradation claim in the robustness model is only worth
what its end-to-end proof is worth: these context managers inject the
real failure classes — unwritable cache dirs, full disks, torn publishes,
raising backends, broken/noisy timers — scoped to a ``with`` block, so
``tests/test_torch_robust.py`` can drive each documented fallback path
through the actual production code and assert both the result
(bitwise-equal output where applicable) and the recorded
:class:`~repro_torch.core.validate.DegradationEvent` trail.

Filesystem faults are path- AND thread-scoped: the patches are
process-global (``builtins.open`` etc.), but only operations issued by
the thread that entered the context and targeting the given directory
(or its children) fail; everything else — pytest's own tmp files, the
kernel build's ``nvcc`` outputs, parallel test runners — is untouched.
All patches restore on exit, even when the body raises.  The
non-filesystem faults (:func:`backend_failure`, :func:`measurement_failure`,
:func:`timing_outliers`) patch ``repro_torch``-internal hooks
(``core.engine.make_executor``, ``tune.search._measure_all`` and
``tune.search._timed_round``, which the tuner and the apps call through
their modules, so the patch takes effect) and stay process-wide; don't run
two of those concurrently.

On the ``"cuda"`` platform the tuner does not degrade where the
reference's does: a ``cuda`` candidate that raises (``backend_failure
("cuda")``) makes the tune raise
:class:`~repro_torch.tune.search.KernelCandidateError` instead of being
disqualified, and a failing measurement harness (``measurement_failure``)
raises its own error instead of falling back to the cost model's pick.  A
kernel's fault on the card is never handed to a plain torch form.  Off the
card both degrade as in the reference.

:func:`slow_calls` injects *latency* instead of failure — on a path
(thread-scoped, like the fs injectors) or on an ``(obj, "attr")`` call
site (process-wide: the serving dispatcher thread is the caller under
test) — and, combined with a :class:`VirtualClock` handed to the
serving engine, makes deadline/straggler/circuit-breaker behavior
deterministic with no real sleeps in the hot path.

A port of the JAX package's ``testing/faults.py``.
"""
from __future__ import annotations

import builtins
import contextlib
import errno
import os
import tempfile
import threading
import time


def _under(root, p) -> bool:
    try:
        p = os.fspath(p)
    except TypeError:                   # e.g. an int fd through os.fdopen
        return False
    if isinstance(p, bytes):
        p = os.fsdecode(p)
    if not isinstance(p, str):
        return False
    a = os.path.abspath(p)
    r = os.path.abspath(os.fsdecode(os.fspath(root)))
    return a == r or a.startswith(r + os.sep)


def _oserror(err: int, path) -> OSError:
    return OSError(err, os.strerror(err), os.fspath(path))


def _scoped(root):
    """Fault predicate: true only for paths under ``root`` touched by
    the thread that entered the fault context.  The monkeypatches are
    process-global, so without this any concurrent thread (a kernel
    build, a parallel test runner) writing under ``root``
    during the with-block would absorb an injected fault meant for the
    test body."""
    owner = threading.get_ident()

    def hit(p) -> bool:
        return threading.get_ident() == owner and _under(root, p)
    return hit


@contextlib.contextmanager
def deny_writes(root, err: int = errno.EROFS):
    """Simulate an unwritable cache dir (default EROFS — a read-only
    mount; pass ``errno.EACCES`` for a permission wall).

    Directory creation under ``root`` fails unless the directory already
    exists (matching real read-only semantics, where ``makedirs(...,
    exist_ok=True)`` on an existing dir succeeds), temp-file creation and
    atomic publishes under ``root`` fail, and opening any file under
    ``root`` for writing fails.  Reads pass through untouched."""
    real_open = builtins.open
    real_makedirs = os.makedirs
    real_replace = os.replace
    real_mkstemp = tempfile.mkstemp
    hit = _scoped(root)

    def open_(file, mode="r", *a, **k):
        if any(c in mode for c in "wxa+") and hit(file):
            raise _oserror(err, file)
        return real_open(file, mode, *a, **k)

    def makedirs_(name, *a, **k):
        if hit(name):
            if os.path.isdir(name):
                return                  # exist_ok on a read-only mount
            raise _oserror(err, name)
        return real_makedirs(name, *a, **k)

    def replace_(src, dst, *a, **k):
        if hit(dst) or hit(src):
            raise _oserror(err, dst)
        return real_replace(src, dst, *a, **k)

    def mkstemp_(*a, **k):
        d = k.get("dir") or (a[2] if len(a) > 2 else None)
        if d is not None and hit(d):
            raise _oserror(err, d)
        return real_mkstemp(*a, **k)

    builtins.open = open_
    os.makedirs = makedirs_
    os.replace = replace_
    tempfile.mkstemp = mkstemp_
    try:
        yield
    finally:
        builtins.open = real_open
        os.makedirs = real_makedirs
        os.replace = real_replace
        tempfile.mkstemp = real_mkstemp


@contextlib.contextmanager
def disk_full(root):
    """Simulate ENOSPC mid-publish: directories and temp files are
    created fine (the dir entry fits), but writing file *content* under
    ``root`` and the final atomic rename fail — the late-failure shape a
    real full disk produces, which exercises the temp-file cleanup path
    rather than the early makedirs/mkstemp bail-out."""
    real_open = builtins.open
    real_replace = os.replace
    hit = _scoped(root)

    def open_(file, mode="r", *a, **k):
        if any(c in mode for c in "wxa+") and hit(file):
            raise _oserror(errno.ENOSPC, file)
        return real_open(file, mode, *a, **k)

    def replace_(src, dst, *a, **k):
        if hit(dst):
            raise _oserror(errno.ENOSPC, dst)
        return real_replace(src, dst, *a, **k)

    builtins.open = open_
    os.replace = replace_
    try:
        yield
    finally:
        builtins.open = real_open
        os.replace = real_replace


@contextlib.contextmanager
def torn_writes(root, keep: float = 0.5):
    """Tear every atomic publish under ``root``: the temp file is
    truncated to ``keep`` of its length immediately before the rename,
    so the published cache entry is a torn write — exactly what a crash
    between ``write`` and ``fsync`` leaves behind.  The publish itself
    "succeeds"; the corruption must be caught by the *reader*
    (checksums + structural validation)."""
    real_replace = os.replace
    hit = _scoped(root)

    def replace_(src, dst, *a, **k):
        if hit(dst) and os.path.isfile(src):
            size = os.path.getsize(src)
            with open(src, "r+b") as f:
                f.truncate(max(int(size * keep), 0))
        return real_replace(src, dst, *a, **k)

    os.replace = replace_
    try:
        yield
    finally:
        os.replace = real_replace


class VirtualClock:
    """A monotonic clock under test control: ``clock()`` reads it,
    ``advance()`` moves it.  The serving engine takes ``clock=`` at
    construction, so deadline/straggler/breaker timing runs against
    virtual seconds — :func:`slow_calls` advances this clock instead of
    sleeping, keeping latency tests deterministic with zero real sleeps
    in the measured path."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            return self._t

    def advance(self, dt: float) -> float:
        with self._lock:
            self._t += float(dt)
            return self._t


def _apply_delay(delay_s: float, clock) -> None:
    if clock is not None and hasattr(clock, "advance"):
        clock.advance(delay_s)
    else:
        time.sleep(delay_s)


@contextlib.contextmanager
def slow_calls(path_or_fn, delay_s: float, *, clock=None):
    """Latency injection: every matching call appears ``delay_s``
    seconds slower.

    ``path_or_fn`` selects the injection site:

    * a **directory path** — ``open()`` calls under it are delayed,
      path- and thread-scoped exactly like the fs fault injectors
      (slow NFS / cold page cache on a cache dir);
    * an ``(obj, "attr")`` **pair** — ``obj.attr`` is rebound to a
      delaying wrapper for the duration.  This patch is process-wide on
      purpose: the serving engine's dispatcher thread (not the test
      thread) is the caller whose latency is under test.

    With ``clock=`` a :class:`VirtualClock`, the delay ADVANCES the
    clock instead of sleeping — deadline/straggler/breaker paths become
    deterministically testable without real sleeps in the hot path."""
    if isinstance(path_or_fn, tuple):
        obj, name = path_or_fn
        real = getattr(obj, name)

        def slowed(*a, **k):
            out = real(*a, **k)
            _apply_delay(delay_s, clock)
            return out

        def _set(value):
            try:
                setattr(obj, name, value)
            except AttributeError:      # frozen dataclass (e.g. Endpoint)
                object.__setattr__(obj, name, value)

        _set(slowed)
        try:
            yield
        finally:
            _set(real)
        return

    real_open = builtins.open
    hit = _scoped(path_or_fn)

    def open_(file, *a, **k):
        if hit(file):
            _apply_delay(delay_s, clock)
        return real_open(file, *a, **k)

    builtins.open = open_
    try:
        yield
    finally:
        builtins.open = real_open


@contextlib.contextmanager
def backend_failure(backend: str = "segsum",
                    message: str = "injected backend failure"):
    """Make ``engine.make_executor`` raise for one backend (``"torch"``,
    ``"segsum"`` or ``"cuda"``) — the raising-tuning-candidate fault.  Off
    the card the tuner must disqualify the candidate (recording a
    DegradationEvent) and pick among the survivors, never crash the build;
    a ``cuda`` candidate on the card raises ``KernelCandidateError``."""
    from repro_torch.core import engine as eng
    real = eng.make_executor

    def fake(plan, static_data, backend_arg="torch", **kw):
        b = kw.pop("backend", backend_arg)
        if b == backend:
            raise RuntimeError(f"{message} (backend={b})")
        return real(plan, static_data, backend=b, **kw)

    eng.make_executor = fake
    try:
        yield
    finally:
        eng.make_executor = real


@contextlib.contextmanager
def measurement_failure(message: str = "injected measurement failure"):
    """Break the tuner's timing harness outright (the total-measurement
    -failure fault): off the card ``autotune`` must fall back to the
    analytical cost-model pick instead of raising; on the card it raises."""
    from repro_torch.tune import search
    real = search._measure_all

    def fake(*a, **k):
        raise RuntimeError(message)

    search._measure_all = fake
    try:
        yield
    finally:
        search._measure_all = real


@contextlib.contextmanager
def timing_outliers(period: int = 3, spike_us: float = 50_000.0):
    """Inject periodic timing spikes (scheduler preemption, GC pause)
    into the tuner's per-round timer: every ``period``-th timed round
    reads ``spike_us`` microseconds too slow.  The paired-ratio
    measurement discipline must still complete and pick a viable
    candidate."""
    from repro_torch.tune import search
    real = search._timed_round
    state = {"n": 0}

    def fake(run, mutable, out_init, iters):
        t = real(run, mutable, out_init, iters)
        state["n"] += 1
        if state["n"] % period == 0:
            t += spike_us
        return t

    search._timed_round = fake
    try:
        yield
    finally:
        search._timed_round = real
