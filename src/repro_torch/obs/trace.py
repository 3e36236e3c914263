"""Nestable, thread-local spans over the lowering pipeline.

A *span* is one timed region with a name, attributes, and a parent — the
pipeline opens them around plan builds, validation, cache lookups, IR
passes, tuner rounds, executor construction, and sweep execution, so one
``backend="auto"`` run produces a tree covering
build → validate → lower(per-pass) → tune → execute.

Design constraints (DESIGN.md §11):

* **Disabled is free.**  Tracing is off by default; ``span()`` then
  returns a shared singleton no-op context manager — no object is
  allocated, no clock is read, no lock is taken.
* **Thread-local nesting, process-global record.**  Each thread keeps
  its own open-span stack (the tuner and the serving layer run builds
  concurrently), finished spans land in one process-wide list so a
  single export sees every thread.
* **Two exports.**  :func:`to_chrome_trace` emits Chrome/Perfetto
  trace-event JSON (``ph: "X"`` complete events, microsecond
  timestamps); :func:`tree_dump` renders the same records as an
  indented text tree for terminals and test failures.

Enable with ``trace.enable()`` or ``REPRO_TRACE=1`` in the environment.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time

__all__ = ["enable", "disable", "enabled", "reset", "span", "traced",
           "current_span_id", "open_spans", "finished_spans",
           "to_chrome_trace", "export_chrome_trace", "tree_dump",
           "SpanRecord"]

_enabled = os.environ.get("REPRO_TRACE", "").lower() not in (
    "", "0", "false", "off")
_lock = threading.Lock()
_next_id = 0
_finished: list["SpanRecord"] = []
_tls = threading.local()


class SpanRecord:
    """One finished span (immutable-by-convention export record)."""

    __slots__ = ("span_id", "parent_id", "name", "start_ns", "end_ns",
                 "attrs", "thread_id")

    def __init__(self, span_id, parent_id, name, start_ns, end_ns, attrs,
                 thread_id):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.attrs = attrs
        self.thread_id = thread_id

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"SpanRecord({self.name!r}, id={self.span_id}, "
                f"dur={self.duration_ns / 1e6:.3f}ms, attrs={self.attrs})")


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _Span:
    """A live (open) span; becomes a :class:`SpanRecord` on exit."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "start_ns")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> "_Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        global _next_id
        with _lock:
            _next_id += 1
            self.span_id = _next_id
        stack = _stack()
        self.parent_id = stack[-1].span_id if stack else None
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end_ns = time.perf_counter_ns()
        stack = _stack()
        # tolerate imbalance (a leaked child) rather than corrupting the
        # stack: pop self specifically
        if stack and stack[-1] is self:
            stack.pop()
        else:  # pragma: no cover - defensive
            try:
                stack.remove(self)
            except ValueError:
                pass
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        rec = SpanRecord(self.span_id, self.parent_id, self.name,
                         self.start_ns, end_ns, self.attrs,
                         threading.get_ident())
        with _lock:
            _finished.append(rec)
        return False


class _NopSpan:
    """Shared do-nothing span: the entire disabled-tracing fast path."""

    __slots__ = ()

    def set(self, **attrs) -> "_NopSpan":
        return self

    def __enter__(self) -> "_NopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOP = _NopSpan()


def span(name: str, **attrs):
    """Open a span.  Use as ``with trace.span("plan.build", nnz=n) as sp:``
    and add result attributes via ``sp.set(...)`` before the block exits.
    When tracing is disabled this returns a shared no-op singleton."""
    if not _enabled:
        return _NOP
    return _Span(name, attrs)


def traced(name: str, **static_attrs):
    """Decorator form of :func:`span` for functions whose whole body is
    one region (validators, app constructors).  The disabled path is a
    single module-global check before delegating."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _enabled:
                return fn(*args, **kwargs)
            with _Span(name, dict(static_attrs)):
                return fn(*args, **kwargs)
        return wrapper
    return deco


# ------------------------------------------------------------- control
def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Drop all finished spans and this thread's open stack (tests)."""
    global _next_id
    with _lock:
        _finished.clear()
        _next_id = 0
    _stack().clear()


# ------------------------------------------------------------ inspection
def current_span_id() -> int | None:
    """Id of the innermost open span on THIS thread (None when tracing
    is disabled or no span is open) — degradation events record it."""
    if not _enabled:
        return None
    stack = _stack()
    return stack[-1].span_id if stack else None


def open_spans() -> list[str]:
    """Names of this thread's currently-open spans, outermost first —
    must be empty between pipeline operations (the leak test)."""
    return [s.name for s in _stack()]


def finished_spans() -> list[SpanRecord]:
    with _lock:
        return list(_finished)


# -------------------------------------------------------------- exports
def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:  # numpy scalars
        return v.item()
    except AttributeError:
        return str(v)


def to_chrome_trace() -> dict:
    """Chrome/Perfetto trace-event JSON: one ``ph: "X"`` complete event
    per finished span (load the file at ui.perfetto.dev or
    chrome://tracing)."""
    pid = os.getpid()
    events = []
    for rec in finished_spans():
        events.append({
            "name": rec.name,
            "cat": rec.name.split(".", 1)[0],
            "ph": "X",
            "ts": rec.start_ns / 1e3,          # microseconds
            "dur": rec.duration_ns / 1e3,
            "pid": pid,
            "tid": rec.thread_id,
            "args": {k: _jsonable(v) for k, v in rec.attrs.items()},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(path: str) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(), f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def tree_dump() -> str:
    """Plain-text span tree (per thread, chronological)."""
    recs = finished_spans()
    children: dict = {}
    roots = []
    for rec in recs:
        if rec.parent_id is None:
            roots.append(rec)
        else:
            children.setdefault(rec.parent_id, []).append(rec)
    lines: list[str] = []

    def walk(rec: SpanRecord, depth: int) -> None:
        attrs = " ".join(f"{k}={_jsonable(v)}" for k, v in rec.attrs.items())
        lines.append(f"{'  ' * depth}{rec.name}  "
                     f"{rec.duration_ns / 1e6:.3f}ms"
                     f"{('  [' + attrs + ']') if attrs else ''}")
        for child in sorted(children.get(rec.span_id, []),
                            key=lambda r: r.start_ns):
            walk(child, depth + 1)

    for root in sorted(roots, key=lambda r: r.start_ns):
        walk(root, 0)
    return "\n".join(lines)
