"""Input validation + graceful-degradation bookkeeping (DESIGN.md §9).

The whole pipeline is input-dependent by construction: the feature table
and the code tree are derived from whatever index arrays the caller hands
us, so a single out-of-range index or NaN payload poisons every result
built on the plan.  This module is the one gate every untrusted ingestion
surface goes through:

* :func:`validate_coo` / :func:`validate_csr` / :func:`validate_edges` —
  policy-driven checks for the three ingestion formats.
  ``policy="strict"`` raises a structured :class:`InputError` naming the
  first offending position (and the first few offenders) so the caller
  can actually fix the input; ``policy="repair"`` returns a canonical
  cleaned copy: out-of-range entries dropped, NaN/Inf payloads dropped,
  duplicate coordinates combined with the seed's own reduce (semiring
  aware — ``add`` matches scipy's ``sum_duplicates`` bitwise), entries
  sorted row-major, empty matrices canonicalized to zero-length arrays
  of well-defined dtypes.  ``policy="off"`` is the trust-me escape hatch.

* :class:`DegradationEvent` + :func:`record_degradation` /
  :func:`collect_degradations` — the structured trail a degraded build
  leaves behind.  Cache layers (``planio``, ``tune.cache``) and the tuner
  record an event whenever they fall back (unwritable dir, corrupt entry,
  disqualified candidate, measurement failure) instead of raising; the
  application constructors collect the events raised under them and
  surface the trail as ``app.degradations`` so callers — and the future
  serving layer's health endpoint — can see exactly which fallbacks fired.

Validation is numpy-only and runs once per matrix at ingestion time; the
strict policy is pure bounds/finite checks (a few vectorized passes over
nnz — well under 5% of a plan build), the repair policy adds one lexsort.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings

import numpy as np

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.obs.log import get_logger

_log = get_logger("repro_torch.validate")
_deg_log = get_logger("repro_torch.degradation")

POLICIES = ("strict", "repair", "off")

# how many offending positions an InputError carries (the full set can be
# nnz-sized; the first few are what a human needs to find the bug)
_MAX_REPORTED = 8

_REDUCE_UFUNC = {"add": np.add, "mul": np.multiply,
                 "min": np.minimum, "max": np.maximum}


class InputError(ValueError):
    """A rejected ingestion input, naming what and where.

    ``field`` is the offending argument (``"row"``, ``"col"``,
    ``"vals"``, ``"indptr"``, ...), ``indices`` the first few offending
    positions in that array, ``count`` the total number of offenders.
    """

    def __init__(self, message: str, *, field: str | None = None,
                 indices=None, count: int | None = None):
        super().__init__(message)
        self.field = field
        self.indices = None if indices is None else \
            np.asarray(indices)[:_MAX_REPORTED]
        self.count = count


@dataclasses.dataclass(frozen=True)
class ValidationReport:
    """What validation saw (and, under ``repair``, what it changed)."""

    policy: str
    nnz_in: int = 0
    nnz_out: int = 0
    out_of_range_dropped: int = 0
    nonfinite_dropped: int = 0
    duplicates_combined: int = 0
    canonicalized: bool = False     # repair sorted/rewrote the arrays

    @property
    def clean(self) -> bool:
        return (self.out_of_range_dropped == 0
                and self.nonfinite_dropped == 0
                and self.duplicates_combined == 0)


# ------------------------------------------------------------ degradation
@dataclasses.dataclass(frozen=True)
class DegradationEvent:
    """One recorded fallback: the system kept working, but not on the
    path the caller configured.  ``layer`` names the subsystem
    (``plan_cache`` / ``tune_cache`` / ``tune``), ``kind`` the failure
    class (``write_failed`` / ``corrupt_entry`` / ``candidate_failed`` /
    ``measurement_failed`` / ``replay_failed``), ``fallback`` what ran
    instead.  ``span_id`` is the innermost open trace span at record
    time (None when tracing is off) — it joins the degradation trail to
    the span tree in exported traces (DESIGN.md §11)."""

    layer: str
    kind: str
    detail: str
    fallback: str
    span_id: int | None = None


# sink stack is thread-local: a build on one thread must not leak its
# degradation trail into an app being constructed on another (the
# serving layer builds plans from worker threads)
_tls = threading.local()


def _sinks() -> list:
    s = getattr(_tls, "sinks", None)
    if s is None:
        s = _tls.sinks = []
    return s


@contextlib.contextmanager
def collect_degradations():
    """Collect every :func:`record_degradation` fired in this thread
    while the context is active.  Nesting works: an event reaches every
    active sink, so an app constructor sees the events its cache layers
    record even when a caller is also collecting."""
    sink: list[DegradationEvent] = []
    stack = _sinks()
    stack.append(sink)
    try:
        yield sink
    finally:
        # remove by IDENTITY, never equality: two empty (or equal-content)
        # sinks compare equal, so list.remove would pop the OUTER
        # collector when a nested one exits without recording anything —
        # orphaning the inner sink and raising on the outer exit
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is sink:
                del stack[i]
                break


def record_degradation(layer: str, kind: str, detail: str,
                       fallback: str) -> DegradationEvent:
    """Append a :class:`DegradationEvent` to every active collector (a
    no-op trail when nobody is collecting — recording must never be the
    thing that fails).  Every event also increments the process-wide
    ``degradation.events`` / ``degradation.<layer>.<kind>`` counters and
    logs to ``repro_torch.degradation``, so the trail is visible even when no
    collector (and no warnings filter) is active."""
    ev = DegradationEvent(layer=layer, kind=kind, detail=detail,
                          fallback=fallback,
                          span_id=_trace.current_span_id())
    for sink in _sinks():
        sink.append(ev)
    _metrics.inc("degradation.events")
    _metrics.inc(f"degradation.{layer}.{kind}")
    _deg_log.warning("%s/%s: %s (fallback: %s)", layer, kind, detail,
                     fallback)
    return ev


_warned_keys: set = set()
_warned_lock = threading.Lock()


def warn_once(key, message: str, category=RuntimeWarning,
              logger: str = "repro_torch.validate") -> bool:
    """Warn the first time ``key`` is seen in this process.  A cache dir
    that is unwritable stays unwritable: one warning tells the operator,
    a warning per build is log spam.  Returns True if it warned.

    Every first-seen message is ALSO emitted through the ``repro_torch.*``
    logger hierarchy (``logger`` names the child — cache layers pass
    ``"repro_torch.plan_cache"`` / ``"repro_torch.tune_cache"``), so embedders can
    capture/filter structurally instead of scraping RuntimeWarnings;
    the legacy ``warnings.warn`` stays for interactive use and tests."""
    with _warned_lock:
        if key in _warned_keys:
            return False
        _warned_keys.add(key)
    get_logger(logger).warning(message)
    warnings.warn(message, category, stacklevel=3)
    return True


def reset_warn_once() -> None:
    """Forget warn-once history (tests)."""
    with _warned_lock:
        _warned_keys.clear()


# ------------------------------------------------------------- validators
def _check_policy(policy: str) -> None:
    if policy not in POLICIES:
        raise ValueError(f"unknown validation policy {policy!r}; "
                         f"expected one of {POLICIES}")


def _as_index_array(a, name: str, policy: str) -> np.ndarray:
    """Index arrays must be integer 1-D.  Repair tolerates float arrays
    whose values are exactly integral (a common CSV-ingestion artifact)
    by casting; anything else is structurally broken in every policy."""
    a = np.asarray(a)
    if a.ndim != 1:
        raise InputError(f"{name} must be 1-D, got shape {a.shape}",
                         field=name)
    if np.issubdtype(a.dtype, np.integer):
        return a
    if policy == "repair" and np.issubdtype(a.dtype, np.floating) \
            and a.size and np.all(np.isfinite(a)) and np.all(a == np.floor(a)):
        return a.astype(np.int64)
    if policy == "repair" and a.size == 0:
        return a.astype(np.int64)
    raise InputError(
        f"{name} must have an integer dtype, got {a.dtype}", field=name)


def _first_offenders(mask: np.ndarray) -> tuple[np.ndarray, int]:
    idx = np.flatnonzero(mask)
    return idx, int(idx.size)


def _strict_range_error(name: str, arr: np.ndarray, mask: np.ndarray,
                        bound: int) -> InputError:
    idx, count = _first_offenders(mask)
    first = int(idx[0])
    return InputError(
        f"{name}[{first}] = {int(arr[first])} is outside [0, {bound}) "
        f"({count} offending entr{'y' if count == 1 else 'ies'}; "
        f"first positions {idx[:_MAX_REPORTED].tolist()})",
        field=name, indices=idx, count=count)


def _strict_finite_error(name: str, vals: np.ndarray,
                         mask: np.ndarray) -> InputError:
    idx, count = _first_offenders(mask)
    first = int(idx[0])
    return InputError(
        f"{name}[{first}] = {vals[first]} is not finite "
        f"({count} non-finite entr{'y' if count == 1 else 'ies'}; "
        f"first positions {idx[:_MAX_REPORTED].tolist()})",
        field=name, indices=idx, count=count)


def _nonfinite_mask(vals: np.ndarray) -> np.ndarray | None:
    """Mask of non-finite payload entries, or None when the dtype cannot
    hold one (integers are always finite — skip the pass entirely)."""
    if vals.size and np.issubdtype(vals.dtype, np.inexact):
        finite = np.isfinite(vals)
        # rank-polymorphic payloads (SpMM rows): an entry is bad if ANY
        # lane of it is non-finite
        if finite.ndim > 1:
            finite = finite.reshape(finite.shape[0], -1).all(axis=1)
        if not finite.all():
            return ~finite
    return None


def _combine_duplicates(rows: np.ndarray, cols: np.ndarray,
                        vals: np.ndarray, reduce: str):
    """Sort row-major (stable) and combine equal coordinates with the
    reduce's ufunc.  For ``reduce="add"`` this is exactly scipy's
    ``coo_matrix.sum_duplicates`` (same lexsort, same
    ``np.add.reduceat``), so the repaired triple is bitwise-equal to the
    scipy oracle."""
    ufunc = _REDUCE_UFUNC[reduce]
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if rows.size == 0:
        return rows, cols, vals, 0
    first = np.empty(rows.size, bool)
    first[0] = True
    first[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    dups = int(rows.size - np.count_nonzero(first))
    if dups:
        starts = np.flatnonzero(first)
        vals = ufunc.reduceat(vals, starts, axis=0)
        rows, cols = rows[first], cols[first]
    return rows, cols, vals, dups


@_trace.traced("validate.coo")
def validate_coo(rows, cols, vals, shape, *, policy: str = "strict",
                 reduce: str = "add"):
    """Validate (and under ``repair``, canonicalize) a COO triple.

    Returns ``(rows, cols, vals, ValidationReport)``.  Strict raises
    :class:`InputError` on length mismatch, non-integer index dtype,
    out-of-range indices, or non-finite payloads (duplicates are legal
    COO — they combine under the reduce, same as scipy).  Repair drops
    out-of-range and non-finite entries, combines duplicates with the
    ``reduce`` ufunc (add matches scipy ``sum_duplicates`` bitwise),
    returns a row-major-sorted canonical triple, and canonicalizes the
    empty matrix to zero-length arrays.
    """
    _check_policy(policy)
    vals = np.asarray(vals)
    if policy == "off":
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        return rows, cols, vals, ValidationReport(
            policy=policy, nnz_in=int(np.size(rows)),
            nnz_out=int(np.size(rows)))
    if reduce not in _REDUCE_UFUNC:
        raise ValueError(f"unsupported reduce {reduce!r}; "
                         f"expected one of {sorted(_REDUCE_UFUNC)}")
    rows = _as_index_array(rows, "row", policy)
    cols = _as_index_array(cols, "col", policy)
    if len(shape) != 2 or shape[0] < 0 or shape[1] < 0:
        raise InputError(f"shape must be (m >= 0, n >= 0), got {shape!r}",
                         field="shape")
    if vals.ndim == 0:
        raise InputError(
            f"vals must be at least 1-D (one payload per entry), got a "
            f"0-d scalar ({vals})", field="vals")
    if not (rows.shape[0] == cols.shape[0] == vals.shape[0]):
        raise InputError(
            f"row/col/vals lengths differ: {rows.shape[0]}/"
            f"{cols.shape[0]}/{vals.shape[0]}", field="vals")
    nnz = int(rows.shape[0])
    m, n = int(shape[0]), int(shape[1])

    bad_rows = (rows < 0) | (rows >= m)
    bad_cols = (cols < 0) | (cols >= n)
    nonfinite = _nonfinite_mask(vals)
    if policy == "strict":
        if bad_rows.any():
            raise _strict_range_error("row", rows, bad_rows, m)
        if bad_cols.any():
            raise _strict_range_error("col", cols, bad_cols, n)
        if nonfinite is not None:
            raise _strict_finite_error("vals", vals, nonfinite)
        return rows, cols, vals, ValidationReport(
            policy=policy, nnz_in=nnz, nnz_out=nnz)

    # ---- repair: drop bad entries, combine duplicates, canonicalize
    drop = bad_rows | bad_cols
    oob = int(np.count_nonzero(drop))
    nf = 0
    if nonfinite is not None:
        nf = int(np.count_nonzero(nonfinite & ~drop))
        drop |= nonfinite
    if oob or nf:
        keep = ~drop
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    rows, cols, vals, dups = _combine_duplicates(rows, cols, vals, reduce)
    if rows.size == 0:
        # canonical empty matrix: well-defined dtypes, zero length
        rows = np.zeros(0, dtype=np.int64)
        cols = np.zeros(0, dtype=np.int64)
        vals = vals.reshape((0,) + vals.shape[1:])
    return rows, cols, vals, ValidationReport(
        policy=policy, nnz_in=nnz, nnz_out=int(rows.shape[0]),
        out_of_range_dropped=oob, nonfinite_dropped=nf,
        duplicates_combined=dups, canonicalized=True)


@_trace.traced("validate.csr")
def validate_csr(indptr, indices, vals, shape, *, policy: str = "strict",
                 reduce: str = "add"):
    """Validate a CSR triple; returns ``(indptr, indices, vals, report)``.

    Structural ``indptr`` defects — wrong length, non-monotone, first
    entry nonzero, last entry disagreeing with ``len(indices)`` — are
    raised as :class:`InputError` under EVERY policy except ``off``:
    there is no principled repair for a broken row partition, and
    expanding it with ``np.repeat`` produces garbage rows that fail far
    downstream (or worse, don't).  Per-entry defects (out-of-range
    columns, non-finite payloads, duplicates) follow the policy via
    :func:`validate_coo` on the expanded COO form; repair rebuilds a
    consistent ``indptr`` from the repaired rows.
    """
    _check_policy(policy)
    vals = np.asarray(vals)
    if policy == "off":
        return np.asarray(indptr), np.asarray(indices), vals, \
            ValidationReport(policy=policy, nnz_in=int(np.size(indices)),
                             nnz_out=int(np.size(indices)))
    indptr = _as_index_array(indptr, "indptr", policy)
    indices = _as_index_array(indices, "col", policy)
    if vals.ndim == 0:
        raise InputError(
            f"vals must be at least 1-D (one payload per entry), got a "
            f"0-d scalar ({vals})", field="vals")
    m = int(shape[0])
    if indptr.shape[0] != m + 1:
        raise InputError(
            f"indptr length {indptr.shape[0]} != num_rows + 1 = {m + 1}",
            field="indptr", count=1)
    if indptr.shape[0] and int(indptr[0]) != 0:
        raise InputError(f"indptr[0] = {int(indptr[0])} != 0",
                         field="indptr", indices=[0], count=1)
    steps = np.diff(indptr)
    neg = steps < 0
    if neg.any():
        idx, count = _first_offenders(neg)
        first = int(idx[0])
        raise InputError(
            f"indptr is not monotone: indptr[{first + 1}] = "
            f"{int(indptr[first + 1])} < indptr[{first}] = "
            f"{int(indptr[first])} ({count} descending step"
            f"{'' if count == 1 else 's'})",
            field="indptr", indices=idx + 1, count=count)
    if int(indptr[-1]) != indices.shape[0] or \
            indices.shape[0] != vals.shape[0]:
        raise InputError(
            f"indptr[-1] = {int(indptr[-1])} disagrees with "
            f"len(indices) = {indices.shape[0]} / len(vals) = "
            f"{vals.shape[0]}", field="indptr", count=1)
    rows = np.repeat(np.arange(m, dtype=indptr.dtype), steps)
    rows, cols, vals, report = validate_coo(rows, indices, vals, shape,
                                            policy=policy, reduce=reduce)
    if policy == "repair":
        counts = np.bincount(rows, minlength=m) if rows.size else \
            np.zeros(m, dtype=np.int64)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(
            indptr.dtype, copy=False)
        indices = cols
    return indptr, indices, vals, report


@_trace.traced("validate.edges")
def validate_edges(src, dst, num_nodes: int, weight=None, *,
                   policy: str = "strict"):
    """Validate a graph edge list; returns ``(src, dst, weight, report)``
    (``weight`` stays None when not given).

    Endpoints must lie in ``[0, num_nodes)``; weights, when present,
    must be finite (negative is legal — Bellman-Ford — but NaN/±Inf
    poison the (min, +) fixpoint: see DESIGN.md §9 on divergence
    detection).  Repair drops offending edges.  Duplicate edges are
    never touched: multi-edges are legitimate graph semantics (a
    duplicate contributes twice to a PageRank push, harmlessly re-relaxes
    under min).
    """
    _check_policy(policy)
    if policy == "off":
        w = None if weight is None else np.asarray(weight)
        src = np.asarray(src)
        return src, np.asarray(dst), w, ValidationReport(
            policy=policy, nnz_in=int(np.size(src)),
            nnz_out=int(np.size(src)))
    src = _as_index_array(src, "src", policy)
    dst = _as_index_array(dst, "dst", policy)
    if src.shape[0] != dst.shape[0]:
        raise InputError(f"src/dst lengths differ: {src.shape[0]}/"
                         f"{dst.shape[0]}", field="dst")
    weight_arr = None
    if weight is not None:
        weight_arr = np.asarray(weight)
        if weight_arr.ndim != 1 or weight_arr.shape[0] != src.shape[0]:
            raise InputError(
                f"weight must be 1-D of length {src.shape[0]}, got shape "
                f"{weight_arr.shape}", field="weight")
    nnz = int(src.shape[0])
    n = int(num_nodes)
    bad_src = (src < 0) | (src >= n)
    bad_dst = (dst < 0) | (dst >= n)
    nonfinite = None if weight_arr is None else _nonfinite_mask(weight_arr)
    if policy == "strict":
        if bad_src.any():
            raise _strict_range_error("src", src, bad_src, n)
        if bad_dst.any():
            raise _strict_range_error("dst", dst, bad_dst, n)
        if nonfinite is not None:
            raise _strict_finite_error("weight", weight_arr, nonfinite)
        return src, dst, weight_arr, ValidationReport(
            policy=policy, nnz_in=nnz, nnz_out=nnz)
    drop = bad_src | bad_dst
    oob = int(np.count_nonzero(drop))
    nf = 0
    if nonfinite is not None:
        nf = int(np.count_nonzero(nonfinite & ~drop))
        drop |= nonfinite
    if oob or nf:
        keep = ~drop
        src, dst = src[keep], dst[keep]
        if weight_arr is not None:
            weight_arr = weight_arr[keep]
    return src, dst, weight_arr, ValidationReport(
        policy=policy, nnz_in=nnz, nnz_out=int(src.shape[0]),
        out_of_range_dropped=oob, nonfinite_dropped=nf,
        canonicalized=bool(oob or nf))
