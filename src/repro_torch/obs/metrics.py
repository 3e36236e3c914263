"""Process-wide metrics registry: counters, gauges, and histograms.

The same registry as the JAX package's ``obs.metrics``; the counters the
ported pipeline touches are:

* ``plan.builds`` / ``plan.build_seconds`` — feature-analysis runs
* ``degradation.events`` + ``degradation.<layer>.<kind>`` — one counter
  per degradation rung, incremented by ``validate.record_degradation``

Everything is name-keyed and created on first touch; ``snapshot()``
returns plain dicts and ``reset()`` zeroes the registry, so tests can
assert on deltas without ordering constraints.  All operations take one
process lock — these are cold-path events (builds, cache probes,
measured rounds), never per-lane work.
"""
from __future__ import annotations

import threading

__all__ = ["inc", "set_gauge", "observe", "value", "gauge_value",
           "histogram_value", "snapshot", "reset"]

_lock = threading.Lock()
_counters: dict[str, float] = {}
_gauges: dict[str, float] = {}
_hists: dict[str, dict] = {}


def inc(name: str, n: float = 1) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def set_gauge(name: str, v: float) -> None:
    with _lock:
        _gauges[name] = v


def observe(name: str, v: float) -> None:
    """Record one sample into a streaming histogram (count/sum/min/max
    — enough for means and extremes without bucket configuration)."""
    v = float(v)
    with _lock:
        h = _hists.get(name)
        if h is None:
            _hists[name] = {"count": 1, "sum": v, "min": v, "max": v}
        else:
            h["count"] += 1
            h["sum"] += v
            h["min"] = min(h["min"], v)
            h["max"] = max(h["max"], v)


def value(name: str, default: float = 0) -> float:
    """Current value of a counter (0 when never incremented)."""
    with _lock:
        return _counters.get(name, default)


def gauge_value(name: str, default: float = 0) -> float:
    with _lock:
        return _gauges.get(name, default)


def histogram_value(name: str) -> dict | None:
    with _lock:
        h = _hists.get(name)
        return dict(h) if h else None


def snapshot() -> dict:
    """Deep-copied view of the whole registry: ``{"counters": {...},
    "gauges": {...}, "histograms": {name: {count,sum,min,max,mean}}}``."""
    with _lock:
        hists = {}
        for name, h in _hists.items():
            hists[name] = dict(h, mean=h["sum"] / h["count"])
        return {"counters": dict(_counters), "gauges": dict(_gauges),
                "histograms": hists}


def reset() -> None:
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()
