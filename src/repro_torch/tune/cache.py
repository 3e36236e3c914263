"""Persistent tuning cache: warm processes skip re-measurement.

A port of the JAX package's ``tune/cache.py``.  The tuned choice is a
property of (matrix, seed, platform, toolchain, device, candidate menu) —
nothing else.  The cache key is therefore a blake2b digest over exactly
those fields:

* the 128-bit position-sensitive multilinear fingerprint of every
  immutable access array (:func:`repro_torch.core.planio.array_fingerprint`
  — the same content-addressing the plan cache uses, so two logically
  equal matrices share a tuning entry and any content/permutation change
  misses),
* the seed signature (name + reduce op) and the output/data lengths,
* the platform (``cpu``/``cuda``), ``torch.__version__``,
  ``torch.version.cuda``, the device's name (``"cpu"`` off the card) and
  the number of CUDA devices — a choice measured on one card, driver
  stack or PyTorch release must never be replayed on another (these
  replace the reference's framework version and device count),
* the candidate-space signature, so widening the menu re-tunes.

Entries are human-readable JSON (no optional deps), published with the
temp-file + ``os.replace`` atomic-rename idiom; a corrupt or
schema-mismatched entry is discarded with a warning and re-tuned — the
cache can only skip measurements, never change the chosen semantics.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import warnings

import torch

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.obs.log import get_logger

_log = get_logger("repro_torch.tune_cache")

SCHEMA = "tune.v2"


def device_identity(platform: str, device=None) -> str:
    """The toolchain and device fields of the key: the torch and CUDA
    versions, the device's name (``"cpu"`` off the card) and the number
    of CUDA devices."""
    name = (torch.cuda.get_device_name(device) if platform == "cuda"
            else "cpu")
    return (f"torch{torch.__version__}|cuda{torch.version.cuda}|{name}|"
            f"ndev{torch.cuda.device_count()}")


def tuning_key(seed_name: str, reduce: str, access: dict, out_len: int,
               data_len: int, platform: str, space_sig: str,
               extra: str = "", device=None) -> str:
    from repro_torch.core import planio
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{SCHEMA}|{seed_name}|{reduce}|{out_len}|{data_len}|"
             f"{platform}|{device_identity(platform, device)}|"
             f"{space_sig}|{extra}".encode())
    for k in sorted(access):
        h.update(f"|{k}|".encode())
        h.update(planio.array_fingerprint(access[k]))
    return h.hexdigest()


def entry_path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"tune-{key}.json")


def load_entry(cache_dir: str, key: str) -> dict | None:
    """The stored tuning decision, or None (miss / unreadable / other
    schema).  Never raises: a cache problem costs a re-tune, not a run."""
    from repro_torch.core import validate as vmod
    path = entry_path(cache_dir, key)
    with _trace.span("tune_cache.lookup", key=key) as sp:
        if not os.path.exists(path):
            _metrics.inc("tune_cache.misses")
            sp.set(outcome="miss")
            return None
        try:
            with open(path, "r") as f:
                entry = json.load(f)
            if entry.get("schema") != SCHEMA or "choice" not in entry:
                raise ValueError(
                    f"schema {entry.get('schema')!r} != {SCHEMA}")
            _metrics.inc("tune_cache.hits")
            sp.set(outcome="hit")
            return entry
        except Exception as e:
            _metrics.inc("tune_cache.corrupt")
            sp.set(outcome="corrupt")
            vmod.record_degradation("tune_cache", "corrupt_entry",
                                    f"{path}: {e!r}", "re-tune + republish")
            _log.warning("tuning cache entry %s unreadable (%r); "
                         "re-tuning", path, e)
            warnings.warn(f"tuning cache entry {path} unreadable ({e!r}); "
                          "re-tuning", RuntimeWarning)
            try:
                os.unlink(path)
            except OSError:
                pass
            return None


def store_entry(cache_dir: str, key: str, payload: dict) -> None:
    """Atomic publish (write-to-temp + rename): concurrent tuners of the
    same matrix race benignly — last writer wins with a complete file.

    An unwritable dir (EROFS, EACCES, ENOSPC) degrades to not persisting
    the decision — one warning per dir plus a recorded
    :class:`~repro_torch.core.validate.DegradationEvent`, never an exception:
    losing a cache entry costs a future re-tune, raising loses the tuning
    result that was just computed."""
    from repro_torch.core import validate as vmod
    payload = {"schema": SCHEMA, "key": key, **payload}
    tmp = None
    try:
        with _trace.span("tune_cache.publish", key=key):
            os.makedirs(cache_dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, entry_path(cache_dir, key))
        _metrics.inc("tune_cache.stores")
    except OSError as e:
        _metrics.inc("tune_cache.write_failed")
        vmod.record_degradation(
            "tune_cache", "write_failed", f"{cache_dir}: {e!r}",
            "tuning decision not persisted (re-tune next process)")
        vmod.warn_once(("tune_cache_write", cache_dir),
                       f"tuning cache dir {cache_dir} is unwritable "
                       f"({e!r}); decisions will not persist",
                       logger="repro_torch.tune_cache")
    finally:
        try:
            if tmp is not None and os.path.exists(tmp):
                os.unlink(tmp)
        except OSError:                 # pragma: no cover - EROFS cleanup
            pass
