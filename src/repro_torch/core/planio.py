"""Plan serialization + content-addressed plan cache.

A port of the JAX package's ``core/planio.py`` with the same file layout,
so a plan file written by either package loads in the other and gives an
equal plan.

Persisting a BlockPlan lets the one-time analysis (feature table + class
binning + Data Transfer permutation) amortize across processes — the
offline analogue of the paper's runtime-JIT code cache.  The cache is
content-addressed: the key is a blake2b digest of the immutable access
arrays plus the CostModel (DESIGN.md §4), so a repeat matrix skips the
analysis entirely and a changed matrix or cost model can never alias a
stale plan.

Format: msgpack payload, zstd-compressed when ``zstandard`` is available
(a 5-byte magic header records which).  ``msgpack`` is required for
serialization; both imports are lazy so this module (and the plan cache
fall-through) works on a bare environment.

One behaviour differs from the reference: a file records only its seed's
name, and the registry rebuilds ``spmv`` with the ``add`` reduce, so a
cache hit in :func:`cached_build_plan` re-attaches the CALLER's seed (an
``SpMM`` with ``reduce="min"`` and an ``SpMV`` on the same matrix share one
plan file, and each keeps its own reduce).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
import warnings

import numpy as np

from repro_torch.core.plan import (BlockPlan, CostModel, PatternClass,
                                   PlanStats, build_plan)
from repro_torch.core import seed as seed_mod
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.obs.log import get_logger

_log = get_logger("repro_torch.plan_cache")

try:                                    # optional: smaller files when present
    import zstandard as _zstd
except ImportError:                     # pragma: no cover - env dependent
    _zstd = None

# v2 file layout: 5-byte magic + 16-byte blake2b checksum of the raw
# msgpack payload + body.  The checksum turns silent bit-rot (which could
# otherwise msgpack-parse into a structurally-plausible but WRONG plan)
# into a detected corruption -> cache rebuild.  v1 files (no checksum)
# are still readable; any *other* version magic is rejected, which the
# cache layer treats as "rebuild from scratch".
_MAGIC_ZSTD = b"IUP2Z"
_MAGIC_RAW = b"IUP2R"
_MAGIC_ZSTD_V1 = b"IUP1Z"
_MAGIC_RAW_V1 = b"IUP1R"
_CHECKSUM_BYTES = 16


def _payload_checksum(raw: bytes) -> bytes:
    return hashlib.blake2b(raw, digest_size=_CHECKSUM_BYTES).digest()

_ARRAYS = ("window_ids", "lane_slot", "lane_offset", "seg_ids",
           "gather_idx", "valid", "flat_perm", "head_pos", "head_rows")
_SCALARS = ("lane_width", "nnz", "out_len", "data_len", "num_blocks")

_SEEDS = {"spmv": seed_mod.spmv_seed, "pagerank_push": seed_mod.pagerank_seed}


def _msgpack():
    try:
        import msgpack
    except ImportError as e:            # pragma: no cover - env dependent
        raise RuntimeError(
            "plan serialization requires the optional 'msgpack' package "
            "(pip install msgpack)") from e
    return msgpack


def save_plan(path: str, plan: BlockPlan):
    msgpack = _msgpack()
    if plan.seed.name not in _SEEDS:
        raise ValueError(
            f"only registry seeds are serializable ({sorted(_SEEDS)}); "
            f"got {plan.seed.name!r} — register its factory in planio._SEEDS")
    payload = {
        "seed": plan.seed.name,
        "scalars": {k: getattr(plan, k) for k in _SCALARS},
        "classes": [(c.ls_flag, c.op_flag, c.stream, c.start, c.stop)
                    for c in plan.classes],
        "stats": dataclasses.asdict(plan.stats),
        "arrays": {k: {"dtype": str(getattr(plan, k).dtype),
                       "shape": list(getattr(plan, k).shape),
                       "data": np.ascontiguousarray(
                           getattr(plan, k)).tobytes()}
                   for k in _ARRAYS},
    }
    raw = msgpack.packb(payload, use_bin_type=True)
    check = _payload_checksum(raw)
    if _zstd is not None:
        blob = _MAGIC_ZSTD + check + \
            _zstd.ZstdCompressor(level=3).compress(raw)
    else:
        blob = _MAGIC_RAW + check + raw
    with open(path, "wb") as f:
        f.write(blob)


def _decompress(path: str, body: bytes) -> bytes:
    if _zstd is None:                   # pragma: no cover - env dependent
        raise RuntimeError(
            f"{path} is zstd-compressed but 'zstandard' is unavailable")
    return _zstd.ZstdDecompressor().decompress(body)


def _validate_payload(p: dict) -> None:
    """Structural consistency of a deserialized plan payload — a
    truncated or bit-flipped v1 file (no checksum) can parse into
    plausible-looking msgpack, and a wrong plan silently corrupts every
    result built on it, so the invariants the engine relies on are
    checked before a cached plan is accepted."""
    for req in ("seed", "scalars", "classes", "stats", "arrays"):
        if req not in p:
            raise ValueError(f"plan payload missing {req!r}")
    if p["seed"] not in _SEEDS:
        raise ValueError(f"unknown seed {p['seed']!r}")
    sc = p["scalars"]
    for req in _SCALARS:
        if req not in sc:
            raise ValueError(f"plan scalars missing {req!r}")
    b, n = int(sc["num_blocks"]), int(sc["lane_width"])
    arr = p["arrays"]
    for req in _ARRAYS:
        if req not in arr:
            raise ValueError(f"plan arrays missing {req!r}")
    shapes = {k: tuple(arr[k]["shape"]) for k in _ARRAYS}
    if shapes["flat_perm"] != (b * n,):
        raise ValueError(f"flat_perm shape {shapes['flat_perm']} != ({b*n},)")
    for k in ("lane_slot", "lane_offset", "seg_ids", "gather_idx", "valid"):
        if shapes[k] != (b, n):
            raise ValueError(f"{k} shape {shapes[k]} != ({b}, {n})")
    if shapes["head_pos"] != shapes["head_rows"]:
        raise ValueError("head_pos/head_rows length mismatch")
    classes = p["classes"]
    if not classes:
        raise ValueError("plan has no pattern classes")
    stops = [c[4] for c in classes]
    starts = [c[3] for c in classes]
    if starts[0] != 0 or stops[-1] != b or \
            any(a != s for a, s in zip(stops, starts[1:])):
        raise ValueError("pattern classes do not tile [0, num_blocks)")
    for k in _ARRAYS:
        want = np.prod(shapes[k], dtype=np.int64) * \
            np.dtype(arr[k]["dtype"]).itemsize
        if len(arr[k]["data"]) != want:
            raise ValueError(f"{k}: byte length {len(arr[k]['data'])} != "
                             f"{int(want)}")


def load_plan(path: str) -> BlockPlan:
    msgpack = _msgpack()
    with open(path, "rb") as f:
        blob = f.read()
    magic, rest = blob[:5], blob[5:]
    if magic in (_MAGIC_ZSTD, _MAGIC_RAW):
        check, body = rest[:_CHECKSUM_BYTES], rest[_CHECKSUM_BYTES:]
        raw = _decompress(path, body) if magic == _MAGIC_ZSTD else body
        if _payload_checksum(raw) != check:
            raise ValueError(f"{path}: checksum mismatch (corrupt plan file)")
    elif magic in (_MAGIC_ZSTD_V1, _MAGIC_RAW_V1):
        raw = _decompress(path, rest) if magic == _MAGIC_ZSTD_V1 else rest
    elif blob[:4] == b"\x28\xb5\x2f\xfd":
        # legacy format: the whole file is one bare zstd frame
        raw = _decompress(path, blob)
    else:
        raise ValueError(f"{path}: not a readable plan file "
                         f"(magic {magic!r}; this build reads "
                         f"{_MAGIC_RAW.decode()}/{_MAGIC_RAW_V1.decode()} "
                         "families)")
    p = msgpack.unpackb(raw, raw=False, strict_map_key=False)
    _validate_payload(p)
    # writable copies: torch.as_tensor shares a CPU array's memory, and a
    # read-only buffer under a tensor is undefined behaviour
    arrays = {k: np.frombuffer(v["data"], dtype=v["dtype"]).reshape(
        v["shape"]).copy() for k, v in p["arrays"].items()}
    classes = [PatternClass(*c) for c in p["classes"]]
    st = p["stats"]
    st["ls_hist"] = {int(k): v for k, v in st["ls_hist"].items()}
    st["op_hist"] = {int(k): v for k, v in st["op_hist"].items()}
    stats = PlanStats(**st)
    return BlockPlan(seed=_SEEDS[p["seed"]](), classes=classes, stats=stats,
                     **p["scalars"], **arrays)


# --------------------------------------------------- content-addressed cache
_FP_MULT_CACHE: dict = {}


def _fp_multipliers(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Position-multiplier streams for :func:`_array_fingerprint`, cached by
    length (access arrays of one matrix share a length, and repeat lookups
    are the whole point of the cache)."""
    from repro_torch.core import feature_table as ft
    hit = _FP_MULT_CACHE.get(n)
    if hit is None:
        with np.errstate(over="ignore"):
            pos = ft._mix64(np.arange(1, n + 1, dtype=np.uint64))
            hit = (pos | np.uint64(1), ft._mix64(pos) | np.uint64(1))
        _FP_MULT_CACHE.clear()          # keep at most one length resident
        _FP_MULT_CACHE[n] = hit
    return hit


def _array_fingerprint(a: np.ndarray) -> bytes:
    """128-bit position-sensitive multilinear fingerprint of an int array,
    computed at numpy memory bandwidth (hashing the raw bytes through a
    cryptographic digest costs more than the whole warm cache hit).  Two
    independent 64-bit multilinear sums give ~2^-128 pairwise collision
    probability — content-addressing quality in a non-adversarial setting
    (DESIGN.md §4)."""
    v = np.ascontiguousarray(a, dtype=np.int64).view(np.uint64)
    m1, m2 = _fp_multipliers(v.size)
    with np.errstate(over="ignore"):
        h1 = (v * m1).sum(dtype=np.uint64)
        h2 = (v * m2).sum(dtype=np.uint64)
    return np.array([h1, h2, np.uint64(v.size)], dtype=np.uint64).tobytes()


def array_fingerprint(a: np.ndarray) -> bytes:
    """Public alias of the 128-bit access-array fingerprint — shared by
    the plan cache key and the tuning cache key (repro_torch.tune.cache), so
    both caches agree on what "the same matrix" means."""
    return _array_fingerprint(a)


def plan_digest(seed_name: str, access: dict, out_len: int, data_len: int,
                cost: CostModel) -> str:
    """Cache key: digest of everything ``build_plan`` consumes, so two
    logically-equal matrices share a plan and any change misses."""
    h = hashlib.blake2b(digest_size=16)
    h.update(f"planio.v2|{seed_name}|{out_len}|{data_len}|"
             f"{cost.lane_width}|{cost.window_cutoff}|"
             f"{cost.elem_bytes}|{cost.idx_bytes}".encode())
    for k in sorted(access):
        h.update(f"|{k}|".encode())
        h.update(_array_fingerprint(access[k]))
    return h.hexdigest()


def cached_build_plan(seed, access: dict, out_len: int, data_len: int,
                      cost: CostModel | None = None,
                      cache_dir: str | None = None) -> BlockPlan:
    """:func:`build_plan` behind the content-addressed cache.

    With ``cache_dir`` set, a repeat (access, cost) pair loads the stored
    plan instead of re-running the analysis.  Falls through to a plain
    build when caching is impossible (no msgpack, unregistered seed) or
    the cached file is unreadable — a cache must never change results.
    """
    cost = cost or CostModel()
    if cache_dir is None or seed.name not in _SEEDS:
        return build_plan(seed, access, out_len, data_len, cost=cost)
    try:
        _msgpack()
    except RuntimeError:
        return build_plan(seed, access, out_len, data_len, cost=cost)
    from repro_torch.core import validate as vmod
    digest = plan_digest(seed.name, access, out_len, data_len, cost)
    path = os.path.join(cache_dir, f"{seed.name}-{digest}.plan")
    with _trace.span("plan_cache.lookup", digest=digest) as sp:
        if os.path.exists(path):
            try:
                plan = dataclasses.replace(load_plan(path), seed=seed)
                _metrics.inc("plan_cache.hits")
                sp.set(outcome="hit")
                return plan
            except Exception as e:
                # corrupt / truncated / torn / other-version entry: warn,
                # drop the bad file, and rebuild — a cache may only skip
                # work, never crash the build or change its result.
                _metrics.inc("plan_cache.corrupt")
                sp.set(outcome="corrupt")
                vmod.record_degradation(
                    "plan_cache", "corrupt_entry", f"{path}: {e!r}",
                    "rebuild from scratch + republish")
                _log.warning("plan cache entry %s unreadable (%r); "
                             "rebuilding plan from scratch", path, e)
                warnings.warn(f"plan cache entry {path} unreadable "
                              f"({e!r}); rebuilding plan from scratch",
                              RuntimeWarning)
                try:
                    os.unlink(path)
                except OSError:         # pragma: no cover - racing unlink
                    pass
        else:
            _metrics.inc("plan_cache.misses")
            sp.set(outcome="miss")
    plan = build_plan(seed, access, out_len, data_len, cost=cost)
    # unwritable dir (EROFS, EACCES, ENOSPC, quota): the plan is already
    # built — degrade to in-memory use with ONE warning per dir + a
    # recorded DegradationEvent instead of raising out of the build
    tmp = None
    with _trace.span("plan_cache.publish", digest=digest) as sp:
        try:
            os.makedirs(cache_dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
            os.close(fd)
            save_plan(tmp, plan)
            os.replace(tmp, path)       # atomic publish
            _metrics.inc("plan_cache.stores")
        except OSError as e:
            _metrics.inc("plan_cache.write_failed")
            sp.set(outcome="write_failed")
            vmod.record_degradation(
                "plan_cache", "write_failed", f"{cache_dir}: {e!r}",
                "in-memory plan (no persistence)")
            vmod.warn_once(("plan_cache_write", cache_dir),
                           f"plan cache dir {cache_dir} is unwritable "
                           f"({e!r}); plans will be rebuilt each process",
                           logger="repro_torch.plan_cache")
        finally:
            try:
                if tmp is not None and os.path.exists(tmp):
                    os.unlink(tmp)
            except OSError:             # pragma: no cover - EROFS cleanup
                pass
    return plan
