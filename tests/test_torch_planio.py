"""``repro_torch.core.planio`` against the reference's ``repro.core.planio``.

* The file layout is the reference's: a plan file written by one package
  loads in the other and gives an equal plan, both plan caches find each
  other's entries, and ``plan_digest`` / ``array_fingerprint`` are equal.
* Mirrors of ``tests/test_planio_robust.py``: corrupt, truncated or
  other-version entries fall back to a fresh ``build_plan`` with a
  warning; a v1 file (no checksum) still loads; the structural validator
  rejects inconsistent payloads; a corrupt entry never shadows another
  matrix's slot.
* The app surfaces' ``plan_cache_dir=``: a second build is a cache hit
  with a bitwise-equal result, and a hit keeps the caller's seed (the
  reference replays an ``add`` seed into a ``min`` SpMM).
"""
import copy
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.core import planio as rplanio
from repro.core.plan import CostModel as RCostModel
from repro.core.plan import build_plan as rbuild_plan
from repro.core.seed import pagerank_seed as rpagerank_seed
from repro.core.seed import spmv_seed as rspmv_seed
from repro.sparse import generators as RG

from repro_torch.core import graphs as GR
from repro_torch.core.apps import PageRank, SpMV
from repro_torch.core.plan import CostModel, build_plan
from repro_torch.core.seed import pagerank_seed, spmv_seed
from repro_torch.core.spmm import SpMM
from repro_torch.obs import metrics
from repro_torch.sparse import generators as G

pytest.importorskip("msgpack")

from repro_torch.core import planio  # noqa: E402

_ARRAYS = ("window_ids", "lane_slot", "lane_offset", "seg_ids",
           "gather_idx", "valid", "flat_perm", "head_pos", "head_rows")
FAMILIES = {"banded": lambda g: g.banded(300, band=5),
            "power_law": lambda g: g.power_law(512, 6),
            "dense": lambda g: g.dense(40)}


def _assert_same_plan(a, b):
    for k in _ARRAYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
        assert getattr(a, k).dtype == getattr(b, k).dtype, k
    for k in ("lane_width", "nnz", "out_len", "data_len", "num_blocks"):
        assert getattr(a, k) == getattr(b, k), k
    assert [dataclasses.astuple(c) for c in a.classes] == \
        [dataclasses.astuple(c) for c in b.classes]
    assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)
    assert a.seed.name == b.seed.name and a.seed.reduce == b.seed.reduce


def _access(m):
    return {"row": np.asarray(m.rows), "col": np.asarray(m.cols)}


# ------------------------------------------------- across the two packages
@pytest.mark.parametrize("lane", [8, 32])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_files_cross_load_between_packages(family, lane, tmp_path):
    m = FAMILIES[family](RG)
    rplan = rbuild_plan(rspmv_seed(), _access(m), *m.shape,
                        RCostModel(lane_width=lane))
    plan = build_plan(spmv_seed(), _access(m), *m.shape,
                      CostModel(lane_width=lane))
    planio.save_plan(str(tmp_path / "port.plan"), plan)
    rplanio.save_plan(str(tmp_path / "ref.plan"), rplan)
    assert (tmp_path / "port.plan").read_bytes() == \
        (tmp_path / "ref.plan").read_bytes()
    _assert_same_plan(rplanio.load_plan(str(tmp_path / "port.plan")), rplan)
    _assert_same_plan(planio.load_plan(str(tmp_path / "ref.plan")), plan)


def test_pagerank_plan_cross_loads(tmp_path):
    src, dst, nn = RG.graph_edges("powerlaw", 256, 6, seed=3)
    access = {"n2": dst, "n1": src}
    rplan = rbuild_plan(rpagerank_seed(), access, nn, nn,
                        RCostModel(lane_width=16))
    rplanio.save_plan(str(tmp_path / "ref.plan"), rplan)
    got = planio.load_plan(str(tmp_path / "ref.plan"))
    _assert_same_plan(got, build_plan(pagerank_seed(), access, nn, nn,
                                      CostModel(lane_width=16)))
    assert got.seed.kernel_combine == "mul_all"


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_digests_and_fingerprints_equal(family):
    m = FAMILIES[family](RG)
    acc = _access(m)
    for lane, cut in ((8, None), (128, 3)):
        assert planio.plan_digest("spmv", acc, *m.shape,
                                  CostModel(lane_width=lane,
                                            max_windows_replace=cut)) == \
            rplanio.plan_digest("spmv", acc, *m.shape,
                                RCostModel(lane_width=lane,
                                           max_windows_replace=cut))
    for k in acc:
        assert planio.array_fingerprint(acc[k]) == \
            rplanio.array_fingerprint(acc[k])


def test_caches_share_entries(tmp_path):
    m = RG.power_law(512, 6)
    d = str(tmp_path)
    rplan = rplanio.cached_build_plan(rspmv_seed(), _access(m), *m.shape,
                                      RCostModel(lane_width=32), cache_dir=d)
    hits = metrics.value("plan_cache.hits")
    plan = planio.cached_build_plan(spmv_seed(), _access(m), *m.shape,
                                    CostModel(lane_width=32), cache_dir=d)
    assert metrics.value("plan_cache.hits") == hits + 1
    assert len(list(tmp_path.iterdir())) == 1
    _assert_same_plan(plan, build_plan(spmv_seed(), _access(m), *m.shape,
                                       CostModel(lane_width=32)))
    _assert_same_plan(rplanio.cached_build_plan(
        rspmv_seed(), _access(m), *m.shape, RCostModel(lane_width=32),
        cache_dir=d), rplan)


# --------------------------------- mirrors of tests/test_planio_robust.py
@pytest.fixture
def cached(tmp_path):
    m = G.power_law(512, 6)
    args = (spmv_seed(), _access(m), m.shape[0], m.shape[1],
            CostModel(lane_width=32))
    plan = planio.cached_build_plan(*args, cache_dir=str(tmp_path))
    [path] = list(tmp_path.iterdir())
    return args, str(tmp_path), path, plan


def _expect_rebuild(args, cache_dir, reference_plan):
    with pytest.warns(RuntimeWarning, match="rebuilding"):
        plan = planio.cached_build_plan(*args, cache_dir=cache_dir)
    _assert_same_plan(plan, reference_plan)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        plan2 = planio.cached_build_plan(*args, cache_dir=cache_dir)
    _assert_same_plan(plan2, reference_plan)


def test_bitflipped_entry_falls_back_to_rebuild(cached):
    args, d, path, plan = cached
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    path.write_bytes(bytes(blob))
    _expect_rebuild(args, d, plan)


def test_bitflipped_checksum_falls_back_to_rebuild(cached):
    args, d, path, plan = cached
    blob = bytearray(path.read_bytes())
    blob[5] ^= 0x01
    path.write_bytes(bytes(blob))
    _expect_rebuild(args, d, plan)


@pytest.mark.parametrize("keep", [0, 4, 21, 0.5])
def test_truncated_entry_falls_back_to_rebuild(cached, keep):
    args, d, path, plan = cached
    blob = path.read_bytes()
    n = int(len(blob) * keep) if isinstance(keep, float) else keep
    path.write_bytes(blob[:n])
    _expect_rebuild(args, d, plan)


def test_other_version_magic_falls_back_to_rebuild(cached):
    args, d, path, plan = cached
    path.write_bytes(b"IUP9Z" + path.read_bytes()[5:])
    _expect_rebuild(args, d, plan)


def test_load_plan_raises_on_checksum_mismatch(cached):
    _, _, path, _ = cached
    blob = bytearray(path.read_bytes())
    blob[-1] ^= 0x40
    path.write_bytes(bytes(blob))
    with pytest.raises(Exception):
        planio.load_plan(str(path))


def test_v1_entry_without_checksum_still_loads(cached):
    _, _, path, plan = cached
    blob = path.read_bytes()
    magic = blob[:5]
    assert magic in (b"IUP2Z", b"IUP2R")
    v1 = b"IUP1Z" if magic == b"IUP2Z" else b"IUP1R"
    path.write_bytes(v1 + blob[5 + planio._CHECKSUM_BYTES:])
    _assert_same_plan(planio.load_plan(str(path)), plan)
    _assert_same_plan(rplanio.load_plan(str(path)), plan)


def test_validate_payload_catches_structural_corruption(cached):
    import msgpack
    _, _, path, _ = cached
    blob = path.read_bytes()
    raw = blob[5 + planio._CHECKSUM_BYTES:]
    if blob[:5] == b"IUP2Z":
        import zstandard
        raw = zstandard.ZstdDecompressor().decompress(raw)
    payload = msgpack.unpackb(raw, raw=False, strict_map_key=False)
    planio._validate_payload(payload)
    bad = copy.deepcopy(payload)
    bad["scalars"]["num_blocks"] += 1
    with pytest.raises(ValueError):
        planio._validate_payload(bad)
    bad = copy.deepcopy(payload)
    bad["classes"][0][4] += 1
    with pytest.raises(ValueError):
        planio._validate_payload(bad)
    bad = copy.deepcopy(payload)
    bad["arrays"]["flat_perm"]["data"] = \
        bad["arrays"]["flat_perm"]["data"][:-8]
    with pytest.raises(ValueError):
        planio._validate_payload(bad)
    bad = copy.deepcopy(payload)
    del bad["arrays"]["head_rows"]
    with pytest.raises(ValueError):
        planio._validate_payload(bad)


def test_unreadable_entry_never_crosses_digests(cached):
    args, d, path, plan = cached
    m2 = G.banded(256, 3)
    args2 = (spmv_seed(), _access(m2), m2.shape[0], m2.shape[1],
             CostModel(lane_width=32))
    plan2 = planio.cached_build_plan(*args2, cache_dir=d)
    path.write_bytes(b"garbage")
    with pytest.warns(RuntimeWarning):
        p1 = planio.cached_build_plan(*args, cache_dir=d)
    _assert_same_plan(p1, plan)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        p2 = planio.cached_build_plan(*args2, cache_dir=d)
    _assert_same_plan(p2, plan2)


# ------------------------------------------------------ the app surfaces
def test_spmv_and_pagerank_plan_cache_hits_bitwise(tmp_path):
    m = G.power_law(512, 6)
    d = str(tmp_path)
    x = np.random.default_rng(0).standard_normal(m.shape[1]).astype(
        np.float32)
    ys = []
    for _ in range(2):
        hits = metrics.value("plan_cache.hits")
        sp = SpMV.from_coo(m.rows, m.cols, m.vals, m.shape, lane_width=16,
                           backend="cuda", plan_cache_dir=d, device="cpu")
        ys.append((metrics.value("plan_cache.hits") - hits, sp.matvec(x)))
    assert [h for h, _ in ys] == [0, 1]
    assert torch.equal(ys[0][1], ys[1][1])
    src, dst, nn = G.graph_edges("powerlaw", 256, 6, seed=3)
    ranks = [PageRank.from_edges(src, dst, nn, lane_width=16,
                                 plan_cache_dir=d, device="cpu").run(5)
             for _ in range(2)]
    assert torch.equal(ranks[0], ranks[1])
    assert len(list(tmp_path.iterdir())) == 2


def test_cache_hit_keeps_the_callers_seed(tmp_path):
    """A plan file records only its seed's name, and ``spmv`` rebuilds with
    the add reduce; the port re-attaches the caller's seed on a hit, so a
    ``min`` SpMM sharing an ``add`` SpMV's plan file stays a ``min``."""
    m = G.banded(256, 3)
    d = str(tmp_path)
    b = np.random.default_rng(1).standard_normal((m.shape[1], 2)).astype(
        np.float32)
    want = SpMM.from_coo(m.rows, m.cols, m.vals, m.shape, lane_width=16,
                         reduce="min", device="cpu").matmat(b)
    SpMV.from_coo(m.rows, m.cols, m.vals, m.shape, lane_width=16,
                  plan_cache_dir=d, device="cpu")
    got = SpMM.from_coo(m.rows, m.cols, m.vals, m.shape, lane_width=16,
                        reduce="min", plan_cache_dir=d, device="cpu")
    assert got.plan.seed.reduce == "min"
    assert torch.equal(got.matmat(b), want)


def test_unregistered_seed_and_missing_msgpack_build_uncached(tmp_path,
                                                              monkeypatch):
    c = G.graph_case("uniform", 128, 4, seed=2)
    bfs = GR.BFS.from_edges(c.src, c.dst, c.num_nodes, lane_width=16,
                            plan_cache_dir=str(tmp_path), device="cpu")
    np.testing.assert_array_equal(
        bfs.run(0).numpy(), GR.bfs_reference(c.src, c.dst, c.num_nodes, 0))
    assert not list(tmp_path.iterdir())     # graph seeds are not registry

    def no_msgpack():
        raise RuntimeError("plan serialization requires msgpack")
    monkeypatch.setattr(planio, "_msgpack", no_msgpack)
    m = G.banded(128, 3)
    plan = planio.cached_build_plan(spmv_seed(), _access(m), *m.shape,
                                    CostModel(lane_width=8),
                                    cache_dir=str(tmp_path))
    _assert_same_plan(plan, build_plan(spmv_seed(), _access(m), *m.shape,
                                       CostModel(lane_width=8)))
    assert not list(tmp_path.iterdir())
