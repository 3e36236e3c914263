"""``repro_torch.tune`` and the ``backend="segsum"`` emitter, against the
reference's ``repro.tune`` and ``segsum`` / ``baseline_gather`` emitters.

* The candidate space equals the reference's, names mapped (``torch`` for
  ``jax``, ``cuda`` for ``pallas``), in order, for every seed: on ``"cpu"``
  against the reference's ``"cpu"``, on ``"cuda"`` against its ``"gpu"``.
* ``plan_features`` equal the reference's field for field; on ``"cpu"``
  every ``predict_us`` and every ranking is exactly equal; on ``"cuda"`` the
  torch/segsum rows equal the reference's ``"gpu"`` rows and each cuda row
  is the reference's ``"tpu"`` pallas row with ``PALLAS_TPU_SCALE``
  replaced by ``CUDA_SCALE``.
* Mirrors of ``tests/test_tune.py``: validity rules, signatures, ranking,
  oracle-checked measurement, the warm cache hit with zero measurements,
  force / corrupt-entry recovery, key sensitivity (plus the torch version
  and the device name), and the app-level ``backend="auto"`` surfaces.
* Auto-built SpMV, SpMM, PageRank, BFS, SSSP and CC stay within the
  reference's rule of its fixed-backend result: exact for int32 and
  min/max, ``allclose(rtol=1e-5, atol=1e-6)`` for float add/mul.
* ``segsum`` and ``baseline_gather`` agree with the reference's under the
  same rule, for all four reduces; the port's segsum float add rounds once
  (float64 accumulation), so it is also within one ulp of the exact sum
  of its terms, where the reference's float32 sum is not.

Everything runs on the CPU (``device="cpu"``), at lane widths 8 and 16.
"""
import dataclasses
import functools
import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tune as RT
from repro.core import apps as rapps
from repro.core import engine as reng
from repro.core import graphs as rgraphs
from repro.core import seed as rseed
from repro.core.plan import CostModel as RCostModel
from repro.core.plan import build_plan as rbuild_plan
from repro.core.spmm import SpMM as RSpMM
from repro.sparse import generators as RG
from repro.tune import cost as rcost
from repro.tune import space as rspace

from repro_torch import tune as T
from repro_torch.core import engine as eng
from repro_torch.core import graphs as GR
from repro_torch.core import seed as pseed
from repro_torch.core.apps import PageRank, SpMV, pagerank_reference
from repro_torch.core.plan import CostModel, build_plan
from repro_torch.core.spmm import SpMM
from repro_torch.sparse import generators as G
from repro_torch.tune import cache as tcache
from repro_torch.tune import cost as tcost
from repro_torch.tune import space as tspace
from repro_torch.tune.space import Candidate

REF_BACKEND = {"torch": "jax", "segsum": "segsum", "cuda": "pallas"}
SEEDS = {
    "spmv_add": (lambda: pseed.spmv_seed("add"),
                 lambda: rseed.spmv_seed("add")),
    "spmv_mul": (lambda: pseed.spmv_seed("mul"),
                 lambda: rseed.spmv_seed("mul")),
    "spmv_min": (lambda: pseed.spmv_seed("min"),
                 lambda: rseed.spmv_seed("min")),
    "spmv_max": (lambda: pseed.spmv_seed("max"),
                 lambda: rseed.spmv_seed("max")),
    "pagerank": (pseed.pagerank_seed, rseed.pagerank_seed),
    "bfs": (pseed.bfs_seed, rgraphs.bfs_seed),
    "sssp": (pseed.sssp_seed, rgraphs.sssp_seed),
    "cc": (pseed.cc_seed, rgraphs.cc_seed),
}
FAMILIES = {"banded": lambda g: g.banded(300, band=5),
            "power_law": lambda g: g.power_law(2048, 8),
            "random_uniform": lambda g: g.random_uniform(300, 5),
            "dense": lambda g: g.dense(40)}
SEMIRINGS = [("add", np.float32), ("mul", np.float32), ("min", np.int32),
             ("max", np.int32)]


def _mapped(c: Candidate) -> dict:
    return dict(c.to_dict(), backend=REF_BACKEND[c.backend])


def _assert_rule(got, want, reduce="add", dtype=np.float32):
    if np.issubdtype(np.dtype(dtype), np.integer) or reduce in ("min", "max"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _plans(family, lane):
    m = FAMILIES[family](RG)
    access = {"row": np.asarray(m.rows), "col": np.asarray(m.cols)}
    return (rbuild_plan(rseed.spmv_seed(), access, m.shape[0], m.shape[1],
                        RCostModel(lane_width=lane)),
            build_plan(pseed.spmv_seed(), access, m.shape[0], m.shape[1],
                       CostModel(lane_width=lane)))


def _coo(seed_int=0, nnz=800, out_len=64, data_len=256):
    rng = np.random.default_rng(seed_int)
    rows = rng.integers(0, out_len, nnz)
    cols = rng.integers(0, data_len, nnz)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return rows, cols, vals, out_len, data_len


def _autotune_spmv(rows, cols, vals, out_len, data_len, **kw):
    x = torch.as_tensor(np.random.default_rng(9).standard_normal(
        data_len).astype(np.float32))
    return T.autotune(pseed.spmv_seed(), {"row": rows, "col": cols},
                      out_len, data_len, {"value": vals}, {"x": x},
                      torch.zeros(out_len), iters=3, **kw), x


# ------------------------------------------------- space vs the reference
@pytest.mark.parametrize("interp", [False, True])
@pytest.mark.parametrize("seed", sorted(SEEDS))
def test_candidate_space_cpu_equals_reference(seed, interp):
    port, ref = SEEDS[seed]
    got = tspace.candidate_space(port(), platform="cpu",
                                 allow_interpret=interp)
    want = rspace.candidate_space(ref(), platform="cpu",
                                  allow_interpret=interp)
    assert [_mapped(c) for c in got] == [c.to_dict() for c in want]
    assert [c.label for c in got] == [
        c.label.replace("jax/", "torch/", 1).replace("pallas/", "cuda/", 1)
        for c in want]
    if not interp:
        assert len(got) == 9           # every seed's reduce has a segsum
        assert sum(c.backend == "segsum" for c in got) == 1


@pytest.mark.parametrize("seed", sorted(SEEDS))
def test_candidate_space_cuda_equals_reference_gpu(seed):
    port, ref = SEEDS[seed]
    got = tspace.candidate_space(port(), platform="cuda")
    want = rspace.candidate_space(ref(), platform="gpu")
    assert [_mapped(c) for c in got] == [c.to_dict() for c in want]
    assert len(got) == 25 and all(c.kernel_prefetch is None for c in got)
    assert {c.kernel_rows for c in got if c.backend == "cuda"} == {None, 8}


def test_segsum_validity_per_reduce():
    for reduce in ("add", "mul", "min", "max"):
        for platform, ref_platform in (("cpu", "cpu"), ("cuda", "gpu")):
            c = Candidate(backend="segsum")
            assert tspace.is_valid(c, pseed.spmv_seed(reduce), platform) == \
                rspace.is_valid(dataclasses.replace(
                    rspace.Candidate(), backend="segsum"),
                    rseed.spmv_seed(reduce), ref_platform)


def test_shard_axis_is_not_ported():
    """The shard axis is ported and capped at the device count: on the one
    CPU a count above 1 leaves the space unless the mesh is simulated, and
    a ``cuda`` candidate is never sharded."""
    assert all(c.shards == 1 for c in tspace.candidate_space(
        pseed.spmv_seed(), platform="cpu", shard_counts=(1, 2)))
    rows, cols, vals, out_len, data_len = _coo(0)
    (_, _, result), _ = _autotune_spmv(rows, cols, vals, out_len,
                                       data_len, shard_counts=(1, 2))
    assert all(m.candidate.shards == 1 for m in result.measurements)
    assert not tspace.is_valid(Candidate(shards=2), pseed.spmv_seed(), "cpu")
    assert tspace.is_valid(Candidate(shards=2), pseed.spmv_seed(), "cpu",
                           devices=2)
    assert not tspace.is_valid(Candidate(backend="cuda", shards=2),
                               pseed.spmv_seed(), "cuda", devices=2)


# ---------------------------------------------- cost model vs the reference
@pytest.mark.parametrize("lane", [8, 16, 128])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plan_features_equal_reference(family, lane):
    rplan, plan = _plans(family, lane)
    assert dataclasses.asdict(tcost.plan_features(plan)) == \
        dataclasses.asdict(rcost.plan_features(rplan))


@pytest.mark.parametrize("lane", [8, 16, 128])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cpu_predictions_and_ranking_equal_reference(family, lane):
    rplan, plan = _plans(family, lane)
    space = tspace.candidate_space(pseed.spmv_seed(), platform="cpu",
                                   allow_interpret=True, lane_widths=(lane,))
    rspace_ = rspace.candidate_space(rseed.spmv_seed(), platform="cpu",
                                     allow_interpret=True,
                                     lane_widths=(lane,))
    f, rf = tcost.plan_features(plan), rcost.plan_features(rplan)
    for c, rc in zip(space, rspace_):
        assert tcost.predict_us(c, f, "cpu") == \
            rcost.predict_us(rc, rf, "cpu"), c.label
    for top_k in (None, 4):
        got = tcost.rank_candidates(space, {c.plan_key: f for c in space},
                                    "cpu", top_k=top_k)
        want = rcost.rank_candidates(rspace_,
                                     {c.plan_key: rf for c in rspace_},
                                     "cpu", top_k=top_k)
        assert [(_mapped(c), us) for c, us in got] == \
            [(c.to_dict(), us) for c, us in want]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cuda_predictions_follow_reference(family):
    rplan, plan = _plans(family, 16)
    space = tspace.candidate_space(pseed.spmv_seed(), platform="cuda",
                                   lane_widths=(16,))
    f, rf = tcost.plan_features(plan), rcost.plan_features(rplan)
    for c in space:
        rc = rspace.Candidate.from_dict(_mapped(c))
        got = tcost.predict_us(c, f, "cuda")
        if c.backend == "cuda":
            want = (rcost.predict_us(rc, rf, "tpu") / rcost.PALLAS_TPU_SCALE
                    * tcost.CUDA_SCALE)
            assert got == pytest.approx(want, rel=1e-12), c.label
        else:
            assert got == rcost.predict_us(rc, rf, "gpu"), c.label


# ------------------------------------------- mirrors of tests/test_tune.py
def test_space_validity_rules():
    seed = pseed.spmv_seed()
    cpu = tspace.candidate_space(seed, platform="cpu")
    assert cpu and all(c.backend != "cuda" for c in cpu), \
        "cuda must be skipped off the card unless asked for"
    segsum = [c for c in cpu if c.backend == "segsum"]
    assert len(segsum) == 1 and segsum[0].stage_b == "gather"
    assert sum(c.backend == "torch" for c in cpu) == 8
    assert sum(c.coalesce for c in cpu) == 4
    assert len(set(cpu)) == len(cpu)
    assert any(c.backend == "cuda" for c in tspace.candidate_space(
        seed, platform="cpu", allow_interpret=True))
    assert any(c.backend == "cuda" for c in
               tspace.candidate_space(seed, platform="cuda"))
    assert not tspace.is_valid(Candidate(backend="cuda"), seed, "cpu")
    assert tspace.is_valid(Candidate(backend="cuda"), seed, "cuda")
    assert not tspace.is_valid(Candidate(backend="cuda", kernel_prefetch=4),
                               seed, "cuda")
    assert tspace.platform_of("cpu") == "cpu"
    assert tspace.platform_of(torch.device("cuda", 0)) == "cuda"
    with pytest.raises(ValueError, match="unknown platform"):
        tspace.candidate_space(seed, platform="gpu")


def test_space_signature_changes_with_menu():
    seed = pseed.spmv_seed()
    a = tspace.candidate_space(seed, platform="cpu")
    b = tspace.candidate_space(seed, platform="cpu", lane_widths=(128, 64))
    assert tspace.space_signature(a) != tspace.space_signature(b)
    assert tspace.space_signature(a) == tspace.space_signature(list(a))


def test_cost_ranking_deterministic_and_penalizes_fragmentation():
    _, plan = _plans("power_law", 128)
    assert plan.stats.num_classes > 4                  # fragmented
    f = T.plan_features(plan)
    space = tspace.candidate_space(pseed.spmv_seed(), platform="cpu")
    feats = {c.plan_key: f for c in space}
    r1 = tcost.rank_candidates(space, feats, "cpu", top_k=3)
    assert r1 == tcost.rank_candidates(space, feats, "cpu", top_k=3)
    assert len(r1) == 3
    pred = dict(tcost.rank_candidates(space, feats, "cpu"))
    assert pred[Candidate(backend="torch", fused=True)] < \
        pred[Candidate(backend="torch", fused=False)]


def test_plan_features_deterministic():
    rows, cols, vals, out_len, data_len = _coo(3)
    plan = build_plan(pseed.spmv_seed(), {"row": rows, "col": cols},
                      out_len, data_len, CostModel(lane_width=16))
    f = T.plan_features(plan)
    assert f == T.plan_features(plan)
    assert f.nnz == plan.stats.nnz and 0.0 <= f.fallback_frac <= 1.0
    assert f.lanes_total == plan.num_blocks * plan.lane_width


def test_every_measured_candidate_matches_oracle():
    rows, cols, vals, out_len, data_len = _coo(1)
    (plan, run, result), x = _autotune_spmv(rows, cols, vals, out_len,
                                            data_len)
    assert result.measurements and all(m.ok for m in result.measurements)
    assert result.platform == "cpu"
    oracle = pseed.reference_execute(
        pseed.spmv_seed(), {"row": rows, "col": cols},
        {"value": vals, "x": x}, torch.zeros(out_len)).numpy()
    for m in result.measurements:
        c = m.candidate
        p = build_plan(pseed.spmv_seed(), {"row": rows, "col": cols},
                       out_len, data_len, c.cost_model())
        r = eng.make_executor(p, {"value": vals}, backend=c.backend,
                              fused=c.fused, stage_b=c.stage_b,
                              coalesce=c.coalesce, device="cpu")
        np.testing.assert_allclose(r({"x": x}, torch.zeros(out_len)).numpy(),
                                   oracle, rtol=1e-4, atol=1e-5,
                                   err_msg=c.label)
    np.testing.assert_allclose(run({"x": x}, torch.zeros(out_len)).numpy(),
                               oracle, rtol=1e-4, atol=1e-5)


def test_warm_cache_hit_performs_zero_measurements(tmp_path):
    rows, cols, vals, out_len, data_len = _coo(2)
    d = str(tmp_path)
    (_, run, cold), x = _autotune_spmv(rows, cols, vals, out_len, data_len,
                                       tune_cache_dir=d)
    assert not cold.cache_hit and cold.num_measured > 0
    assert len(list(tmp_path.iterdir())) == 1
    before = T.measurement_count()
    (_, run2, warm), _ = _autotune_spmv(rows, cols, vals, out_len, data_len,
                                        tune_cache_dir=d)
    assert warm.cache_hit and warm.measurements == []
    assert T.measurement_count() == before, \
        "a warm tuning-cache hit must perform zero measurements"
    assert warm.best == cold.best and warm.picked_by == "cache"
    y0 = torch.zeros(out_len)
    assert torch.equal(run({"x": x}, y0), run2({"x": x}, y0))


def test_force_retunes_and_corrupt_entry_recovers(tmp_path):
    rows, cols, vals, out_len, data_len = _coo(4)
    d = str(tmp_path)
    (_, _, cold), _ = _autotune_spmv(rows, cols, vals, out_len, data_len,
                                     tune_cache_dir=d)
    (_, _, forced), _ = _autotune_spmv(rows, cols, vals, out_len, data_len,
                                       tune_cache_dir=d, force=True)
    assert not forced.cache_hit and forced.num_measured > 0
    [entry] = list(tmp_path.iterdir())
    entry.write_text("{not json")
    with pytest.warns(RuntimeWarning, match="re-tuning"):
        (_, _, retuned), _ = _autotune_spmv(rows, cols, vals, out_len,
                                            data_len, tune_cache_dir=d)
    assert not retuned.cache_hit and retuned.num_measured > 0
    assert retuned.best in [m.candidate for m in retuned.measurements]
    assert cold.best is not None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        (_, _, warm), _ = _autotune_spmv(rows, cols, vals, out_len,
                                         data_len, tune_cache_dir=d)
    assert warm.cache_hit


def test_tuning_key_sensitivity(monkeypatch):
    rows, cols, vals, out_len, data_len = _coo(5)
    access = {"row": rows, "col": cols}
    k0 = T.tuning_key("spmv", "add", access, out_len, data_len, "cpu", "s")
    mod = {"row": rows, "col": cols.copy()}
    mod["col"][3] += 1
    assert T.tuning_key("spmv", "add", mod, out_len, data_len,
                        "cpu", "s") != k0
    assert T.tuning_key("spmv", "min", access, out_len, data_len,
                        "cpu", "s") != k0
    assert T.tuning_key("spmv", "add", access, out_len, data_len,
                        "cpu", "other-space") != k0
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    k_card = T.tuning_key("spmv", "add", access, out_len, data_len,
                          "cuda", "s")
    assert k_card != k0
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA A100-SXM4-80GB")
    assert T.tuning_key("spmv", "add", access, out_len, data_len,
                        "cuda", "s") != k_card
    monkeypatch.setattr(torch, "__version__", "0.0.0+other")
    assert T.tuning_key("spmv", "add", access, out_len, data_len,
                        "cpu", "s") != k0


def test_spmv_auto_matches_fixed_backend(tmp_path):
    m = G.banded(512, 5)
    args = (np.asarray(m.rows), np.asarray(m.cols), np.asarray(m.vals),
            m.shape)
    auto = SpMV.from_coo(*args, backend="auto", tune_cache_dir=str(tmp_path),
                         device="cpu")
    fixed = SpMV.from_coo(*args, device="cpu")
    assert isinstance(auto.tuning.best, Candidate)
    x = np.random.default_rng(0).standard_normal(m.shape[1]).astype(
        np.float32)
    np.testing.assert_allclose(auto.matvec(x).numpy(),
                               fixed.matvec(x).numpy(), rtol=1e-5, atol=1e-6)
    before = T.measurement_count()
    warm = SpMV.from_coo(*args, backend="auto", tune_cache_dir=str(tmp_path),
                         device="cpu")
    assert warm.tuning.cache_hit and T.measurement_count() == before


def test_pagerank_auto_matches_reference():
    src, dst, nn = G.graph_edges("powerlaw", 512, 8, seed=3)
    pr = PageRank.from_edges(src, dst, nn, backend="auto", device="cpu")
    assert pr.tuning is not None
    np.testing.assert_allclose(pr.run(iters=10).numpy(),
                               pagerank_reference(src, dst, nn, iters=10),
                               rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("app", ["bfs", "sssp", "cc"])
def test_graph_apps_auto_match_references(app):
    case = G.graph_case("uniform", 256, 6, seed=5)
    if app == "bfs":
        inst = GR.BFS.from_edges(case.src, case.dst, case.num_nodes,
                                 backend="auto", device="cpu")
        np.testing.assert_array_equal(
            inst.run(0).numpy(),
            GR.bfs_reference(case.src, case.dst, case.num_nodes, 0))
    elif app == "sssp":
        inst = GR.SSSP.from_edges(case.src, case.dst, case.weight,
                                  case.num_nodes, backend="auto",
                                  device="cpu")
        np.testing.assert_allclose(
            inst.run(0).numpy(),
            GR.sssp_reference(case.src, case.dst, case.weight,
                              case.num_nodes, 0), rtol=1e-5, atol=1e-6)
    else:
        inst = GR.ConnectedComponents.from_edges(
            case.src, case.dst, case.num_nodes, backend="auto",
            device="cpu")
        np.testing.assert_array_equal(
            inst.run().numpy(),
            GR.cc_reference(case.src, case.dst, case.num_nodes))
    assert inst.tuning.best.backend in ("torch", "segsum")
    assert inst.tuning.platform == "cpu"


# ------------------------------------ auto builds vs the reference, fixed
@pytest.mark.parametrize("reduce,dtype", SEMIRINGS)
def test_spmv_spmm_auto_within_reference_rule(reduce, dtype):
    m = RG.power_law(512, 6)
    rng = np.random.default_rng(1)
    rows, cols = np.asarray(m.rows), np.asarray(m.cols)
    if np.issubdtype(np.dtype(dtype), np.integer):
        vals = rng.integers(-4, 5, m.nnz).astype(dtype)
        b = rng.integers(-4, 5, (m.shape[1], 3)).astype(dtype)
    else:
        vals = rng.standard_normal(m.nnz).astype(dtype)
        b = rng.standard_normal((m.shape[1], 3)).astype(dtype)
    ref = np.asarray(RSpMM.from_coo(rows, cols, vals, m.shape, lane_width=16,
                                    reduce=reduce).matmat(jnp.asarray(b)))
    got = SpMM.from_coo(rows, cols, vals, m.shape, lane_width=16,
                        reduce=reduce, backend="auto", device="cpu")
    assert got.tuning is not None and got.tuning.platform == "cpu"
    _assert_rule(got.matmat(b).numpy(), ref, reduce, dtype)
    if reduce == "add":
        ref_v = np.asarray(rapps.SpMV.from_coo(
            rows, cols, vals, m.shape, lane_width=16).matvec(
                jnp.asarray(b[:, 0])))
        sp = SpMV.from_coo(rows, cols, vals, m.shape, lane_width=16,
                           tune=True, device="cpu")
        _assert_rule(sp.matvec(b[:, 0]).numpy(), ref_v, reduce, dtype)


@pytest.mark.parametrize("app", ["bfs", "sssp", "cc", "pagerank"])
def test_graph_auto_within_reference_rule(app):
    c = {k.name: k for k in G.graph_suite("small")}["powerlaw"]
    rc = {k.name: k for k in RG.graph_suite("small")}["powerlaw"]
    if app == "pagerank":
        ref = np.asarray(rapps.PageRank.from_edges(
            rc.src, rc.dst, rc.num_nodes, lane_width=16).run(iters=10))
        got = PageRank.from_edges(c.src, c.dst, c.num_nodes, lane_width=16,
                                  backend="auto", device="cpu")
        _assert_rule(got.run(iters=10).numpy(), ref)
        return
    cls = {"bfs": (GR.BFS, rgraphs.BFS), "sssp": (GR.SSSP, rgraphs.SSSP),
           "cc": (GR.ConnectedComponents, rgraphs.ConnectedComponents)}[app]
    edges = ((c.src, c.dst, c.weight, c.num_nodes) if app == "sssp"
             else (c.src, c.dst, c.num_nodes))
    ref_app = cls[1].from_edges(*edges, lane_width=16)
    got_app = cls[0].from_edges(*edges, lane_width=16, backend="auto",
                                device="cpu")
    ref = ref_app.run() if app == "cc" else ref_app.run(0)
    got = got_app.run() if app == "cc" else got_app.run(0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert dataclasses.asdict(got_app.convergence) == \
        dataclasses.asdict(ref_app.convergence)


def test_auto_rejects_explicit_variant_kwargs():
    m = G.banded(64, 3)
    args = (m.rows, m.cols, m.vals, m.shape)
    for kw in ({"fused": False}, {"stage_b": "dense"}, {"coalesce": True},
               {"cost": CostModel(lane_width=8)}):
        with pytest.raises(ValueError, match="would be silently ignored"):
            SpMV.from_coo(*args, backend="auto", device="cpu", **kw)
    with pytest.raises(ValueError, match="backend='cuda'"):
        SpMM.from_coo(*args, backend="cuda", tune=True, device="cpu")
    with pytest.raises(ValueError, match="fused"):
        GR.BFS.from_edges(m.rows, m.cols, 64, backend="auto", fused=False,
                          device="cpu")


def test_failing_candidate_is_disqualified_with_a_warning():
    """As the reference, on the ``"cpu"`` platform: a candidate that raises
    is disqualified with a RuntimeWarning, and the tune goes on."""
    rows, cols, vals, out_len, data_len = _coo(6)

    def factory(plan, cand, static_data, elem_exec):
        if cand.backend == "segsum":
            raise RuntimeError("boom")
        return eng.make_executor(plan, static_data, backend=cand.backend,
                                 fused=cand.fused, stage_b=cand.stage_b,
                                 elem_exec=elem_exec, coalesce=cand.coalesce,
                                 device="cpu")
    with pytest.warns(RuntimeWarning, match="disqualified"):
        (_, _, res), _ = _autotune_spmv(rows, cols, vals, out_len, data_len,
                                        exec_factory=factory, top_k=None)
    dead = [m for m in res.measurements if m.candidate.backend == "segsum"]
    assert len(dead) == 1 and not dead[0].ok and "boom" in dead[0].error
    assert res.best.backend == "torch"


def _card_space():
    """One torch, one segsum and one cuda candidate of the ``"cuda"``
    space."""
    space = T.candidate_space(pseed.spmv_seed(), platform="cuda")
    pick = {}
    for c in space:
        if c.stage_b != "dense":
            pick.setdefault(c.backend, c)
    return [pick["torch"], pick["segsum"], pick["cuda"]]


@pytest.mark.parametrize("stage", ["build", "timed", "replay", "harness",
                                   "segsum"])
def test_kernel_candidate_fault_raises_on_the_card(stage, tmp_path,
                                                   monkeypatch):
    """On the ``"cuda"`` platform (forced here, on CPU tensors) a ``cuda``
    candidate that raises while it is built, timed or replayed from the
    cache, or a measurement harness that fails, makes the tune raise: a
    plain torch form must not take the kernel's place.  A torch or
    segsum candidate that raises is still disqualified with a warning."""
    from repro_torch.tune import search as tsearch
    monkeypatch.setattr(tspace, "platform_of", lambda dev: "cuda")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    rows, cols, vals, out_len, data_len = _coo(7)
    broken = {"on": stage in ("build", "timed", "segsum")}

    def factory(plan, cand, static_data, elem_exec):
        run = eng.make_executor(plan, static_data, backend=cand.backend,
                                fused=cand.fused, stage_b=cand.stage_b,
                                elem_exec=elem_exec, coalesce=cand.coalesce,
                                kernel_params=cand.kernel_params,
                                device="cpu")
        target = "segsum" if stage == "segsum" else "cuda"
        if cand.backend != target or not broken["on"]:
            return run
        if stage in ("build", "replay", "segsum"):
            raise RuntimeError("boom")
        calls = []

        def flaky(mutable, out_init):
            calls.append(1)
            if len(calls) > 1:
                raise RuntimeError("boom")
            return run(mutable, out_init)
        return flaky
    kw = dict(space=_card_space(), top_k=None, exec_factory=factory,
              tune_cache_dir=str(tmp_path))
    if stage == "segsum":
        with pytest.warns(RuntimeWarning, match="disqualified"):
            (_, _, res), _ = _autotune_spmv(rows, cols, vals, out_len,
                                            data_len, **kw)
        assert res.platform == "cuda" and res.best.backend != "segsum"
        return
    if stage == "replay":
        (_, _, cold), _ = _autotune_spmv(rows, cols, vals, out_len,
                                         data_len, **kw)
        # a cached cuda choice, replayed with a broken kernel
        entry = next(tmp_path.iterdir())
        data = json.loads(entry.read_text())
        data["choice"] = _card_space()[2].to_dict()
        entry.write_text(json.dumps(data))
        broken["on"] = True
    if stage == "harness":
        def dead_timer(*a, **k):
            raise RuntimeError("timer")
        monkeypatch.setattr(tsearch, "_timed_round", dead_timer)
    want = RuntimeError if stage == "harness" else T.KernelCandidateError
    with pytest.raises(want, match="timer" if stage == "harness"
                       else "raised on the card"):
        _autotune_spmv(rows, cols, vals, out_len, data_len, **kw)


def test_calibration_reads_the_model_before_its_scale(monkeypatch, capsys):
    """``python -m repro_torch.tune.calibrate`` at a small size, on the CPU
    with the ``"cuda"`` space forced: every candidate measured, each row's
    unscaled model times its backend's scale is its prediction, and the
    reading is the ratio the module documents."""
    from repro_torch.tune import calibrate
    monkeypatch.setattr(tspace, "platform_of", lambda dev: "cuda")
    m = G.banded(300, 5)
    rows = calibrate.measure_space(m, "cpu")
    space = T.candidate_space(pseed.spmv_seed(), platform="cuda")
    assert sorted(r["label"] for r in rows) == sorted(c.label for c in space)
    for r in rows:
        scale = tcost.CUDA_SCALE if r["backend"] == "cuda" else 1.0
        assert r["unscaled_us"] * scale == pytest.approx(r["predicted_us"])
        assert np.isfinite(r["measured_us"]) and r["measured_us"] > 0
    by = {r["label"]: r for r in rows}
    k, t = by["cuda/fused/gather/n128"], by["torch/fused/gather/n128"]
    assert calibrate.reading(rows) == pytest.approx(
        k["measured_us"] / k["unscaled_us"]
        / (t["measured_us"] / t["predicted_us"]))
    scale = calibrate.main(["--device", "cpu"],
                           matrices={"banded": lambda: m})
    out = capsys.readouterr().out
    assert out.count("[calibrate] banded cuda/") == 16
    assert f"geometric mean of the readings {scale:.4f}" in out


# ------------------------------------------ segsum / baseline emitters
SEGSUM_FAMILIES = {"banded": lambda g: g.banded(300, band=5),
                   "power_law": lambda g: g.power_law(512, 6),
                   "dense": lambda g: g.dense(40),
                   "power_law_hubs": lambda g: g.power_law(2048, 8)}


def _emitter_case(family, reduce, dtype, d):
    m = SEGSUM_FAMILIES[family](RG)
    access = {"row": np.asarray(m.rows), "col": np.asarray(m.cols)}
    rng = np.random.default_rng(2)
    shape = (m.shape[1],) if d is None else (m.shape[1], d)
    if np.issubdtype(np.dtype(dtype), np.integer):
        vals = rng.integers(-3, 4, m.nnz).astype(dtype)
        x = rng.integers(-3, 4, shape).astype(dtype)
    else:
        vals = rng.standard_normal(m.nnz).astype(dtype)
        x = rng.standard_normal(shape).astype(dtype)
    y0 = np.full((m.shape[0],) + shape[1:],
                 pseed.reduce_identity_for(reduce, dtype), dtype)
    return m, access, vals, x, y0


def _segsum_pair(family, reduce, dtype, d):
    m, access, vals, x, y0 = _emitter_case(family, reduce, dtype, d)
    rplan = rbuild_plan(rseed.spmv_seed(reduce), access, *m.shape,
                        RCostModel(lane_width=8))
    plan = build_plan(pseed.spmv_seed(reduce), access, *m.shape,
                      CostModel(lane_width=8))
    ref = np.asarray(reng.make_executor(rplan, {"value": vals},
                                        backend="segsum")(
        {"x": jnp.asarray(x)}, jnp.asarray(y0)))
    got = eng.make_executor(plan, {"value": vals}, backend="segsum",
                            device="cpu")({"x": torch.as_tensor(x)},
                                          torch.as_tensor(y0))
    assert got.dtype == torch.as_tensor(y0).dtype
    return m, access, vals, x, y0, ref, got.numpy()


@pytest.mark.parametrize("d", [None, 3])
@pytest.mark.parametrize("reduce,dtype", SEMIRINGS)
@pytest.mark.parametrize("family", ["banded", "power_law", "dense"])
def test_segsum_and_baseline_match_reference(family, reduce, dtype, d):
    _, access, vals, x, y0, ref, got = _segsum_pair(family, reduce, dtype, d)
    _assert_rule(got, ref, reduce, dtype)
    rbase = np.asarray(reng.make_baseline_gather(
        rseed.spmv_seed(reduce), access, {"value": vals})(
        {"x": jnp.asarray(x)}, jnp.asarray(y0)))
    base = eng.make_baseline_gather(pseed.spmv_seed(reduce), access,
                                    {"value": vals}, device="cpu")(
        {"x": torch.as_tensor(x)}, torch.as_tensor(y0))
    _assert_rule(base.numpy(), rbase, reduce, dtype)


@pytest.mark.parametrize("d", [None, 3])
@pytest.mark.parametrize("family", sorted(SEGSUM_FAMILIES))
def test_segsum_float_add_rounds_once(family, d):
    """The port's segsum accumulates float add in float64 and rounds once
    (its order on the card is atomic, so unfixed), where the reference's
    accumulates in float32, one rounding per term.  So against the float32
    terms summed in float64 the port is within one float32 ulp everywhere,
    and normwise within 1e-5 of the reference's — also on
    ``power_law_hubs``, whose hub rows take the reference's float32 sum
    past ``rtol=1e-5`` of the exact one at single elements."""
    m, _, vals, x, _, ref, got = _segsum_pair(family, "add", np.float32, d)
    terms = vals.reshape((-1,) + (1,) * (x.ndim - 1)) * x[np.asarray(m.cols)]
    exact = np.zeros((m.shape[0],) + x.shape[1:])
    np.add.at(exact, np.asarray(m.rows), terms.astype(np.float64))
    ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(got - exact) <= ulp)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("app", ["bfs", "sssp", "cc"])
def test_graph_apps_segsum_equal_reference(app):
    c = {k.name: k for k in G.graph_suite("small")}["powerlaw"]
    cls = {"bfs": (GR.BFS, rgraphs.BFS), "sssp": (GR.SSSP, rgraphs.SSSP),
           "cc": (GR.ConnectedComponents, rgraphs.ConnectedComponents)}[app]
    edges = ((c.src, c.dst, c.weight, c.num_nodes) if app == "sssp"
             else (c.src, c.dst, c.num_nodes))
    ref_app = cls[1].from_edges(*edges, lane_width=16, backend="segsum")
    got_app = cls[0].from_edges(*edges, lane_width=16, backend="segsum",
                                device="cpu")
    ref = ref_app.run() if app == "cc" else ref_app.run(0)
    got = got_app.run() if app == "cc" else got_app.run(0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert dataclasses.asdict(got_app.convergence) == \
        dataclasses.asdict(ref_app.convergence)


def test_cache_entry_records_torch_version(tmp_path):
    rows, cols, vals, out_len, data_len = _coo(7)
    _autotune_spmv(rows, cols, vals, out_len, data_len,
                   tune_cache_dir=str(tmp_path))
    [entry] = list(tmp_path.iterdir())
    import json
    payload = json.loads(entry.read_text())
    assert payload["schema"] == tcache.SCHEMA
    assert payload["torch"] == torch.__version__ and "jax" not in payload
    assert payload["platform"] == "cpu"
    assert RT.space.SEGMENT_REDUCES == tspace.SEGMENT_REDUCES
