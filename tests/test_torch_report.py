"""``repro_torch.obs.profile`` and every app's ``report()``, against the
reference's ``repro.obs.profile``.

* ``launch_cost_table`` rows equal the reference's for every backend pair
  (``torch``/``jax``, ``segsum``/``segsum``, ``cuda``/``pallas``), fused and
  per-class, coalesced and not.
* A ``RunReport`` has the reference's keys, with ``hlo`` ``None`` (PyTorch
  has no HLO); its plan dict, passes, pass deltas, launch rows, totals
  and (for the graph apps) sweeps equal the reference's on the same
  inputs.
* ``report()`` works on SpMV, SpMM, PageRank, BFS, SSSP and CC, fixed and
  tuned: its launch count equals the lowered tree's and ``to_json()``
  parses.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest

from repro.core import apps as rapps
from repro.core import graphs as rgraphs
from repro.core import ir as rir
from repro.core.plan import CostModel as RCostModel
from repro.core.plan import build_plan as rbuild_plan
from repro.core.seed import spmv_seed as rspmv_seed
from repro.core.spmm import SpMM as RSpMM
from repro.obs import profile as rprofile
from repro.sparse import generators as RG

from repro_torch.core import apps, graphs, ir
from repro_torch.core.plan import CostModel, build_plan
from repro_torch.core.seed import spmv_seed
from repro_torch.core.spmm import SpMM
from repro_torch.obs import RunReport, build_report
from repro_torch.obs import profile
from repro_torch.sparse import generators as G

FAMILIES = {"banded": lambda g: g.banded(300, band=5),
            "power_law": lambda g: g.power_law(400, 6),
            "block_diag": lambda g: g.block_diag(256, 16),
            "dense": lambda g: g.dense(40)}
PAIRS = [("torch", "jax"), ("segsum", "segsum"), ("cuda", "pallas")]
LANE = 16


@functools.lru_cache(maxsize=None)
def _plans(family, lane):
    m = FAMILIES[family](RG)
    access = {"row": np.asarray(m.rows), "col": np.asarray(m.cols)}
    return (rbuild_plan(rspmv_seed(), access, m.shape[0], m.shape[1],
                        RCostModel(lane_width=lane)),
            build_plan(spmv_seed(), access, m.shape[0], m.shape[1],
                       CostModel(lane_width=lane)))


@pytest.mark.parametrize("coalesce", [False, True])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("backend,ref_backend", PAIRS)
@pytest.mark.parametrize("lane", [8, 16])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_launch_cost_rows_equal_reference(family, lane, backend, ref_backend,
                                          fused, coalesce):
    rplan, plan = _plans(family, lane)
    want = rprofile.launch_cost_table(rir.lower(
        rplan, backend=ref_backend, fused=fused, coalesce=coalesce))
    got = profile.launch_cost_table(ir.lower(
        plan, backend=backend, fused=fused, coalesce=coalesce))
    assert got == want


def _same_report(got: RunReport, want, backend):
    g, w = got.to_dict(), want.to_dict()
    assert sorted(g) == sorted(w)
    assert g["hlo"] is None and g["shards"] is None
    assert g["backend"] == backend
    for k in ("app", "plan", "passes", "pass_deltas", "launches", "totals",
              "sweeps", "validation", "degradations"):
        assert g[k] == w[k], k
    assert json.loads(got.to_json())["totals"] == g["totals"]


def _m():
    return RG.power_law(512, 6)


@pytest.mark.parametrize("backend,ref_backend", PAIRS)
def test_spmv_report_equals_reference(backend, ref_backend):
    m = _m()
    args = (np.asarray(m.rows), np.asarray(m.cols), np.asarray(m.vals),
            m.shape)
    ref = rapps.SpMV.from_coo(*args, lane_width=LANE, backend=ref_backend)
    port = apps.SpMV.from_coo(*args, lane_width=LANE, backend=backend,
                              device="cpu")
    _same_report(port.report(), ref.report(), backend)


@pytest.mark.parametrize("reduce", ["add", "min"])
def test_spmm_report_equals_reference(reduce):
    m = _m()
    args = (np.asarray(m.rows), np.asarray(m.cols), np.asarray(m.vals),
            m.shape)
    ref = RSpMM.from_coo(*args, lane_width=LANE, reduce=reduce,
                         coalesce=True)
    port = SpMM.from_coo(*args, lane_width=LANE, reduce=reduce,
                         coalesce=True, device="cpu")
    _same_report(port.report(), ref.report(), "torch")


def test_pagerank_report_equals_reference():
    c = {k.name: k for k in G.graph_suite("small")}["powerlaw"]
    ref = rapps.PageRank.from_edges(c.src, c.dst, c.num_nodes,
                                    lane_width=LANE)
    port = apps.PageRank.from_edges(c.src, c.dst, c.num_nodes,
                                    lane_width=LANE, device="cpu")
    _same_report(port.report(), ref.report(), "torch")


@pytest.mark.parametrize("app", ["bfs", "sssp", "cc"])
def test_graph_report_equals_reference(app):
    c = {k.name: k for k in G.graph_suite("small")}["powerlaw"]
    cls = {"bfs": (graphs.BFS, rgraphs.BFS),
           "sssp": (graphs.SSSP, rgraphs.SSSP),
           "cc": (graphs.ConnectedComponents,
                  rgraphs.ConnectedComponents)}[app]
    edges = ((c.src, c.dst, c.weight, c.num_nodes) if app == "sssp"
             else (c.src, c.dst, c.num_nodes))
    ref = cls[1].from_edges(*edges, lane_width=LANE)
    port = cls[0].from_edges(*edges, lane_width=LANE, device="cpu")
    for a in (ref, port):
        a.run() if app == "cc" else a.run(0)
    got = port.report()
    _same_report(got, ref.report(), "torch")
    assert got.sweeps == dataclasses.asdict(port.convergence)
    assert got.app == cls[0].__name__


@pytest.mark.parametrize("app", ["spmv", "spmm", "pagerank", "bfs", "sssp",
                                 "cc"])
def test_tuned_report(app, tmp_path):
    m = G.banded(256, 4)
    c = G.graph_case("uniform", 128, 4, seed=2)
    kw = dict(backend="auto", tune_cache_dir=str(tmp_path), device="cpu",
              lane_width=LANE)
    if app == "spmv":
        a = apps.SpMV.from_coo(m.rows, m.cols, m.vals, m.shape, **kw)
    elif app == "spmm":
        a = SpMM.from_coo(m.rows, m.cols, m.vals, m.shape, reduce="max",
                          **kw)
    elif app == "pagerank":
        a = apps.PageRank.from_edges(c.src, c.dst, c.num_nodes, **kw)
    elif app == "sssp":
        a = graphs.SSSP.from_edges(c.src, c.dst, c.weight, c.num_nodes,
                                   **kw)
    else:
        cls = graphs.BFS if app == "bfs" else graphs.ConnectedComponents
        a = cls.from_edges(c.src, c.dst, c.num_nodes, **kw)
    rep = a.report()
    assert rep.totals["launches"] == len(a._run.tree.launches)
    assert rep.backend == a.tuning.best.backend
    parsed = json.loads(rep.to_json())
    assert parsed["hlo"] is None
    assert parsed["tuning"]["picked_by"] == "measurement"
    assert parsed["tuning"]["platform"] == "cpu"
    assert len(parsed["tuning"]["measurements"]) == a.tuning.num_measured
    assert parsed["tuning"]["best"] == a.tuning.best.to_dict()


def test_report_of_an_app_without_a_tree():
    class Bare:
        plan = _plans("banded", 8)[1]
        _run = None
    rep = build_report(Bare(), "Bare")
    assert rep.launches == [] and rep.totals["launches"] == 0
    assert rep.backend is None and rep.tuning is None
