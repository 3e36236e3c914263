"""``repro_torch`` graph apps (BFS, SSSP, CC, PageRank) against the reference.

* Against the JAX package's apps on ``backend="jax"`` over
  ``G.graph_suite("small")`` (n = 512: power-law, uniform, banded, ring,
  isolated, and a 64-node empty graph) at lane width 16, and against its
  ``backend="pallas"`` (interpret) on two 96-node graphs: BFS levels, CC
  labels and SSSP distances exactly equal (min is exact: the reference's
  rule, ``tests/test_pallas.py``), PageRank ``allclose(rtol=1e-5,
  atol=1e-6)``, and every ``ConvergenceReport`` field equal, including a
  negative cycle, a poisoned (``-inf`` weight) run and ``max_sweeps``
  exhaustion.
* Each graph seed's ``BlockPlan`` equals the reference's, field for field.
* Inside the port, bitwise: the ``cuda`` backend (plain kernel versions on
  the CPU) == ``torch``, resident == host, ``run_multi`` row ``i`` ==
  ``run(sources[i])``; one plan build per graph; the resident driver reads
  the device at most ``ceil(sweeps / SYNC_EVERY) + 1`` times per run.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from repro.core import apps as rapps
from repro.core import graphs as rgraphs
from repro.sparse import generators as RG

from repro_torch.core import apps, graphs
from repro_torch.sparse import generators as G

LANE = 16
KINDS = ["powerlaw", "uniform", "banded", "ring", "isolated", "empty"]
BACKENDS = ["torch", "cuda"]
APPS = {"bfs": graphs.BFS, "sssp": graphs.SSSP,
        "cc": graphs.ConnectedComponents}
REF_APPS = {"bfs": rgraphs.BFS, "sssp": rgraphs.SSSP,
            "cc": rgraphs.ConnectedComponents}


@functools.lru_cache(maxsize=None)
def _case(kind):
    return {c.name: c for c in G.graph_suite("small")}[kind]


def _edges(app, c):
    return ((c.src, c.dst, c.weight, c.num_nodes) if app == "sssp"
            else (c.src, c.dst, c.num_nodes))


def _go(app, obj, source=0, **kw):
    out = obj.run(**kw) if app == "cc" else obj.run(source, **kw)
    return np.asarray(out.numpy() if isinstance(out, torch.Tensor) else out)


@functools.lru_cache(maxsize=None)
def _reference(app, kind, backend="jax"):
    c = _case(kind) if backend == "jax" else RG.graph_case(kind, 96, 5)
    kw = dict(lane_width=LANE, backend=backend)
    if backend == "pallas":
        kw["interpret"] = True
    ref = REF_APPS[app].from_edges(*_edges(app, c), **kw)
    return _go(app, ref), dataclasses.asdict(ref.convergence)


@functools.lru_cache(maxsize=None)
def _port(app, kind, backend, driver="resident"):
    c = _case(kind)
    obj = APPS[app].from_edges(*_edges(app, c), lane_width=LANE,
                               backend=backend, driver=driver, device="cpu")
    return obj, _go(app, obj), dataclasses.asdict(obj.convergence)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("app", sorted(APPS))
def test_app_vs_reference_jax(app, kind, backend):
    """Exact states and the same convergence story as the reference; the
    ``cuda`` backend bitwise equal to ``torch``."""
    want, want_report = _reference(app, kind)
    _, got, report = _port(app, kind, backend)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert report == want_report
    if backend == "cuda":
        assert got.tobytes() == _port(app, kind, "torch")[1].tobytes()


@pytest.mark.parametrize("app", sorted(APPS))
@pytest.mark.parametrize("kind", ["powerlaw", "isolated"])
def test_app_vs_reference_pallas(kind, app):
    """The kernel backend against the reference's Pallas kernels in
    interpret mode, on the 96-node graphs of ``tests/test_graphs.py``."""
    want, want_report = _reference(app, kind, "pallas")
    c = RG.graph_case(kind, 96, 5)
    obj = APPS[app].from_edges(*_edges(app, c), lane_width=LANE,
                               backend="cuda", device="cpu")
    np.testing.assert_array_equal(_go(app, obj), want)
    assert dataclasses.asdict(obj.convergence) == want_report


@functools.lru_cache(maxsize=None)
def _pagerank(kind, backend, driver="resident"):
    c = _case(kind)
    pr = apps.PageRank.from_edges(c.src, c.dst, c.num_nodes, lane_width=LANE,
                                  backend=backend, driver=driver,
                                  device="cpu")
    return pr.run(iters=20).numpy()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", KINDS)
def test_pagerank_vs_reference(kind, backend):
    c = _case(kind)
    ref = rapps.PageRank.from_edges(c.src, c.dst, c.num_nodes,
                                    lane_width=LANE)
    got = _pagerank(kind, backend)
    np.testing.assert_allclose(got, np.asarray(ref.run(iters=20)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got, apps.pagerank_reference(c.src, c.dst, c.num_nodes),
        rtol=1e-5, atol=1e-6)
    assert got.tobytes() == _pagerank(kind, "torch").tobytes()
    assert got.tobytes() == _pagerank(kind, backend, "host").tobytes()


@pytest.mark.parametrize("kind", ["powerlaw", "ring", "isolated"])
@pytest.mark.parametrize("app", sorted(APPS))
def test_numpy_oracles(app, kind):
    """The ported oracles equal the reference's, and the apps them."""
    c = _case(kind)
    if app == "cc":
        want = rgraphs.cc_reference(c.src, c.dst, c.num_nodes)
        got = graphs.cc_reference(c.src, c.dst, c.num_nodes)
    elif app == "bfs":
        want = rgraphs.bfs_reference(c.src, c.dst, c.num_nodes, 0)
        got = graphs.bfs_reference(c.src, c.dst, c.num_nodes, 0)
    else:
        want = rgraphs.sssp_reference(c.src, c.dst, c.weight, c.num_nodes, 0)
        got = graphs.sssp_reference(c.src, c.dst, c.weight, c.num_nodes, 0)
    np.testing.assert_array_equal(got, want)
    app_out = _port(app, kind, "cuda")[1]
    if app == "sssp":
        np.testing.assert_allclose(app_out, got, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(app_out, got)


def _plan_fields(plan):
    fields = {f: getattr(plan, f) for f in (
        "lane_width", "nnz", "out_len", "data_len", "num_blocks",
        "window_ids", "lane_slot", "lane_offset", "seg_ids", "gather_idx",
        "valid", "flat_perm", "head_pos", "head_rows")}
    fields["classes"] = [dataclasses.astuple(c) for c in plan.classes]
    fields["stats"] = dataclasses.asdict(plan.stats)
    return fields


@pytest.mark.parametrize("kind", ["powerlaw", "banded", "isolated", "empty"])
@pytest.mark.parametrize("app", sorted(APPS))
def test_plans_equal_reference(app, kind):
    """Each graph seed's plan, CC's symmetrized one included, equals the
    reference's field for field."""
    c = _case(kind)
    ref = REF_APPS[app].from_edges(*_edges(app, c), lane_width=LANE).plan
    got = _port(app, kind, "cuda")[0].plan
    want = _plan_fields(ref)
    for f, v in _plan_fields(got).items():
        if isinstance(v, np.ndarray):
            assert v.dtype == want[f].dtype and np.array_equal(v, want[f]), f
        else:
            assert v == want[f], f
    assert got.seed.name == ref.seed.name and got.seed.reduce == "min"


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", ["powerlaw", "banded", "isolated"])
@pytest.mark.parametrize("app", sorted(APPS))
def test_resident_equals_host(app, kind, backend):
    _, got, report = _port(app, kind, backend)
    _, want, host_report = _port(app, kind, backend, "host")
    assert got.tobytes() == want.tobytes()
    assert report == host_report


def _robust_cases():
    """(name, app, edges, run kwargs) of the reference's fixpoint-health
    cases: a poisoned (-inf weight) SSSP, a negative cycle, negative
    weights without one, capped sweeps, and a ring cut short."""
    ring = _case("ring")
    return {
        "poisoned": ("sssp", (np.array([0, 1]), np.array([1, 2]),
                              np.array([1.0, -np.inf], np.float32), 3),
                     {"validate": "off"}, {}),
        "nan_weight": ("sssp", (np.array([0, 1, 1]), np.array([1, 2, 0]),
                                np.array([1.0, np.nan, 2.0], np.float32), 3),
                       {"validate": "off"}, {}),
        "negative_cycle": ("sssp", (np.array([0, 1, 2]), np.array([1, 2, 0]),
                                    np.array([1.0, 1.0, -3.0], np.float32),
                                    3), {}, {}),
        "negative_no_cycle": ("sssp", (np.array([0, 1]), np.array([1, 2]),
                                       np.array([-2.0, -3.0], np.float32),
                                       3), {}, {}),
        "capped_sssp": ("sssp", (np.arange(4), np.arange(1, 5),
                                 np.ones(4, np.float32), 5), {},
                        {"max_sweeps": 2}),
        "capped_bfs": ("bfs", (ring.src, ring.dst, ring.num_nodes), {},
                       {"max_sweeps": 3}),
        "zero_sweeps": ("cc", (ring.src, ring.dst, ring.num_nodes), {},
                        {"max_sweeps": 0}),
    }


@pytest.mark.parametrize("driver", ["resident", "host"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(_robust_cases()))
def test_convergence_report_vs_reference(name, backend, driver):
    app, edges, build_kw, run_kw = _robust_cases()[name]
    ref = REF_APPS[app].from_edges(*edges, lane_width=8, driver=driver,
                                   **build_kw)
    want = _go(app, ref, **run_kw)
    obj = APPS[app].from_edges(*edges, lane_width=8, backend=backend,
                               driver=driver, device="cpu", **build_kw)
    got = _go(app, obj, **run_kw)
    assert dataclasses.asdict(obj.convergence) == \
        dataclasses.asdict(ref.convergence)
    np.testing.assert_array_equal(got, want)
    other = APPS[app].from_edges(*edges, lane_width=8, backend=backend,
                                 driver="host" if driver == "resident"
                                 else "resident", device="cpu", **build_kw)
    assert _go(app, other, **run_kw).tobytes() == got.tobytes()
    assert other.convergence == obj.convergence


@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("app", ["bfs", "sssp"])
def test_run_multi_rows_equal_run(app, backend, bucket):
    """Row ``i`` of ``run_multi`` (the S sources as a trailing lane axis)
    is bitwise ``run(sources[i])``, whatever the bucket padding, and the
    rows match the reference's ``run_multi``."""
    c = _case("powerlaw")
    obj = _port(app, "powerlaw", backend)[0]
    sources = [0, 3, 17, 101, 250]
    multi = obj.run_multi(sources, bucket=bucket)
    assert tuple(multi.shape) == (len(sources), c.num_nodes)
    assert multi.is_contiguous()
    for i, s in enumerate(sources):
        assert multi[i].numpy().tobytes() == _go(app, obj, s).tobytes()
    ref = REF_APPS[app].from_edges(*_edges(app, c), lane_width=LANE)
    np.testing.assert_array_equal(multi.numpy(), ref.run_multi(sources))


def test_plan_builds_and_batched_shapes():
    """One plan build per graph across every sweep and run; each distinct
    padded batch shape counts once."""
    c = _case("uniform")
    before = graphs.plan_build_count()
    bfs = graphs.BFS.from_edges(c.src, c.dst, c.num_nodes, lane_width=LANE,
                                device="cpu")
    assert graphs.plan_build_count() == before + 1
    shapes = graphs.batched_shape_count()
    bfs.run(0)
    bfs.run(1)
    for count in (3, 4, 5, 7):             # buckets 4, 4, 8, 8
        assert tuple(bfs.run_multi(list(range(count))).shape) == \
            (count, c.num_nodes)
    assert graphs.plan_build_count() == before + 1
    assert graphs.batched_shape_count() == shapes + 2
    graphs.ConnectedComponents.from_edges(c.src, c.dst, c.num_nodes,
                                          lane_width=LANE, device="cpu")
    assert graphs.plan_build_count() == before + 2
    assert graphs.bucket_ladder_upto(5) == rgraphs.bucket_ladder_upto(5)
    assert graphs.bucket_ladder_upto(300) == rgraphs.bucket_ladder_upto(300)
    for s in (1, 3, 6):
        for a, b in zip(graphs.pad_to_bucket(np.arange(s)),
                        rgraphs.pad_to_bucket(np.arange(s))):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sync_every", [1, 4, 7])
@pytest.mark.parametrize("kind", ["ring", "powerlaw", "empty"])
def test_resident_driver_reads_the_device_once_per_chunk(kind, sync_every,
                                                         monkeypatch):
    """The resident driver reads the device at most ceil(sweeps / k) + 1
    times per run (k = ``SYNC_EVERY``), the host driver once per sweep
    plus once for the initial state; both end on the same state and
    report."""
    reads = []
    real = graphs.read_flags

    def counted(*flags):
        reads.append(len(flags))
        return real(*flags)

    monkeypatch.setattr(graphs, "read_flags", counted)
    monkeypatch.setattr(graphs, "SYNC_EVERY", sync_every)
    c = _case(kind)
    out = {}
    for driver in ("resident", "host"):
        app = graphs.BFS.from_edges(c.src, c.dst, c.num_nodes,
                                    lane_width=LANE, driver=driver,
                                    device="cpu")
        reads.clear()
        out[driver] = (app.run(0).numpy().tobytes(), app.convergence)
        sweeps = app.convergence.sweeps
        if driver == "resident":
            assert len(reads) <= math.ceil(sweeps / sync_every) + 1
        else:
            assert len(reads) == sweeps + 1
    assert out["resident"] == out["host"]


def test_not_yet_ported_options_raise():
    c = _case("powerlaw")
    for cls in (graphs.BFS, graphs.ConnectedComponents, apps.PageRank):
        for kw, item in (({"backend": "auto"}, "item 7"),
                         ({"tune": True}, "item 7"),
                         ({"shards": 2}, "items 3.4 and 10"),
                         ({"plan_cache_dir": "pc"}, "item 7")):
            with pytest.raises(NotImplementedError, match=item):
                cls.from_edges(c.src, c.dst, c.num_nodes, device="cpu", **kw)
    bfs = _port("bfs", "powerlaw", "torch")[0]
    with pytest.raises(NotImplementedError, match="items 3.5 and 8"):
        bfs.report()
    with pytest.raises(ValueError, match="unknown driver"):
        bfs._converge(torch.zeros(c.num_nodes, dtype=torch.int32), None,
                      driver="jit")
    assert apps.BFS is graphs.BFS and apps.SSSP is graphs.SSSP


def test_bfs_levels_are_int32_end_to_end():
    """Int32 levels survive both backends without a float roundtrip."""
    big = np.int32(2 ** 24 + 1)            # not representable in float32
    for backend in BACKENDS:
        app = graphs.BFS.from_edges(np.asarray([0]), np.asarray([1]), 2,
                                    lane_width=8, backend=backend,
                                    device="cpu")
        out = app.sweep(torch.as_tensor(np.asarray([big, big + 7],
                                                   np.int32)))
        assert out.dtype == torch.int32 and int(out[1]) == big + 1
