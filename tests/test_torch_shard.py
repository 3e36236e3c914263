"""``repro_torch`` sharded execution (DESIGN.md §10) against the reference
and against itself, in one process on the CPU.

* ``ir.partition_plan``: every ``PlanShard`` field (row range, block ids,
  every sliced ``BlockPlan`` array, every ``Launch`` field, provenance)
  exactly equal to the JAX package's over the generator corpus x
  k in {1, 2, 3, 4, 8} x ``fused`` x ``coalesce``; the partition
  invariants, single-row and empty shards, bad arguments, and a
  hypothesis property (mirrors of ``tests/test_shard.py``).
* The mesh surface of ``repro_torch.launch.mesh``: too few devices raises
  and names the simulation recipe, a subset drop raises unless opted in,
  a non-trivial model axis is refused, ``resolve_shard_mesh``.
* Sharded SpMV, SpMM (every semiring), BFS, SSSP, CC and PageRank on a
  simulated mesh (every shard on the CPU), with both drivers and the
  ``torch`` and ``segsum`` backends: bitwise equal to the port's
  single-device run of the same backend (states, sweep counts and
  ``ConvergenceReport``), and within the reference's rule
  (``tests/test_pallas.py``: exact for min/max and int32,
  ``allclose(rtol=1e-5, atol=1e-6)`` for float add/mul) of the reference's
  single-device run.  The reference's *sharded* run is never compared: at
  8 shards it is not bitwise its own single-device run on jax 0.9.0.
* What still raises, and the tuner's shard axis.

No subprocess, no ``torch.distributed``, no environment variable.
"""
import dataclasses
import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import apps as rapps
from repro.core import graphs as rgraphs
from repro.core import ir as rir
from repro.core.plan import CostModel as RCostModel
from repro.core.plan import build_plan as rbuild_plan
from repro.core.seed import spmv_seed as rspmv_seed
from repro.core.spmm import SpMM as RSpMM
from repro.sparse import generators as RG
from repro.tune import cost as rcost
from repro.tune import space as rspace

from repro_torch.core import apps, graphs, ir
from repro_torch.core import engine as eng
from repro_torch.core.plan import CostModel, build_plan
from repro_torch.core.seed import spmv_seed
from repro_torch.core.spmm import SpMM
from repro_torch.launch import mesh as lmesh
from repro_torch.launch.sharding import row_sharding
from repro_torch.sparse import generators as G
from repro_torch.tune import cost as tcost
from repro_torch.tune import space as tspace

LANE = 32
KS = (1, 2, 3, 4, 8)
CPU = torch.device("cpu")
_PLAN_FIELDS = ("lane_width", "nnz", "out_len", "data_len", "num_blocks",
                "window_ids", "lane_slot", "lane_offset", "seg_ids",
                "gather_idx", "valid", "flat_perm", "head_pos", "head_rows")


def _empty(g, n=64):
    m = g.dense(4, seed=0)
    return dataclasses.replace(m, rows=m.rows[:0], cols=m.cols[:0],
                               vals=m.vals[:0], shape=(n, n), name="empty")


def _corpus(g):
    return [*g.suite("small"), _empty(g)]


NAMES = [m.name for m in _corpus(G)]


@functools.lru_cache(maxsize=None)
def _matrix(name):
    return {m.name: m for m in _corpus(G)}[name]


@functools.lru_cache(maxsize=None)
def _plans(name, lane=LANE):
    ref = {m.name: m for m in _corpus(RG)}[name]
    m = _matrix(name)
    return (rbuild_plan(rspmv_seed(), {"row": ref.rows, "col": ref.cols},
                        ref.shape[0], ref.shape[1],
                        RCostModel(lane_width=lane)),
            build_plan(spmv_seed(), {"row": m.rows, "col": m.cols},
                       m.shape[0], m.shape[1], CostModel(lane_width=lane)))


def _equal(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a is not None and b is not None, what
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b), what
    else:
        assert a == b, what


def _assert_shard_equal(ref, got, ref_backend, backend):
    what = f"shard {got.index}/{got.num_shards}"
    assert (ref.index, ref.num_shards, ref.row_start, ref.row_stop) == \
        (got.index, got.num_shards, got.row_start, got.row_stop), what
    _equal(ref.block_ids, got.block_ids, what + " block_ids")
    rt, gt = ref.tree, got.tree
    assert (rt.backend, gt.backend) == (ref_backend, backend)
    assert rt.stage_b == gt.stage_b
    assert rt.passes == gt.passes and rt.pass_deltas == gt.pass_deltas
    for f in _PLAN_FIELDS:
        _equal(getattr(rt.plan, f), getattr(gt.plan, f), f"{what} {f}")
    assert [dataclasses.astuple(c) for c in rt.plan.classes] == \
        [dataclasses.astuple(c) for c in gt.plan.classes], what
    assert dataclasses.asdict(rt.plan.stats) == \
        dataclasses.asdict(gt.plan.stats), what
    assert len(rt.launches) == len(gt.launches), what
    for rl, gl in zip(rt.launches, gt.launches):
        for f in dataclasses.fields(rl):
            ra, ga = getattr(rl, f.name), getattr(gl, f.name)
            if ra is None or ga is None:
                assert ra is None and ga is None, f"{what} {f.name}"
            else:
                _equal(ra, ga, f"{what} launch {f.name}")


def _check_partition(tree, k: int):
    """The partition invariants for one lowered tree and shard count."""
    parts = ir.partition_plan(tree, k)
    parent = tree.plan
    n = parent.out_len
    assert len(parts) == k
    assert parts[0].row_start == 0 and parts[-1].row_stop == n
    for a, b in zip(parts, parts[1:]):
        assert a.row_stop == b.row_start
    all_ids = np.concatenate([p.block_ids for p in parts])
    assert np.array_equal(np.sort(all_ids), np.arange(parent.num_blocks))
    for p in parts:
        assert 0 <= p.row_start <= p.row_stop <= n
        assert p.block_ids.size < 2 or np.all(np.diff(p.block_ids) > 0)
        covered = np.concatenate(
            [np.arange(la.start, la.stop) for la in p.tree.launches]) \
            if p.tree.launches else np.arange(0)
        assert np.array_equal(covered, np.arange(p.num_blocks))
        hp = p.tree.plan
        if hp.head_rows.size:
            assert hp.head_rows.min() >= 0
            assert hp.head_rows.max() < max(p.num_rows, 1)
        assert hp.out_len == p.num_rows
    return parts


# ------------------------------------------------- partition_plan vs ref
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_class"])
@pytest.mark.parametrize("name", NAMES)
def test_plan_shards_equal_reference(name, fused):
    rplan, plan = _plans(name)
    for coalesce in (False, True):
        rtree = rir.lower(rplan, backend="jax", fused=fused,
                          coalesce=coalesce)
        tree = ir.lower(plan, backend="torch", fused=fused,
                        coalesce=coalesce)
        for k in KS:
            ref, got = rir.partition_plan(rtree, k), _check_partition(tree,
                                                                      k)
            assert len(ref) == len(got) == k
            for r, g in zip(ref, got):
                _assert_shard_equal(r, g, "jax", "torch")


@pytest.mark.parametrize("name", ["powerlaw", "banded", "empty"])
def test_segsum_plan_shards_equal_reference(name):
    rplan, plan = _plans(name)
    rtree = rir.lower(rplan, backend="segsum")
    tree = ir.lower(plan, backend="segsum")
    for k in (2, 8):
        for r, g in zip(rir.partition_plan(rtree, k),
                        ir.partition_plan(tree, k)):
            _assert_shard_equal(r, g, "segsum", "segsum")


def test_partition_single_row_shards():
    # lane_width == row length: one block per row, so every row boundary
    # is a legal cut and k == n yields single-row shards
    m = G.dense(4, seed=0)
    plan = build_plan(spmv_seed(), {"row": m.rows, "col": m.cols}, 4, 4,
                      CostModel(lane_width=4))
    parts = _check_partition(ir.lower(plan, backend="torch"), 4)
    assert [p.num_rows for p in parts] == [1, 1, 1, 1]


def test_partition_empty_shards():
    # more shards than legal cuts: the tail shards are empty, and empty
    # shards still carry well-formed (zero-row) plans
    m = G.dense(3, seed=0)            # one block, no interior legal cut
    plan = build_plan(spmv_seed(), {"row": m.rows, "col": m.cols}, 3, 3,
                      CostModel(lane_width=LANE))
    parts = _check_partition(ir.lower(plan, backend="torch"), 8)
    assert sum(p.num_rows for p in parts) == 3
    assert any(p.num_rows == 0 for p in parts)


def test_partition_rejects_bad_args():
    _, plan = _plans("dense")
    with pytest.raises(ValueError, match="shards must be >= 1"):
        ir.partition_plan(ir.lower(plan, backend="torch"), 0)
    with pytest.raises(ValueError, match="single-device"):
        ir.partition_plan(ir.lower(plan, backend="cuda"), 2)


def test_partition_property_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=30, deadline=None)
    @given(nnz=st.integers(0, 300), out_len=st.integers(1, 80),
           data_len=st.integers(1, 100), lane=st.sampled_from([4, 8, 32]),
           k=st.integers(1, 9), seed_int=st.integers(0, 2 ** 31 - 1))
    def prop(nnz, out_len, data_len, lane, k, seed_int):
        rng = np.random.default_rng(seed_int)
        rows = rng.integers(0, out_len, size=nnz)
        cols = rng.integers(0, data_len, size=nnz)
        plan = build_plan(spmv_seed(), {"row": rows, "col": cols}, out_len,
                          data_len, CostModel(lane_width=lane))
        rplan = rbuild_plan(rspmv_seed(), {"row": rows, "col": cols},
                            out_len, data_len, RCostModel(lane_width=lane))
        got = _check_partition(ir.lower(plan, backend="torch"), k)
        ref = rir.partition_plan(rir.lower(rplan, backend="jax"), k)
        for r, g in zip(ref, got):
            _assert_shard_equal(r, g, "jax", "torch")

    prop()


# ----------------------------------------------------------- the mesh
def test_make_local_mesh_rejects_oversubscription():
    with pytest.raises(ValueError, match="only 1 exist"):
        lmesh.make_local_mesh(data=2, model=1, device="cpu")
    mesh = lmesh.make_local_mesh(device="cpu")
    assert mesh.devices == (CPU,) and lmesh.shard_count(mesh) == 1


def test_make_shard_mesh_names_simulation_recipe():
    with pytest.raises(ValueError, match="simulate=True"):
        lmesh.make_shard_mesh(2, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        lmesh.make_shard_mesh(0, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        lmesh.make_shard_mesh(0, device="cpu", simulate=True)
    mesh = lmesh.make_shard_mesh(3, device="cpu", simulate=True)
    assert mesh.simulated and mesh.devices == (CPU,) * 3
    assert mesh.shape == {"data": 3, "model": 1}
    assert row_sharding(mesh) == (CPU,) * 3
    # a real mesh never repeats a device
    real = lmesh.make_shard_mesh(1, device="cpu")
    assert not real.simulated and real.devices == (CPU,)


def test_local_mesh_subset_drop_raises(monkeypatch):
    cards = [torch.device("cuda", i) for i in range(8)]
    monkeypatch.setattr(lmesh, "visible_devices", lambda kind: cards)
    with pytest.raises(ValueError, match="dropping"):
        lmesh.make_local_mesh(data=2, model=1)
    mesh = lmesh.make_local_mesh(data=2, model=1, allow_subset=True)
    assert lmesh.shard_count(mesh) == 2 and mesh.devices == tuple(cards[:2])
    four = lmesh.make_shard_mesh(4)
    assert row_sharding(four) == tuple(cards[:4])
    grid = lmesh.make_local_mesh(data=4, model=2)
    assert row_sharding(grid) == tuple(cards[0:8:2])
    with pytest.raises(ValueError, match="only 8"):
        lmesh.make_shard_mesh(16)


def test_mesh_with_a_model_axis_is_refused():
    _, plan = _plans("banded")
    parts = ir.partition_plan(ir.lower(plan, backend="torch"), 2)
    grid = lmesh.ShardMesh(devices=(CPU,) * 4, data=2, model=2)
    with pytest.raises(ValueError, match="non-trivial model axis"):
        eng.make_sharded_executor(parts, {"value": np.ones(plan.nnz)}, grid)
    with pytest.raises(ValueError, match="must match the mesh"):
        eng.make_sharded_executor(
            parts, {}, lmesh.make_shard_mesh(3, device="cpu", simulate=True))
    with pytest.raises(ValueError, match="4 devices"):
        lmesh.ShardMesh(devices=(CPU,) * 4, data=2)


def test_resolve_shard_mesh_surface():
    assert lmesh.resolve_shard_mesh(None, None, "cpu") == (None, 1)
    mesh, k = lmesh.resolve_shard_mesh(None, 1, "cpu")
    assert k == 1 and mesh is not None and not mesh.simulated
    with pytest.raises(ValueError, match="does not match"):
        lmesh.resolve_shard_mesh(mesh, 2, "cpu")
    sim, k = lmesh.resolve_shard_mesh(None, 4, "cpu", simulate=True)
    assert k == 4 and sim.simulated
    assert lmesh.resolve_shard_mesh(sim, 4, "cpu") == (sim, 4)
    with pytest.raises(ValueError, match="needs shards"):
        lmesh.resolve_shard_mesh(None, None, "cpu", simulate=True)
    with pytest.raises(ValueError, match="explicit mesh"):
        lmesh.resolve_shard_mesh(sim, None, "cpu", simulate=True)


# ----------------------------------------------------- sharded SpMV / SpMM
def _x(m, dtype=np.float32, seed=0, d=None):
    rng = np.random.default_rng(seed)
    shape = (m.shape[1],) if d is None else (m.shape[1], d)
    if np.issubdtype(np.dtype(dtype), np.integer):
        return rng.integers(-5, 6, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _coo(m, vals=None):
    return (np.asarray(m.rows), np.asarray(m.cols),
            np.asarray(m.vals if vals is None else vals), m.shape)


def _rule(got, want, reduce="add", dtype=np.float32):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if np.issubdtype(np.dtype(dtype), np.integer) or reduce in ("min", "max"):
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def _sim(k):
    """SpMV/SpMM's simulated ``k``-shard mesh on the CPU."""
    return dict(shards=k, simulate_mesh=True, device="cpu")


def _mesh(k):
    """A graph app's simulated ``k``-shard mesh on the CPU."""
    return dict(mesh=lmesh.make_shard_mesh(k, device="cpu", simulate=True),
                device="cpu")


def _live(app) -> int:
    """Shards that own at least one row."""
    return sum(p.num_rows > 0 for p in app._shard_parts)


def test_shards_one_bitwise():
    m = G.power_law(256, seed=3)
    vals = m.vals.astype(np.float32)
    x = torch.as_tensor(_x(m))
    ref = apps.SpMV.from_coo(*_coo(m, vals), lane_width=LANE,
                             device="cpu").matvec(x)
    a = apps.SpMV.from_coo(*_coo(m, vals), lane_width=LANE, shards=1,
                           device="cpu")
    assert a.mesh is not None and len(a._shard_parts) == 1
    assert not a.mesh.simulated
    assert torch.equal(a.matvec(x), ref)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_spmv_bitwise(name):
    m = _matrix(name)
    vals = np.asarray(m.vals, np.float32)
    x = _x(m)
    single = apps.SpMV.from_coo(*_coo(m, vals), lane_width=LANE,
                                device="cpu").matvec(x)
    for k in (2, 3, 4, 8):
        app = apps.SpMV.from_coo(*_coo(m, vals), lane_width=LANE, **_sim(k))
        assert app.mesh.shape["data"] == k and len(app._shard_parts) == k
        assert torch.equal(app.matvec(x), single), k
    ref = rapps.SpMV.from_coo(*_coo(m, vals), lane_width=LANE).matvec(
        jnp.asarray(x))
    _rule(single, ref)


@pytest.mark.parametrize("coalesce", [False, True])
def test_sharded_spmv_lowerings_bitwise(coalesce):
    m = G.banded(512, band=13, seed=2)
    vals = m.vals.astype(np.float32)
    x = _x(m)
    for fused in (True, False):
        kw = dict(lane_width=LANE, fused=fused, coalesce=coalesce)
        single = apps.SpMV.from_coo(*_coo(m, vals), device="cpu",
                                    **kw).matvec(x)
        got = apps.SpMV.from_coo(*_coo(m, vals), **kw, **_sim(4)).matvec(x)
        assert torch.equal(got, single), fused


def test_sharded_segsum_backend_bitwise():
    m = G.banded(512, band=13, seed=2)
    vals = m.vals.astype(np.float32)
    x = _x(m)
    single = apps.SpMV.from_coo(*_coo(m, vals), lane_width=LANE,
                                backend="segsum", device="cpu").matvec(x)
    for k in (2, 4, 8):
        got = apps.SpMV.from_coo(*_coo(m, vals), lane_width=LANE,
                                 backend="segsum", **_sim(k)).matvec(x)
        assert torch.equal(got, single), k
    ref = rapps.SpMV.from_coo(*_coo(m, vals), lane_width=LANE,
                              backend="segsum").matvec(jnp.asarray(x))
    _rule(single, ref)


@pytest.mark.parametrize("reduce,dtype", [("add", np.float32),
                                          ("mul", np.float32),
                                          ("min", np.int32),
                                          ("max", np.int32)])
def test_sharded_spmm_semirings_bitwise(reduce, dtype):
    m = G.power_law(256, seed=4)
    rng = np.random.default_rng(1)
    vals = (rng.integers(-5, 6, m.nnz).astype(dtype)
            if np.issubdtype(np.dtype(dtype), np.integer)
            else m.vals.astype(dtype))
    b = _x(m, dtype, seed=1, d=5)
    for backend in ("torch", "segsum"):
        kw = dict(lane_width=LANE, reduce=reduce, backend=backend)
        single = SpMM.from_coo(*_coo(m, vals), device="cpu", **kw).matmat(b)
        for k in (2, 8):
            got = SpMM.from_coo(*_coo(m, vals), **kw, **_sim(k)).matmat(b)
            assert torch.equal(got, single), (backend, k)
        ref = RSpMM.from_coo(*_coo(m, vals), lane_width=LANE, reduce=reduce,
                             backend="jax" if backend == "torch"
                             else backend).matmat(jnp.asarray(b))
        _rule(single, ref, reduce, dtype)


# ------------------------------------------------------ sharded graph apps
@functools.lru_cache(maxsize=None)
def _case(kind):
    """The suite's graph with its edges sorted by destination: a plan's
    blocks follow the edge order, so only a destination-major list gives
    BFS, SSSP and PageRank row cuts between non-empty shards (a
    source-major one cuts into one full shard and empty ones)."""
    c = {c.name: c for c in G.graph_suite("small")}[kind]
    o = np.lexsort((c.src, c.dst))
    return dataclasses.replace(c, src=c.src[o], dst=c.dst[o],
                               weight=c.weight[o])


def _edges(app, c):
    return ((c.src, c.dst, c.weight, c.num_nodes) if app == "sssp"
            else (c.src, c.dst, c.num_nodes))


def _go(app, obj):
    return obj.run() if app == "cc" else obj.run(0)


APPS = {"bfs": graphs.BFS, "sssp": graphs.SSSP,
        "cc": graphs.ConnectedComponents}
REF_APPS = {"bfs": rgraphs.BFS, "sssp": rgraphs.SSSP,
            "cc": rgraphs.ConnectedComponents}


@pytest.mark.parametrize("kind", ["powerlaw", "uniform", "banded", "ring",
                                  "isolated", "empty"])
def test_sharded_graph_apps_bitwise(kind):
    c = _case(kind)
    for app, cls in APPS.items():
        ref = np.asarray(_go(app, REF_APPS[app].from_edges(
            *_edges(app, c), lane_width=LANE)))
        for backend, driver, ks in (("torch", "resident", (2, 8)),
                                    ("torch", "host", (3,)),
                                    ("segsum", "resident", (4,)),
                                    ("segsum", "host", (2,))):
            single = cls.from_edges(*_edges(app, c), lane_width=LANE,
                                    backend=backend, driver=driver,
                                    device="cpu")
            want = _go(app, single)
            for k in ks:
                got = cls.from_edges(*_edges(app, c), lane_width=LANE,
                                     backend=backend, driver=driver,
                                     **_mesh(k))
                what = (app, backend, driver, k)
                # CC symmetrizes its edges, so no input order sorts its
                # destinations: one full shard, the rest empty
                if app != "cc" and c.num_edges:
                    assert _live(got) >= 2, what
                assert torch.equal(_go(app, got), want), what
                assert got.convergence == single.convergence, what
            np.testing.assert_array_equal(want.numpy(), ref)


def test_sharded_fixpoint_terminal_flags_bitwise():
    """Diverged, exhausted and negative-cycle runs end with the same state,
    sweeps and flags sharded as single-device, with both drivers."""
    src = np.asarray([0, 1, 2, 2, 3, 4])
    dst = np.asarray([1, 2, 0, 3, 4, 5])
    cases = {"negative_cycle": (np.asarray([1.0, -3.0, 1.0, 1.0, 1.0, 1.0],
                                           np.float32), None),
             "diverged": (np.asarray([1.0, 1.0, 1.0, -np.inf, 1.0, 1.0],
                                     np.float32), None),
             "exhausted": (np.ones(6, np.float32), 2)}
    for name, (w, max_sweeps) in cases.items():
        for driver in ("resident", "host"):
            single = graphs.SSSP.from_edges(src, dst, w, 6, lane_width=4,
                                            driver=driver, validate="off",
                                            device="cpu")
            want = single.run(0, max_sweeps=max_sweeps)
            for k in (2, 3):
                got = graphs.SSSP.from_edges(src, dst, w, 6, lane_width=4,
                                             driver=driver, validate="off",
                                             **_mesh(k))
                out = got.run(0, max_sweeps=max_sweeps)
                assert torch.equal(out.view(torch.int32),
                                   want.view(torch.int32)), (name, k)
                assert got.convergence == single.convergence, (name, k)
                assert getattr(got.convergence, name)


def test_sharded_resident_reads_per_chunk(monkeypatch):
    c = _case("ring")
    reads = []
    real = graphs.read_flags
    monkeypatch.setattr(graphs, "read_flags",
                        lambda *f: reads.append(1) or real(*f))
    app = graphs.BFS.from_edges(c.src, c.dst, c.num_nodes, lane_width=LANE,
                                **_mesh(4))
    assert _live(app) >= 2
    app.run(0)
    sweeps = app.convergence.sweeps
    assert sweeps > 2 * graphs.SYNC_EVERY
    assert len(reads) <= -(-sweeps // graphs.SYNC_EVERY) + 1
    assert app._shard_step.devices == row_sharding(app.mesh)


def test_sharded_drivers_share_the_sweep_bodies(monkeypatch):
    """Each live shard's sweep body (its plan arrays staged on its device)
    is built once, by the sharded executor: the resident step runs the
    same bodies, for the graph apps and PageRank alike."""
    c = _case("banded")
    built = []
    real = eng.make_sweeper
    monkeypatch.setattr(eng, "make_sweeper",
                        lambda *a, **kw: built.append(1) or real(*a, **kw))
    builds = {"bfs": lambda: graphs.BFS.from_edges(
                  c.src, c.dst, c.num_nodes, lane_width=LANE, **_mesh(4)),
              "pagerank": lambda: apps.PageRank.from_edges(
                  c.src, c.dst, c.num_nodes, lane_width=LANE, **_mesh(4))}
    for name, build in builds.items():
        built.clear()
        app = build()
        assert _live(app) >= 2 and len(built) == _live(app), name
        for driver in ("resident", "host"):
            app.driver = driver
            app.run() if name == "pagerank" else app.run(0)
        assert len(built) == _live(app), (name, "built again by a run")


def test_sharded_pagerank_bitwise():
    c = _case("powerlaw")       # destination-sorted: several live shards
    src, dst, n = c.src, c.dst, c.num_nodes
    ref = np.asarray(rapps.PageRank.from_edges(src, dst, n,
                                               lane_width=LANE).run(20))
    for backend in ("torch", "segsum"):
        single = apps.PageRank.from_edges(src, dst, n, lane_width=LANE,
                                          backend=backend, device="cpu")
        want = single.run(20)
        assert torch.equal(single.run(20, driver="host"), want)
        for k in (2, 8):
            app = apps.PageRank.from_edges(src, dst, n, lane_width=LANE,
                                           backend=backend, **_mesh(k))
            assert _live(app) >= 2, (backend, k)
            assert torch.equal(app.run(20), want), (backend, k)
            assert torch.equal(app.run(20, driver="host"), want), \
                (backend, k, "host")
        _rule(want, ref)


def test_sharded_report():
    m = G.power_law(256, seed=3)
    app = apps.SpMV.from_coo(*_coo(m, m.vals.astype(np.float32)),
                             lane_width=LANE, **_sim(4))
    rep = app.report()
    assert rep.shards == 4 and rep.backend == "torch"
    assert {row["shard"] for row in rep.launches} <= set(range(4))
    assert rep.totals["launches"] == sum(len(p.tree.launches)
                                         for p in app._shard_parts)
    assert rep.passes[-1] == "partition_plan[0/4]"
    single = apps.SpMV.from_coo(*_coo(m, m.vals.astype(np.float32)),
                                lane_width=LANE, device="cpu").report()
    assert single.shards is None


# ------------------------------------------------------------ the raises
def test_what_still_raises():
    m = G.banded(256, 5)
    vals = m.vals.astype(np.float32)
    c = _case("powerlaw")
    with pytest.raises(ValueError, match="single-device"):
        apps.SpMV.from_coo(*_coo(m, vals), backend="cuda", **_sim(2))
    with pytest.raises(ValueError, match="single-device"):
        graphs.BFS.from_edges(c.src, c.dst, c.num_nodes, backend="cuda",
                              **_mesh(2))
    sp = apps.SpMV.from_coo(*_coo(m, vals), lane_width=LANE, **_sim(2))
    with pytest.raises(NotImplementedError, match="matvec_many"):
        sp.matvec_many(np.ones((3, 256), np.float32))
    bfs = graphs.BFS.from_edges(c.src, c.dst, c.num_nodes, lane_width=LANE,
                                **_mesh(2))
    for driver in ("resident", "host"):
        bfs.driver = driver
        with pytest.raises(NotImplementedError, match="run_multi"):
            bfs.run_multi([0, 1])
    mesh = lmesh.make_shard_mesh(2, device="cpu", simulate=True)
    with pytest.raises(ValueError, match="mesh"):
        apps.SpMV.from_coo(*_coo(m, vals), backend="auto", mesh=mesh,
                           device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        SpMM.from_coo(*_coo(m, vals), backend="auto", mesh=mesh,
                      device="cpu")
    for cls in (graphs.BFS, graphs.ConnectedComponents, apps.PageRank):
        with pytest.raises(ValueError, match="shards"):
            cls.from_edges(c.src, c.dst, c.num_nodes, backend="auto",
                           shards=2, device="cpu")
    with pytest.raises(ValueError, match="simulate=True"):
        apps.SpMV.from_coo(*_coo(m, vals), shards=2, device="cpu")
    with pytest.raises(ValueError, match="simulate=True"):
        apps.SpMV.from_coo(*_coo(m, vals), backend="auto", shards=2,
                           device="cpu")
    with pytest.raises(ValueError, match="needs shards"):
        apps.SpMV.from_coo(*_coo(m, vals), simulate_mesh=True, device="cpu")


# ------------------------------------------------------ the tuner's axis
def test_candidate_space_shard_axis(monkeypatch):
    seed = spmv_seed()
    space = tspace.candidate_space(seed, platform="cpu",
                                   shard_counts=(1, 4), devices=8)
    labels = {c.label for c in space}
    assert any(lbl.endswith("/s4") for lbl in labels)
    assert any(c.shards == 1 for c in space)
    # counts beyond the device budget are filtered, not built: by default
    # the budget is the visible device count (one CPU)
    space = tspace.candidate_space(seed, platform="cpu",
                                   shard_counts=(1, 4))
    assert all(c.shards == 1 for c in space)
    cards = [torch.device("cuda", i) for i in range(8)]
    monkeypatch.setattr(lmesh, "visible_devices", lambda kind: cards)
    space = tspace.candidate_space(seed, platform="cuda",
                                   shard_counts=(1, 4))
    assert any(c.shards == 4 for c in space)
    assert not any(c.backend == "cuda" and c.shards > 1 for c in space)
    assert not tspace.is_valid(tspace.Candidate(backend="cuda", shards=2),
                               seed, "cuda", devices=8)
    assert not tspace.is_valid(tspace.Candidate(shards=16), seed, "cuda")


def test_shard_axis_predictions_equal_reference():
    rplan, plan = _plans("powerlaw")
    space = tspace.candidate_space(spmv_seed(), platform="cpu",
                                   shard_counts=(1, 2, 4), devices=4)
    rspace_ = [c for c in rspace.candidate_space(
        rspmv_seed(), platform="cpu", shard_counts=(1,))]
    rspace_ = [dataclasses.replace(c, shards=k) for k in (1, 2, 4)
               for c in rspace_]
    f, rf = tcost.plan_features(plan), rcost.plan_features(rplan)
    assert len(space) == len(rspace_)
    for c, rc in zip(space, rspace_):
        assert c.shards == rc.shards
        assert tcost.predict_us(c, f, "cpu") == rcost.predict_us(rc, rf,
                                                                 "cpu")


def test_sharded_tuner_axis_measures_and_matches(tmp_path):
    m = G.power_law(256, seed=3)
    vals = m.vals.astype(np.float32)
    x = _x(m)
    ref = rapps.SpMV.from_coo(*_coo(m, vals), lane_width=LANE).matvec(
        jnp.asarray(x))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = apps.SpMV.from_coo(*_coo(m, vals), lane_width=LANE,
                               backend="auto", tune_cache_dir=str(tmp_path),
                               **_sim(4))
    counts = {meas.candidate.shards for meas in a.tuning.measurements}
    assert counts == {1, 4}
    assert (a.mesh is not None) == (a.tuning.best.shards == 4)
    _rule(a.matvec(x), ref)
    warm = apps.SpMV.from_coo(*_coo(m, vals), lane_width=LANE,
                              backend="auto", tune_cache_dir=str(tmp_path),
                              **_sim(4))
    assert warm.tuning.cache_hit and warm.tuning.best == a.tuning.best
    assert torch.equal(warm.matvec(x), a.matvec(x))
    # the simulated mesh is part of the key: an unsharded tune re-measures
    cold = apps.SpMV.from_coo(*_coo(m, vals), lane_width=LANE,
                              backend="auto", tune_cache_dir=str(tmp_path),
                              device="cpu")
    assert not cold.tuning.cache_hit


def test_sharded_spmm_tuner_axis():
    m = G.banded(256, 5)
    vals = m.vals.astype(np.float32)
    b = _x(m, d=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = SpMM.from_coo(*_coo(m, vals), lane_width=LANE, backend="auto",
                          reduce="min", **_sim(2))
    assert {meas.candidate.shards for meas in a.tuning.measurements} == \
        {1, 2}
    single = SpMM.from_coo(*_coo(m, vals), lane_width=LANE, reduce="min",
                           device="cpu").matmat(b)
    assert torch.equal(a.matmat(b), single)
