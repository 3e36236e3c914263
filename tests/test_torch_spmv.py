"""``repro_torch`` SpMV end to end, against the reference and against itself.

* Against the JAX package's ``SpMV`` on ``backend="jax"`` and on
  ``backend="pallas"`` (interpret) under the reference's own rule: exact
  for int32 and min/max, ``allclose(rtol=1e-5, atol=1e-6)`` for float
  add/mul (the reference's Pallas ``FULL_REDUCE`` is a native reduce of
  unspecified order, and its XLA program may contract the combine into
  the ladder, so float results are not pinned across the two packages).
* On the reference's own plan, carried over by ``convert.plan_from_arrays``.
* Inside the port, bitwise: fused == per-class, coalesced == uncoalesced,
  and the ``cuda`` backend (plain versions on the CPU) == ``torch``.

Everything runs on the CPU (``device="cpu"``), at lanes 8 and 16.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import apps as rapps
from repro.core import engine as reng
from repro.core.plan import CostModel as RCostModel
from repro.core.plan import build_plan as rbuild_plan
from repro.core.seed import reduce_identity_for as rreduce_identity_for
from repro.core.seed import spmv_seed as rspmv_seed
from repro.sparse import generators as G

from repro_torch import convert
from repro_torch.core import engine as eng
from repro_torch.core import ir
from repro_torch.core.apps import SpMV
from repro_torch.core.plan import CostModel, build_plan
from repro_torch.core.seed import reduce_identity_for, spmv_seed

GENS = {"banded": lambda: G.banded(256, 5),
        "powerlaw": lambda: G.power_law(512, 6),
        "blockdiag": lambda: G.block_diag(256, 16),
        "dense": lambda: G.dense(48)}
SEMIRINGS = [("add", np.float32), ("mul", np.float32), ("min", np.int32),
             ("max", np.int32)]


@functools.lru_cache(maxsize=None)
def _matrix(gen):
    return GENS[gen]()


def _x(m, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(np.dtype(dtype), np.integer):
        return rng.integers(-5, 6, m.shape[1]).astype(dtype)
    return rng.standard_normal(m.shape[1]).astype(dtype)


def _assert_rule(got, want, reduce="add", dtype=np.float32):
    if np.issubdtype(np.dtype(dtype), np.integer) or reduce in ("min", "max"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _args(m):
    return (np.asarray(m.rows), np.asarray(m.cols), np.asarray(m.vals),
            m.shape)


@functools.lru_cache(maxsize=None)
def _reference_y(gen, lane, ref_backend, fused, coalesce):
    m = _matrix(gen)
    sp = rapps.SpMV.from_coo(*_args(m), lane_width=lane, backend=ref_backend,
                             fused=fused, coalesce=coalesce)
    return np.asarray(sp.matvec(jnp.asarray(_x(m))))


@functools.lru_cache(maxsize=None)
def _port_y(gen, lane, backend, fused, coalesce):
    m = _matrix(gen)
    sp = SpMV.from_coo(*_args(m), lane_width=lane, backend=backend,
                       fused=fused, coalesce=coalesce, device="cpu")
    return sp.matvec(_x(m)).numpy()


@pytest.mark.parametrize("coalesce", [False, True])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("lane", [8, 16])
@pytest.mark.parametrize("gen", ["banded", "powerlaw", "blockdiag"])
def test_spmv_vs_reference_jax(gen, lane, backend, fused, coalesce):
    _assert_rule(_port_y(gen, lane, backend, fused, coalesce),
                 _reference_y(gen, lane, "jax", fused, coalesce))


@pytest.mark.parametrize("coalesce", [False, True])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("gen", ["banded", "powerlaw"])
def test_spmv_cuda_vs_reference_pallas(gen, fused, coalesce):
    """The port's kernel backend against the reference's Pallas backend
    (interpret mode), matvec for matvec."""
    _assert_rule(_port_y(gen, 16, "cuda", fused, coalesce),
                 _reference_y(gen, 16, "pallas", fused, coalesce))


@pytest.mark.parametrize("reduce,dtype", SEMIRINGS)
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_semiring_executor_vs_reference(backend, reduce, dtype):
    """Every reduce through ``make_executor`` against the reference's
    executor on its XLA backend, from identity-filled outputs."""
    m = _matrix("powerlaw")
    access = {"row": np.asarray(m.rows), "col": np.asarray(m.cols)}
    rng = np.random.default_rng(3)
    if np.issubdtype(np.dtype(dtype), np.integer):
        vals = rng.integers(-5, 6, m.nnz).astype(dtype)
    else:
        vals = rng.standard_normal(m.nnz).astype(dtype)
    x = _x(m, dtype)
    rplan = rbuild_plan(rspmv_seed(reduce), access, m.shape[0], m.shape[1],
                        RCostModel(lane_width=16))
    plan = build_plan(spmv_seed(reduce), access, m.shape[0], m.shape[1],
                      CostModel(lane_width=16))
    y0 = np.full(m.shape[0], rreduce_identity_for(reduce, dtype), dtype)
    ref = reng.make_executor(rplan, {"value": vals}, backend="jax")(
        {"x": jnp.asarray(x)}, jnp.asarray(y0))
    got = eng.make_executor(plan, {"value": vals}, backend=backend,
                            device="cpu")({"x": torch.as_tensor(x)},
                                          torch.as_tensor(y0))
    _assert_rule(got.numpy(), np.asarray(ref), reduce, dtype)


def test_from_csr_vs_reference():
    m = _matrix("banded")
    indptr = np.r_[0, np.cumsum(np.bincount(m.rows, minlength=m.shape[0]))]
    x = _x(m)
    ref = rapps.SpMV.from_csr(indptr, np.asarray(m.cols), np.asarray(m.vals),
                              m.shape, lane_width=16)
    for backend in ("torch", "cuda"):
        got = SpMV.from_csr(indptr, np.asarray(m.cols), np.asarray(m.vals),
                            m.shape, lane_width=16, backend=backend,
                            device="cpu")
        _assert_rule(got.matvec(x).numpy(),
                     np.asarray(ref.matvec(jnp.asarray(x))))
        assert dataclasses.asdict(got.validation) == \
            dataclasses.asdict(ref.validation)


def test_validate_repair_vs_reference():
    """Out-of-range, non-finite and duplicate entries repaired the same
    way, and the repaired matrix multiplies the same."""
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 40, 400)
    cols = rng.integers(0, 50, 400)
    vals = rng.standard_normal(400).astype(np.float32)
    rows[[1, 7]] = [40, -3]
    vals[[2, 9]] = [np.nan, np.inf]
    rows = np.r_[rows, rows[20:40]]
    cols = np.r_[cols, cols[20:40]]
    vals = np.r_[vals, vals[20:40]]
    x = rng.standard_normal(50).astype(np.float32)
    ref = rapps.SpMV.from_coo(rows, cols, vals, (40, 50), lane_width=8,
                              validate="repair")
    for backend in ("torch", "cuda"):
        got = SpMV.from_coo(rows, cols, vals, (40, 50), lane_width=8,
                            backend=backend, validate="repair",
                            device="cpu")
        assert dataclasses.asdict(got.validation) == \
            dataclasses.asdict(ref.validation)
        _assert_rule(got.matvec(x).numpy(),
                     np.asarray(ref.matvec(jnp.asarray(x))))


def _fields_of(rplan):
    """A reference BlockPlan as the plain arrays and scalars
    ``plan_from_arrays`` takes."""
    fields = {f: getattr(rplan, f) for f in (
        "lane_width", "nnz", "out_len", "data_len", "num_blocks",
        "window_ids", "lane_slot", "lane_offset", "seg_ids", "gather_idx",
        "valid", "flat_perm", "head_pos", "head_rows")}
    fields["classes"] = [(c.ls_flag, c.op_flag, c.stream, c.start, c.stop)
                         for c in rplan.classes]
    fields["stats"] = dataclasses.asdict(rplan.stats)
    return fields


@pytest.mark.parametrize("fused,coalesce", [(True, False), (True, True),
                                            (False, True)])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("gen", ["banded", "powerlaw"])
def test_port_runs_the_reference_plan(gen, backend, fused, coalesce):
    """The port executes the reference's own plan (carried across as
    arrays, independently of the port's planner) to the reference's
    result."""
    m = _matrix(gen)
    access = {"row": np.asarray(m.rows), "col": np.asarray(m.cols)}
    rplan = rbuild_plan(rspmv_seed(), access, m.shape[0], m.shape[1],
                        RCostModel(lane_width=16))
    plan = convert.plan_from_arrays(_fields_of(rplan), spmv_seed())
    x = _x(m)
    run = eng.make_executor(plan, {"value": np.asarray(m.vals)},
                            backend=backend, fused=fused, coalesce=coalesce,
                            device="cpu")
    got = run({"x": torch.as_tensor(x)}, torch.zeros(m.shape[0])).numpy()
    _assert_rule(got, _reference_y(gen, 16, "jax", fused, coalesce))


def test_plan_from_arrays_rejects_malformed_fields():
    m = _matrix("banded")
    access = {"row": np.asarray(m.rows), "col": np.asarray(m.cols)}
    fields = _fields_of(rbuild_plan(rspmv_seed(), access, m.shape[0],
                                    m.shape[1], RCostModel(lane_width=8)))
    for bad in ({"seg_ids": fields["seg_ids"][:, :4]},
                {"lane_slot": fields["lane_slot"].astype(np.float32)},
                {"classes": fields["classes"][:-1]}):
        with pytest.raises(ValueError):
            convert.plan_from_arrays({**fields, **bad}, spmv_seed())
    with pytest.raises(ValueError, match="missing"):
        convert.plan_from_arrays({k: v for k, v in fields.items()
                                  if k != "head_pos"}, spmv_seed())


@pytest.mark.parametrize("reduce,dtype", SEMIRINGS)
@pytest.mark.parametrize("lane", [8, 12, 16])
@pytest.mark.parametrize("gen", sorted(GENS))
def test_in_port_bitwise_pins(gen, lane, reduce, dtype):
    """fused == per-class, coalesced == uncoalesced, and cuda == torch,
    bitwise, for every reduce — at power-of-two lanes and at 12, where
    ``FULL_REDUCE``'s halving tree pads odd levels with the identity."""
    m = _matrix(gen)
    access = {"row": np.asarray(m.rows), "col": np.asarray(m.cols)}
    plan = build_plan(spmv_seed(reduce), access, m.shape[0], m.shape[1],
                      CostModel(lane_width=lane))
    rng = np.random.default_rng(9)
    if np.issubdtype(np.dtype(dtype), np.integer):
        vals = rng.integers(-5, 6, m.nnz).astype(dtype)
    else:
        vals = rng.standard_normal(m.nnz).astype(dtype)
    x = torch.as_tensor(_x(m, dtype))
    y0 = torch.full((m.shape[0],), reduce_identity_for(reduce, dtype).item(),
                    dtype=x.dtype)
    elem = eng.reorder_static(plan, {"value": vals}, "cpu")
    outs = {}
    for backend in ("torch", "cuda"):
        for fused in (False, True):
            for coalesce in (False, True):
                run = eng.make_executor(plan, {}, backend=backend,
                                        fused=fused, coalesce=coalesce,
                                        elem_exec=elem, device="cpu")
                outs[backend, fused, coalesce] = run({"x": x}, y0)
    ref = outs["torch", True, False]
    for key, y in outs.items():
        assert torch.equal(y.view(torch.int32), ref.view(torch.int32)), key


def test_coalesced_launches_fire():
    """Non-vacuous: the structured matrices do lower to dense slices, and
    the power-law one keeps gather-fallback blocks."""
    for gen in ("banded", "blockdiag", "dense"):
        m = _matrix(gen)
        plan = build_plan(spmv_seed(), {"row": np.asarray(m.rows),
                                        "col": np.asarray(m.cols)},
                          m.shape[0], m.shape[1], CostModel(lane_width=16))
        tree = ir.lower(plan, backend="cuda", coalesce=True)
        assert any(la.gather == ir.COALESCED for la in tree.launches), gen


def test_degenerate_inputs():
    """An empty matrix and a single-row matrix flow through both backends
    without special casing."""
    empty = np.zeros(0, np.int64)
    for backend in ("torch", "cuda"):
        sp = SpMV.from_coo(empty, empty, np.zeros(0, np.float32), (8, 8),
                           lane_width=8, backend=backend, device="cpu")
        np.testing.assert_array_equal(sp.matvec(np.zeros(8, np.float32)),
                                      np.zeros(8, np.float32))
        vals = np.arange(1.0, 6.0, dtype=np.float32)
        sp1 = SpMV.from_coo(np.zeros(5, np.int64), np.arange(5), vals,
                            (1, 5), lane_width=8, backend=backend,
                            device="cpu")
        np.testing.assert_allclose(sp1.matvec(np.ones(5, np.float32)),
                                   [vals.sum()], rtol=1e-6)


def test_not_yet_ported_options_raise():
    """Sharding is ported; what still raises is what the reference refuses
    too: the single-device ``cuda`` backend with ``shards=``, an explicit
    ``mesh`` with the tuner, and a batched ``matvec_many`` on a sharded
    SpMV."""
    from repro_torch.launch.mesh import make_shard_mesh
    m = _matrix("banded")
    mesh = make_shard_mesh(2, device="cpu", simulate=True)
    for kw, err, match in (
            ({"shards": 2, "simulate_mesh": True, "backend": "cuda"},
             ValueError, "single-device"),
            ({"mesh": mesh, "backend": "cuda"}, ValueError, "single-device"),
            ({"mesh": mesh, "backend": "auto"}, ValueError, "mesh"),
            ({"mesh": mesh, "tune": True}, ValueError, "mesh")):
        with pytest.raises(err, match=match):
            SpMV.from_coo(*_args(m), device="cpu", **kw)
    sharded = SpMV.from_coo(*_args(m), lane_width=8, mesh=mesh, device="cpu")
    with pytest.raises(NotImplementedError, match="matvec_many"):
        sharded.matvec_many(np.stack([_x(m), _x(m, seed=1)]))
    sp = SpMV.from_coo(*_args(m), lane_width=8, device="cpu")
    assert sp.report().totals["launches"] == len(sp._run.tree.launches)


def test_matvec_checks_the_device_of_x():
    m = _matrix("banded")
    sp = SpMV.from_coo(*_args(m), lane_width=8, device="cpu")
    y = sp.matvec(torch.as_tensor(_x(m)))
    assert y.device.type == "cpu" and y.shape == (m.shape[0],)
    assert sp.matvec(_x(m)).dtype == torch.float32


@pytest.mark.parametrize("reduce,dtype", SEMIRINGS)
def test_dense_stage_b_and_oracle(reduce, dtype):
    """The opt-in ``stage_b="dense"`` write-back and the port's
    ``reference_execute`` scatter oracle agree with the default gather
    write-back under the reference's rule."""
    from repro_torch.core.seed import reference_execute
    m = _matrix("powerlaw")
    access = {"row": np.asarray(m.rows), "col": np.asarray(m.cols)}
    plan = build_plan(spmv_seed(reduce), access, m.shape[0], m.shape[1],
                      CostModel(lane_width=16))
    rng = np.random.default_rng(4)
    if np.issubdtype(np.dtype(dtype), np.integer):
        vals = rng.integers(-5, 6, m.nnz).astype(dtype)
    else:
        vals = rng.standard_normal(m.nnz).astype(dtype)
    x = torch.as_tensor(_x(m, dtype))
    y0 = torch.full((m.shape[0],), reduce_identity_for(reduce, dtype).item(),
                    dtype=x.dtype)
    ys = [eng.make_executor(plan, {"value": vals}, backend=backend,
                            stage_b=stage_b, device="cpu")({"x": x}, y0)
          for backend in ("torch", "cuda") for stage_b in ("gather", "dense")]
    oracle = reference_execute(plan.seed, access,
                               {"x": x, "value": torch.as_tensor(vals)}, y0)
    for y in ys[1:] + [oracle]:
        _assert_rule(y.numpy(), ys[0].numpy(), reduce, dtype)


def test_tree_sum_and_state_healthy_match_the_reference():
    rng = np.random.default_rng(6)
    for n in (0, 1, 7, 128, 1000):
        v = rng.standard_normal(n).astype(np.float32)
        assert np.asarray(reng.tree_sum(jnp.asarray(v))).tobytes() == \
            eng.tree_sum(torch.as_tensor(v)).numpy().tobytes()
    states = [np.array([1.0, 2.0], np.float32),
              np.array([1.0, np.nan], np.float32),
              np.array([np.inf, 1.0], np.float32),
              np.array([-np.inf, 1.0], np.float32),
              np.array([3, 4], np.int32)]
    for st in states:
        for reduce in ("add", "mul", "min", "max"):
            assert bool(reng.state_healthy(jnp.asarray(st), reduce)) == \
                bool(eng.state_healthy(torch.as_tensor(st), reduce))


# x dtypes other than the values' float32: the rule each is held to against
# the reference (which returns x's dtype too).  float16 results carry
# float16's own rounding (a unit roundoff of 2**-11), so they are held to
# 2**-10 relative.
X_DTYPES = {np.float64: dict(rtol=1e-5, atol=1e-6),
            np.float16: dict(rtol=2 ** -10, atol=2 ** -10),
            np.int32: dict(rtol=0, atol=0)}


@pytest.mark.parametrize("xdtype", list(X_DTYPES), ids=lambda d: d.__name__)
@pytest.mark.parametrize("coalesce", [False, True])
@pytest.mark.parametrize("gen", ["banded", "dense"])
def test_cuda_backend_takes_every_x_dtype(gen, coalesce, xdtype):
    """ROADMAP queue 3, fault 3: float32 values with a float64, float16 or
    int32 ``x`` run on the kernel backend (each operand cast to the
    promoted dtype before the launches), bitwise equal to the torch
    backend, in ``x``'s dtype, and close to the reference."""
    m = _matrix(gen)
    vals = np.asarray(m.vals, np.float32)
    rng = np.random.default_rng(11)
    x = (rng.integers(-5, 6, m.shape[1]) if xdtype == np.int32
         else rng.standard_normal(m.shape[1])).astype(xdtype)
    ys = {}
    for backend in ("torch", "cuda"):
        sp = SpMV.from_coo(m.rows, m.cols, vals, m.shape, lane_width=8,
                           backend=backend, coalesce=coalesce, device="cpu")
        ys[backend] = sp.matvec(x)
    assert ys["cuda"].dtype == torch.as_tensor(x).dtype
    assert ys["cuda"].numpy().tobytes() == ys["torch"].numpy().tobytes()
    ref = rapps.SpMV.from_coo(m.rows, m.cols, vals, m.shape, lane_width=8,
                              coalesce=coalesce).matvec(jnp.asarray(x))
    np.testing.assert_allclose(ys["cuda"].numpy().astype(np.float64),
                               np.asarray(ref).astype(np.float64),
                               **X_DTYPES[xdtype])

