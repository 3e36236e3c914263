"""``repro_torch`` SpMM and ``SpMV.matvec_many``, against the reference and
against themselves.

* Against the JAX package's ``SpMM.matmat`` on ``backend="jax"`` at
  ``d`` 1 and 8 for the four semirings, and on ``backend="pallas"``
  (interpret) on one small matrix, under the reference's own rule
  (``tests/test_pallas.py``): exact for int32 and min/max,
  ``allclose(rtol=1e-5, atol=1e-6)`` for float add/mul.
* ``matvec_many`` against the reference's ``matvec_many`` under the same
  rule.
* Inside the port, bitwise: fused == per-class, coalesced == uncoalesced,
  cuda (plain versions on the CPU) == torch, column ``d`` of ``matmat`` ==
  ``SpMV.matvec`` of that column, and row ``i`` of ``matvec_many`` ==
  ``matvec(xs[i])``.

Everything runs on the CPU (``device="cpu"``) at lane width 16.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import apps as rapps
from repro.core import spmm as rspmm
from repro.sparse import generators as G

from repro_torch.core.apps import SpMV, bucket_size
from repro_torch.core.spmm import SpMM
from repro_torch.obs import metrics

GENS = {"banded": lambda: G.banded(256, 5),
        "powerlaw": lambda: G.power_law(512, 6)}
SEMIRINGS = [("add", np.float32), ("mul", np.float32), ("min", np.int32),
             ("max", np.int32)]
LANE = 16


@functools.lru_cache(maxsize=None)
def _matrix(gen):
    return GENS[gen]()


def _problem(m, dtype, d, seed=0):
    """Values and a dense (n, d) operand, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    if np.issubdtype(np.dtype(dtype), np.integer):
        return (rng.integers(-5, 6, m.nnz).astype(dtype),
                rng.integers(-5, 6, (m.shape[1], d)).astype(dtype))
    return (rng.standard_normal(m.nnz).astype(dtype),
            rng.standard_normal((m.shape[1], d)).astype(dtype))


def _assert_rule(got, want, reduce, dtype):
    if np.issubdtype(np.dtype(dtype), np.integer) or reduce in ("min", "max"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _coo(m, vals):
    return (np.asarray(m.rows), np.asarray(m.cols), vals, m.shape)


def _port(m, vals, reduce, backend="torch", **kw):
    return SpMM.from_coo(*_coo(m, vals), lane_width=LANE, backend=backend,
                         reduce=reduce, device="cpu", **kw)


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("reduce,dtype", SEMIRINGS)
@pytest.mark.parametrize("gen", ["banded", "powerlaw"])
def test_spmm_vs_reference_jax(gen, reduce, dtype, d):
    m = _matrix(gen)
    vals, bmat = _problem(m, dtype, d)
    ref = np.asarray(rspmm.SpMM.from_coo(
        *_coo(m, vals), lane_width=LANE, backend="jax",
        reduce=reduce).matmat(jnp.asarray(bmat)))
    for backend in ("torch", "cuda"):
        y = _port(m, vals, reduce, backend).matmat(bmat)
        assert tuple(y.shape) == (m.shape[0], d)
        assert y.dtype == torch.as_tensor(bmat).dtype
        _assert_rule(y.numpy(), ref, reduce, dtype)


@pytest.mark.parametrize("reduce,dtype", [("add", np.float32),
                                          ("min", np.int32)])
def test_spmm_vs_reference_pallas(reduce, dtype):
    """The reference's Pallas backend (interpret) on the small random
    matrix of ``tests/test_pallas.py``, fused and per-class."""
    rng = np.random.default_rng(1)
    nnz, out_len, data_len, d = 300, 24, 60, 5
    rows = rng.integers(0, out_len, nnz)
    cols = rng.integers(0, data_len, nnz)
    if np.issubdtype(np.dtype(dtype), np.integer):
        vals = rng.integers(-4, 5, nnz).astype(dtype)
        bmat = rng.integers(-4, 5, (data_len, d)).astype(dtype)
    else:
        vals = rng.standard_normal(nnz).astype(dtype)
        bmat = rng.standard_normal((data_len, d)).astype(dtype)
    args = (rows, cols, vals, (out_len, data_len))
    for fused in (False, True):
        ref = np.asarray(rspmm.SpMM.from_coo(
            *args, lane_width=8, backend="pallas", fused=fused,
            reduce=reduce).matmat(jnp.asarray(bmat)))
        for backend in ("torch", "cuda"):
            y = SpMM.from_coo(*args, lane_width=8, backend=backend,
                              fused=fused, reduce=reduce,
                              device="cpu").matmat(bmat)
            _assert_rule(y.numpy(), ref, reduce, dtype)


@pytest.mark.parametrize("reduce,dtype", SEMIRINGS)
@pytest.mark.parametrize("gen", ["banded", "powerlaw"])
def test_spmm_bitwise_across_modes_and_backends(gen, reduce, dtype):
    """fused == per-class, coalesced == uncoalesced and cuda == torch, bit
    for bit, at d = 5."""
    m = _matrix(gen)
    vals, bmat = _problem(m, dtype, 5, seed=2)
    base = _port(m, vals, reduce).matmat(bmat)
    for backend in ("torch", "cuda"):
        for fused in (False, True):
            for coalesce in (False, True):
                y = _port(m, vals, reduce, backend, fused=fused,
                          coalesce=coalesce).matmat(bmat)
                assert torch.equal(_bits(y), _bits(base)), \
                    (backend, fused, coalesce)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("reduce,dtype", SEMIRINGS)
@pytest.mark.parametrize("gen", ["banded", "powerlaw"])
def test_spmm_column_equals_its_own_product(gen, reduce, dtype, backend):
    """Column ``d`` of ``matmat`` is bitwise the product of column ``d``
    alone, and for add bitwise ``SpMV.matvec`` of that column."""
    m = _matrix(gen)
    vals, bmat = _problem(m, dtype, 4, seed=3)
    sp = _port(m, vals, reduce, backend, coalesce=True)
    y = sp.matmat(bmat)
    spmv = SpMV.from_coo(*_coo(m, vals), lane_width=LANE, backend=backend,
                         coalesce=True, device="cpu") \
        if reduce == "add" else None
    for c in range(bmat.shape[1]):
        col = np.ascontiguousarray(bmat[:, c:c + 1])
        assert torch.equal(_bits(y[:, c:c + 1]), _bits(sp.matmat(col)))
        if spmv is not None:
            assert torch.equal(_bits(y[:, c]),
                               _bits(spmv.matvec(bmat[:, c].copy())))


@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("gen", ["banded", "powerlaw"])
def test_matvec_many_rows_equal_matvec(gen, backend, bucket):
    """Row ``i`` of ``matvec_many`` is bitwise ``matvec(xs[i])``; the
    result has the caller's row count whatever the bucket padding."""
    m = _matrix(gen)
    sp = SpMV.from_coo(*_coo(m, np.asarray(m.vals, np.float32)),
                       lane_width=LANE, backend=backend, device="cpu")
    xs = np.random.default_rng(4).standard_normal(
        (3, m.shape[1])).astype(np.float32)
    ys = sp.matvec_many(xs, bucket=bucket)
    assert tuple(ys.shape) == (3, m.shape[0]) and ys.is_contiguous()
    for i in range(3):
        assert torch.equal(_bits(ys[i]), _bits(sp.matvec(xs[i])))


def test_matvec_many_vs_reference_and_bucket_counter():
    m = _matrix("powerlaw")
    args = _coo(m, np.asarray(m.vals, np.float32))
    xs = np.random.default_rng(5).standard_normal(
        (5, m.shape[1])).astype(np.float32)
    ref = np.asarray(rapps.SpMV.from_coo(*args, lane_width=LANE)
                     .matvec_many(xs))
    sp = SpMV.from_coo(*args, lane_width=LANE, backend="cuda", device="cpu")
    before = metrics.value("spmv.batched_shapes")
    _assert_rule(sp.matvec_many(xs).numpy(), ref, "add", np.float32)
    sp.matvec_many(xs[:3] * 2)                    # 3 -> bucket 4: new shape
    sp.matvec_many(torch.as_tensor(xs[:4]))       # bucket 4 again
    sp.matvec_many(xs[:5])                        # bucket 8 again
    assert metrics.value("spmv.batched_shapes") - before == 2
    assert [bucket_size(s) for s in (1, 3, 5, 128, 129)] == \
        [1, 4, 8, 128, 256]
    with pytest.raises(ValueError, match="matvec_many expects"):
        sp.matvec_many(xs[:, :-1])


def test_spmm_not_yet_ported_options_raise():
    """Sharding is ported; the single-device ``cuda`` backend with
    ``shards=`` and an explicit ``mesh`` with the tuner still raise."""
    from repro_torch.launch.mesh import make_shard_mesh
    m = _matrix("banded")
    vals, bmat = _problem(m, np.float32, 2)
    mesh = make_shard_mesh(2, device="cpu", simulate=True)
    for kw, match in (({"shards": 2, "simulate_mesh": True,
                        "backend": "cuda"}, "single-device"),
                      ({"mesh": mesh, "backend": "auto"}, "mesh")):
        with pytest.raises(ValueError, match=match):
            SpMM.from_coo(*_coo(m, vals), device="cpu", **kw)
    sp = _port(m, vals, "add")
    assert sp.report().app == "SpMM"
    y = sp.matmat(torch.as_tensor(bmat))
    assert y.device.type == "cpu" and tuple(y.shape) == (m.shape[0], 2)
    with pytest.raises(ValueError, match="is on meta"):
        sp.matmat(torch.empty(bmat.shape, device="meta"))


@pytest.mark.parametrize("coalesce", [False, True])
def test_spmm_cuda_backend_takes_a_float64_b(coalesce):
    """ROADMAP queue 3, fault 3: float32 values with a float64 ``(256, 4)``
    ``B`` run on the kernel backend in float64, bitwise equal to the torch
    backend and close to the reference (which computes in float32)."""
    m = G.banded(256, 5)
    vals = np.asarray(m.vals, np.float32)
    bmat = np.random.default_rng(12).standard_normal((256, 4))
    ys = [SpMM.from_coo(*_coo(m, vals), lane_width=8, backend=backend,
                        coalesce=coalesce, device="cpu").matmat(bmat)
          for backend in ("torch", "cuda")]
    assert ys[1].dtype == torch.float64
    assert torch.equal(ys[0].view(torch.int64), ys[1].view(torch.int64))
    ref = rspmm.SpMM.from_coo(*_coo(m, vals), lane_width=8,
                              coalesce=coalesce).matmat(jnp.asarray(bmat))
    np.testing.assert_allclose(ys[1].numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)

