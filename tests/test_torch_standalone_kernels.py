"""The port's standalone kernels against the reference's Pallas kernels.

``segment_reduce``, ``gather_vload`` and ``row_gather`` of
``repro_torch.kernels`` run their plain torch versions on the CPU; these
are held to the JAX package's kernels under ``interpret=True`` on the same
numpy inputs, over the sweeps of ``tests/test_kernels.py`` plus trailing
lane axes (``D = 4``).  Tolerances:

* data movement (``gather_vload``, ``row_gather``) and the int32 and
  min/max ladders: exact;
* float add/mul ladders: ``rtol=2e-5, atol=2e-5``, as ``tests/test_kernels.py``
  uses (the reference's ``FULL_REDUCE`` is a native reduce of unspecified
  order, the port's the pairwise halving tree);
* float64: JAX runs here without x64, so its "float64" result is float32.
  The port's float64 ladder is held to the float64 numpy oracle
  ``segment_reduce_reference`` at ``rtol=1e-12`` and to JAX at the float32
  tolerance.

The CUDA kernels themselves are held to these plain versions on the card
by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gather_vload.kernel import gather_vload as rgather_vload
from repro.kernels.gather_vload.ref import gather_reference
from repro.kernels.moe_dispatch.kernel import row_gather as rrow_gather
from repro.kernels.segment_reduce.kernel import \
    segment_reduce as rsegment_reduce
from repro.kernels.segment_reduce.ref import segment_reduce_reference

from repro_torch.kernels import common
from repro_torch.kernels.gather_vload.ops import gather_vload_op
from repro_torch.kernels.moe_dispatch.ops import row_gather_op
from repro_torch.kernels.segment_reduce.ops import segment_reduce_op

FLOAT_TOL = dict(rtol=2e-5, atol=2e-5)


def _random_segments(rng, b, n):
    """Consecutive-run segment ids and the op_flag covering the longest run,
    as the plan builder emits them."""
    seg = np.zeros((b, n), dtype=np.int32)
    max_run = 1
    for bi in range(b):
        j, s = 0, 0
        while j < n:
            run = int(rng.integers(1, n - j + 1))
            seg[bi, j:j + run] = s
            max_run = max(max_run, run)
            s += 1
            j += run
    return seg, int(np.ceil(np.log2(max_run))) if max_run > 1 else 0


def _values(rng, shape, dtype):
    if np.issubdtype(np.dtype(dtype), np.integer):
        return rng.integers(-5, 6, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _columns(a):
    """(B, N, ...) -> the (B, N) columns of its trailing lane axes."""
    flat = a.reshape(a.shape[:2] + (-1,))
    return [flat[..., c] for c in range(flat.shape[-1])]


# ------------------------------------------------------------ segment_reduce
@pytest.mark.parametrize("trailing", [(), (4,)])
@pytest.mark.parametrize("n", [8, 32, 128, 256])
@pytest.mark.parametrize("reduce,dtype", [("add", np.float32),
                                          ("max", np.float32),
                                          ("mul", np.float32),
                                          ("min", np.int32),
                                          ("max", np.int32),
                                          ("add", np.int32)])
def test_segment_reduce_vs_reference(n, reduce, dtype, trailing):
    """The ladder against ``segment_reduce`` (interpret) and the numpy
    oracle, per trailing column."""
    rng = np.random.default_rng(n + len(trailing))
    b = 16
    x = _values(rng, (b, n) + trailing, dtype)
    if reduce == "mul":          # keep products of long runs finite
        x = (1.0 + 0.01 * x).astype(dtype)
    seg, op_flag = _random_segments(rng, b, n)
    got = segment_reduce_op(torch.as_tensor(x), torch.as_tensor(seg),
                            op_flag, reduce=reduce).numpy()
    ref = np.asarray(rsegment_reduce(jnp.asarray(x), jnp.asarray(seg),
                                     op_flag, reduce=reduce, interpret=True))
    oracle = np.stack([segment_reduce_reference(c, seg, reduce=reduce)
                       for c in _columns(x)], axis=-1).reshape(x.shape)
    assert got.shape == x.shape and got.dtype == x.dtype
    exact = np.issubdtype(np.dtype(dtype), np.integer) \
        or reduce in ("max", "min")
    for want in (ref, oracle):
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **FLOAT_TOL)


@pytest.mark.parametrize("trailing", [(), (4,)])
@pytest.mark.parametrize("n", [8, 32, 128])
@pytest.mark.parametrize("reduce", ["add", "max"])
def test_segment_reduce_float64(n, reduce, trailing):
    """float64 keeps its precision: tight against the float64 oracle, and
    within the float32 tolerance of the reference's (float32) result."""
    rng = np.random.default_rng(7 * n)
    x = rng.standard_normal((16, n) + trailing)
    seg, op_flag = _random_segments(rng, 16, n)
    got = segment_reduce_op(torch.as_tensor(x), torch.as_tensor(seg),
                            op_flag, reduce=reduce)
    assert got.dtype == torch.float64
    oracle = np.stack([segment_reduce_reference(c, seg, reduce=reduce)
                       for c in _columns(x)], axis=-1).reshape(x.shape)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-12, atol=1e-12)
    ref = np.asarray(rsegment_reduce(jnp.asarray(x), jnp.asarray(seg),
                                     op_flag, reduce=reduce, interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, **FLOAT_TOL)


@pytest.mark.parametrize("trailing", [(), (4,)])
@pytest.mark.parametrize("n", [8, 100, 128])
@pytest.mark.parametrize("reduce,dtype", [("add", np.float32),
                                          ("min", np.int32)])
def test_segment_reduce_full(n, reduce, dtype, trailing):
    """``FULL_REDUCE``: lane 0 holds the block's total, every other lane
    keeps its value."""
    rng = np.random.default_rng(n)
    x = _values(rng, (8, n) + trailing, dtype)
    seg = np.zeros((8, n), dtype=np.int32)
    got = segment_reduce_op(torch.as_tensor(x), torch.as_tensor(seg),
                            common.FULL_REDUCE, reduce=reduce).numpy()
    ref = np.asarray(rsegment_reduce(jnp.asarray(x), jnp.asarray(seg),
                                     common.FULL_REDUCE, reduce=reduce,
                                     interpret=True))
    np.testing.assert_array_equal(got[:, 1:], x[:, 1:])
    if reduce == "add":
        np.testing.assert_allclose(got, ref, **FLOAT_TOL)
        np.testing.assert_allclose(got[:, 0], x.sum(axis=1), rtol=1e-4,
                                   atol=1e-5)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("rows", [1, 3, 8, 64])
def test_segment_reduce_rows_per_step_is_neutral(rows):
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((12, 32, 2)).astype(np.float32))
    seg, op_flag = _random_segments(rng, 12, 32)
    seg = torch.as_tensor(seg)
    assert torch.equal(segment_reduce_op(x, seg, op_flag, rows_per_step=rows),
                       segment_reduce_op(x, seg, op_flag))


# -------------------------------------------------------------- gather_vload
@pytest.mark.parametrize("trailing", [(), (4,)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("ls", [1, 2, 4])
@pytest.mark.parametrize("n", [8, 32, 128])
def test_gather_vload_vs_reference(n, ls, dtype, trailing):
    rng = np.random.default_rng(n * ls)
    b, nwin = 12, 16
    x_view = _values(rng, (nwin, n) + trailing, dtype)
    win_ids = rng.integers(0, nwin, size=(b, ls)).astype(np.int32)
    slot = rng.integers(0, ls, size=(b, n)).astype(np.int32)
    off = rng.integers(0, n, size=(b, n)).astype(np.int32)
    got = gather_vload_op(torch.as_tensor(x_view), torch.as_tensor(win_ids),
                          torch.as_tensor(slot), torch.as_tensor(off),
                          ls=ls).numpy()
    ref = np.asarray(rgather_vload(jnp.asarray(x_view), jnp.asarray(win_ids),
                                   jnp.asarray(slot), jnp.asarray(off),
                                   ls=ls, interpret=True))
    np.testing.assert_array_equal(got, ref)
    idx = win_ids[np.arange(b)[:, None], slot] * n + off
    flat = x_view.reshape((nwin * n,) + trailing)
    np.testing.assert_array_equal(got, flat[idx])
    if not trailing:
        np.testing.assert_array_equal(got, gather_reference(flat, idx))


@pytest.mark.parametrize("trailing", [(), (4,)])
def test_gather_vload_stream(trailing):
    n, b = 32, 6
    x_view = np.arange(20 * n * int(np.prod(trailing)),
                       dtype=np.float32).reshape((20, n) + trailing)
    win_ids = np.arange(b, dtype=np.int32)[:, None]
    iota = np.tile(np.arange(n, dtype=np.int32), (b, 1))
    got = gather_vload_op(torch.as_tensor(x_view), torch.as_tensor(win_ids),
                          torch.as_tensor(iota * 0), torch.as_tensor(iota),
                          ls=1, stream=True).numpy()
    ref = np.asarray(rgather_vload(jnp.asarray(x_view), jnp.asarray(win_ids),
                                   jnp.asarray(iota * 0), jnp.asarray(iota),
                                   ls=1, stream=True, interpret=True))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, x_view[:b])


def test_gather_vload_reads_only_the_first_ls_window_ids():
    """``win_ids`` may carry more columns than ``ls`` (a plan's window ids
    are as wide as its widest class); only the first ``ls`` are read."""
    rng = np.random.default_rng(5)
    x_view = torch.as_tensor(rng.standard_normal((10, 8)).astype(np.float32))
    win = torch.as_tensor(rng.integers(0, 10, (4, 6)).astype(np.int32))
    slot = torch.as_tensor(rng.integers(0, 2, (4, 8)).astype(np.int32))
    off = torch.as_tensor(rng.integers(0, 8, (4, 8)).astype(np.int32))
    wide = gather_vload_op(x_view, win, slot, off, ls=2)
    narrow = gather_vload_op(x_view, win[:, :2].contiguous(), slot, off, ls=2)
    assert torch.equal(wide, narrow)
    with pytest.raises(ValueError, match="ls"):
        gather_vload_op(x_view, win, slot, off, ls=7)


# ---------------------------------------------------------------- row_gather
@pytest.mark.parametrize("d", [128, 512, 768])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_gather_vs_reference(d, dtype):
    rng = np.random.default_rng(d)
    t, r = 64, 96
    src = rng.standard_normal((t, d)).astype(np.float32)
    rows = rng.integers(0, t, size=r).astype(np.int32)
    src_t = torch.as_tensor(src).to(getattr(torch, dtype))
    got = row_gather_op(src_t, torch.as_tensor(rows))
    assert got.dtype == src_t.dtype and got.shape == (r, d)
    ref = np.asarray(rrow_gather(jnp.asarray(src, getattr(jnp, dtype)),
                                 jnp.asarray(rows), interpret=True))
    np.testing.assert_array_equal(got.float().numpy(),
                                  ref.astype(np.float32))
    np.testing.assert_array_equal(got.float().numpy(),
                                  src_t.float().numpy()[rows])


@pytest.mark.parametrize("d_tile", [1, 100, 512, 4096])
def test_row_gather_d_tile_is_neutral(d_tile):
    rng = np.random.default_rng(1)
    src = torch.as_tensor(rng.standard_normal((9, 384)).astype(np.float32))
    rows = torch.as_tensor(rng.integers(0, 9, 20).astype(np.int32))
    assert torch.equal(row_gather_op(src, rows, d_tile=d_tile),
                       row_gather_op(src, rows))
