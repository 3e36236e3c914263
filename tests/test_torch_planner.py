"""The port's planner, lowering and validation equal the reference's.

Every ``BlockPlan`` array and scalar, and every ``Launch`` field after
``lower()``, is ``np.array_equal`` to the JAX package's on the same input,
over the generator families, lane widths {8, 16, 128}, the backend pairs
(port ``cuda`` / reference ``pallas``, port ``torch`` / reference ``jax``,
``segsum`` / ``segsum``),
``fused`` and ``coalesce``.  ``validate_coo`` / ``validate_csr`` outputs and
``InputError`` fields are equal too.
"""
import dataclasses
import functools

import numpy as np
import pytest

from repro.core import ir as rir
from repro.core import validate as rvalidate
from repro.core.plan import CostModel as RCostModel
from repro.core.plan import build_plan as rbuild_plan
from repro.core.seed import spmv_seed as rspmv_seed
from repro.sparse import generators as RG

from repro_torch.core import ir
from repro_torch.core import validate
from repro_torch.core.plan import CostModel, build_plan
from repro_torch.core.seed import spmv_seed
from repro_torch.sparse import generators as G

FAMILIES = {
    "dense": lambda g: g.dense(40),
    "banded": lambda g: g.banded(300, band=5),
    "random_uniform": lambda g: g.random_uniform(300, 5),
    "power_law": lambda g: g.power_law(400, 6),
    "block_diag": lambda g: g.block_diag(256, 16),
    "stencil_qcd": lambda g: g.stencil_qcd(12),
}
LANES = (8, 16, 128)
BACKENDS = [("cuda", "pallas"), ("torch", "jax"), ("segsum", "segsum")]
_PLAN_FIELDS = ("lane_width", "nnz", "out_len", "data_len", "num_blocks",
                "window_ids", "lane_slot", "lane_offset", "seg_ids",
                "gather_idx", "valid", "flat_perm", "head_pos", "head_rows")


@functools.lru_cache(maxsize=None)
def _plans(family, lane):
    m = FAMILIES[family](RG)
    access = {"row": np.asarray(m.rows), "col": np.asarray(m.cols)}
    return (rbuild_plan(rspmv_seed(), access, m.shape[0], m.shape[1],
                        RCostModel(lane_width=lane)),
            build_plan(spmv_seed(), access, m.shape[0], m.shape[1],
                       CostModel(lane_width=lane)))


def _equal(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert (a is None) == (b is None), what
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, what
            assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), \
                what
    else:
        assert a == b, what


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_generators_equal(family):
    ref, got = FAMILIES[family](RG), FAMILIES[family](G)
    for f in ("rows", "cols", "vals"):
        _equal(getattr(ref, f), getattr(got, f), f)
    assert ref.shape == got.shape and ref.name == got.name


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plan_arrays_equal(family, lane):
    ref, got = _plans(family, lane)
    for f in _PLAN_FIELDS:
        _equal(getattr(ref, f), getattr(got, f), f)
    assert [dataclasses.astuple(c) for c in ref.classes] == \
        [dataclasses.astuple(c) for c in got.classes]
    assert dataclasses.asdict(ref.stats) == dataclasses.asdict(got.stats)


@pytest.mark.parametrize("coalesce", [False, True])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("backend,ref_backend", BACKENDS)
@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_lowering_equal(family, lane, backend, ref_backend, fused,
                        coalesce):
    rplan, plan = _plans(family, lane)
    ref = rir.lower(rplan, backend=ref_backend, fused=fused,
                    coalesce=coalesce)
    got = ir.lower(plan, backend=backend, fused=fused, coalesce=coalesce)
    assert len(ref.launches) == len(got.launches)
    for rl, gl in zip(ref.launches, got.launches):
        for f in dataclasses.fields(rl):
            _equal(getattr(rl, f.name), getattr(gl, f.name), f.name)
    assert ref.stage_b == got.stage_b
    assert ref.passes == got.passes and ref.pass_deltas == got.pass_deltas
    assert rir.coalesced_fraction(ref) == ir.coalesced_fraction(got)


@pytest.mark.parametrize("stage_b", ["auto", "gather", "dense"])
def test_stage_b_choice_equal(stage_b):
    rplan, plan = _plans("power_law", 16)
    for backend, ref_backend in BACKENDS:
        assert ir.lower(plan, backend=backend, stage_b=stage_b).stage_b == \
            rir.lower(rplan, backend=ref_backend, stage_b=stage_b).stage_b


def test_coalesce_stats_equal():
    for family in FAMILIES:
        rplan, plan = _plans(family, 16)
        assert rir.coalesce_stats(rplan) == ir.coalesce_stats(plan)


def test_unknown_backend_raises():
    _, plan = _plans("banded", 8)
    for bad in ("jax", "pallas", "triton"):
        with pytest.raises(ValueError, match="unknown backend"):
            ir.lower(plan, backend=bad)


def _coo_cases():
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 20, 60)
    cols = rng.integers(0, 30, 60)
    vals = rng.standard_normal(60).astype(np.float32)
    bad_rows = rows.copy()
    bad_rows[[3, 9]] = [25, -1]
    nan_vals = vals.copy()
    nan_vals[[4, 11, 12]] = [np.nan, np.inf, -np.inf]
    return {
        "clean": (rows, cols, vals),
        "duplicates": (np.r_[rows, rows[:10]], np.r_[cols, cols[:10]],
                       np.r_[vals, vals[:10]]),
        "out_of_range": (bad_rows, cols, vals),
        "nonfinite": (rows, cols, nan_vals),
        "float_index": (rows.astype(np.float64), cols, vals),
        "length_mismatch": (rows, cols[:-1], vals),
        "empty": (np.zeros(0, np.int64), np.zeros(0, np.int64),
                  np.zeros(0, np.float32)),
    }


def _run_both(ref_fn, port_fn, *args, **kw):
    """Call both validators; equal outputs, or equal InputError fields."""
    try:
        ref = ref_fn(*args, **kw)
    except rvalidate.InputError as e:
        with pytest.raises(validate.InputError) as got:
            port_fn(*args, **kw)
        assert str(got.value) == str(e)
        assert got.value.field == e.field and got.value.count == e.count
        _equal(e.indices, got.value.indices, "indices")
        return
    got = port_fn(*args, **kw)
    for a, b in zip(ref[:-1], got[:-1]):
        _equal(np.asarray(a), np.asarray(b), "array")
    assert dataclasses.asdict(ref[-1]) == dataclasses.asdict(got[-1])


@pytest.mark.parametrize("policy", ["strict", "repair", "off"])
@pytest.mark.parametrize("case", sorted(_coo_cases()))
def test_validate_coo_equal(case, policy):
    rows, cols, vals = _coo_cases()[case]
    _run_both(rvalidate.validate_coo, validate.validate_coo, rows, cols,
              vals, (20, 30), policy=policy)


def _csr_cases():
    rng = np.random.default_rng(8)
    counts = rng.integers(0, 5, 12)
    indptr = np.r_[0, np.cumsum(counts)]
    nnz = int(indptr[-1])
    indices = rng.integers(0, 15, nnz)
    vals = rng.standard_normal(nnz).astype(np.float32)
    bad_cols = indices.copy()
    bad_cols[2] = 99
    desc = indptr.copy()
    desc[5] = desc[6] + 1
    return {
        "clean": (indptr, indices, vals),
        "bad_col": (indptr, bad_cols, vals),
        "non_monotone": (desc, indices, vals),
        "short_indptr": (indptr[:-1], indices, vals),
        "nonzero_start": (indptr + 1, indices, vals),
    }


@pytest.mark.parametrize("policy", ["strict", "repair"])
@pytest.mark.parametrize("case", sorted(_csr_cases()))
def test_validate_csr_equal(case, policy):
    indptr, indices, vals = _csr_cases()[case]
    _run_both(rvalidate.validate_csr, validate.validate_csr, indptr, indices,
              vals, (12, 15), policy=policy)


@pytest.mark.parametrize("reduce", ["add", "mul", "min", "max"])
def test_repair_combines_duplicates_with_the_reduce(reduce):
    rows, cols, vals = _coo_cases()["duplicates"]
    _run_both(rvalidate.validate_coo, validate.validate_coo, rows, cols,
              vals, (20, 30), policy="repair", reduce=reduce)
