"""The port's stage-A kernels against the reference's Pallas kernels.

On a machine without a card the wrappers run their plain torch versions;
these are held to the reference's ``class_stage_a``, ``gpu_stage_a`` and
``coalesced_stage_a`` under ``interpret=True`` on identical inputs, with
the reference's own rule (``tests/test_pallas.py``): exact for int32 and
for min/max, ``allclose(rtol=1e-5, atol=1e-6)`` for float add/mul.  The
float tolerance is there because the reference's Pallas ``FULL_REDUCE`` is
a native reduce of unspecified order, while the port's is the pairwise
halving tree.

The CUDA kernels themselves are held to these plain versions on the card
by ``tests/test_torch_cuda.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as reng
from repro.core import feature_table as rft
from repro.core import ir as rir
from repro.core.plan import CostModel as RCostModel
from repro.core.plan import build_plan as rbuild_plan
from repro.core.seed import spmv_seed as rspmv_seed
from repro.kernels.unroll_spmv.kernel import (class_stage_a,
                                              coalesced_stage_a, gpu_stage_a)
from repro.sparse import generators as G

from repro_torch.core import engine as eng
from repro_torch.core import ir
from repro_torch.core.plan import CostModel, build_plan
from repro_torch.core.seed import CodeSeed, spmv_seed
from repro_torch.kernels import common
from repro_torch.kernels.unroll_spmv import kernel as K
from repro_torch.kernels.unroll_spmv import ops

SEMIRINGS = [("add", np.float32), ("mul", np.float32), ("min", np.int32),
             ("max", np.int32)]
LANE = 16


@functools.lru_cache(maxsize=None)
def _matrix(gen):
    return {"banded": G.banded(256, 5), "powerlaw": G.power_law(512, 6)}[gen]


@functools.lru_cache(maxsize=None)
def _plans(gen, reduce, lane=LANE):
    m = _matrix(gen)
    access = {"row": np.asarray(m.rows), "col": np.asarray(m.cols)}
    return (rbuild_plan(rspmv_seed(reduce), access, m.shape[0], m.shape[1],
                        RCostModel(lane_width=lane)),
            build_plan(spmv_seed(reduce), access, m.shape[0], m.shape[1],
                       CostModel(lane_width=lane)))


def _data(m, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(np.dtype(dtype), np.integer):
        return (rng.integers(-5, 6, m.nnz).astype(dtype),
                rng.integers(-5, 6, m.shape[1]).astype(dtype))
    return (rng.standard_normal(m.nnz).astype(dtype),
            rng.standard_normal(m.shape[1]).astype(dtype))


def _assert_rule(got, want, reduce, dtype):
    if np.issubdtype(np.dtype(dtype), np.integer) or reduce in ("min", "max"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _launch_inputs(gen, reduce, dtype, fused, coalesce):
    """Per kernel launch of the reference's pallas lowering: the reference
    operands (jnp) and the port's (torch, CPU) on the same numpy data."""
    rplan, plan = _plans(gen, reduce)
    m = _matrix(gen)
    vals, x = _data(m, dtype)
    relem = reng.reorder_elementwise(rplan, vals, reduce=reduce)
    pelem = eng.reorder_elementwise(plan, vals, reduce=reduce)
    rtree = rir.lower(rplan, backend="pallas", fused=fused, coalesce=coalesce)
    ptree = ir.lower(plan, backend="cuda", fused=fused, coalesce=coalesce)
    metas = ops.stage_launch_meta(plan, ptree.launches, torch.device("cpu"))
    out = []
    for rl, cm in zip(rtree.launches, metas):
        if rl.gather == rir.FALLBACK:
            continue
        s = slice(rl.start, rl.stop)
        out.append((rl, cm, rplan, s, relem[s], pelem[s], x))
    assert out, "the lowering must reach a kernel"
    return out


def _ref_kwargs(rplan, rl, dtype):
    seed = rplan.seed
    full = None if rl.full_mask is None else jnp.asarray(rl.full_mask,
                                                         jnp.int32)
    return dict(combine=seed.combine, gathered=seed.gathered,
                elementwise=seed.elementwise, op=rl.op_flag,
                reduce=seed.reduce, full_flags=full,
                out_dtype=jnp.dtype(dtype), out_trailing=(), interpret=True)


@pytest.mark.parametrize("reduce,dtype", SEMIRINGS)
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("gen", ["banded", "powerlaw"])
def test_window_plain_vs_reference(gen, fused, reduce, dtype):
    """The window kernel's plain version against ``class_stage_a`` and
    ``gpu_stage_a`` (interpret) on every window/stream launch."""
    for rl, cm, rplan, s, relem, pelem, x in _launch_inputs(
            gen, reduce, dtype, fused, coalesce=False):
        ls = max(rl.ls_flag, 1)
        win = jnp.asarray(rplan.window_ids[s][:, :ls], jnp.int32)
        slot = jnp.asarray(rplan.lane_slot[s], jnp.int32)
        off = jnp.asarray(rplan.lane_offset[s], jnp.int32)
        seg = jnp.asarray(rplan.seg_ids[s], jnp.int32)
        views = {"x": reng._pad_gathered(rplan, jnp.asarray(x))}
        kw = dict(_ref_kwargs(rplan, rl, dtype), ls=ls, stream=rl.stream)
        refs = [class_stage_a(win, views, {"value": relem}, slot, off, seg,
                              **kw),
                gpu_stage_a(win, views, {"value": relem}, slot, off, seg,
                            **kw)]
        got = K.window_stage_a(
            cm.win, [torch.as_tensor(x)], [pelem], cm.slot, cm.off, cm.seg,
            op=rl.op_flag, stream=rl.stream, reduce=reduce,
            full_flags=cm.full).numpy()
        for ref in refs:
            _assert_rule(got, np.asarray(ref), reduce, dtype)


@pytest.mark.parametrize("reduce,dtype", SEMIRINGS)
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("gen", ["banded", "powerlaw"])
def test_dense_slice_plain_vs_reference(gen, fused, reduce, dtype):
    """The dense-slice kernel's plain version against
    ``coalesced_stage_a`` (interpret) on every coalesced launch."""
    cases = [c for c in _launch_inputs(gen, reduce, dtype, fused,
                                       coalesce=True)
             if c[0].gather == rir.COALESCED]
    assert cases, f"{gen} must produce coalesced launches"
    for rl, cm, rplan, s, relem, pelem, x in cases:
        flat = {"x": reng._pad_flat(rplan, jnp.asarray(x))}
        seg = jnp.asarray(rplan.seg_ids[s], jnp.int32)
        local = None if rl.local_offset is None else jnp.asarray(
            rl.local_offset, jnp.int32)
        ref = coalesced_stage_a(jnp.asarray(rl.slice_starts, jnp.int32), flat,
                                {"value": relem}, local, seg,
                                **_ref_kwargs(rplan, rl, dtype))
        got = K.dense_slice_stage_a(
            cm.starts, [torch.as_tensor(x)], [pelem], cm.local, cm.seg,
            op=rl.op_flag, reduce=reduce, full_flags=cm.full).numpy()
        _assert_rule(got, np.asarray(ref), reduce, dtype)


# The graph apps' "add_all" combines over the SpMV plans' operands: SSSP's
# gathered + elementwise (dist + weight) and BFS's gathered + 1 (level + 1):
# (reference combine, elementwise names, port addend)
ADD_FORMS = {"sssp": (lambda v: v["x"] + v["value"], ("value",), None),
             "bfs": (lambda v: v["x"] + 1, (), 1)}
ALL_REDUCES = [(r, d) for r in ("add", "mul", "max", "min")
               for d in (np.float32, np.int32)]


@pytest.mark.parametrize("form", sorted(ADD_FORMS))
@pytest.mark.parametrize("reduce,dtype", ALL_REDUCES)
@pytest.mark.parametrize("kernel", ["window", "dense_slice"])
def test_add_all_plain_vs_reference(kernel, reduce, dtype, form):
    """The ``"add_all"`` plain versions against ``gpu_stage_a`` (window
    form, on the power-law plan's window and stream launches) and
    ``coalesced_stage_a`` (on the banded plan's coalesced launches) in
    interpret mode, with the reference evaluating the seed's own lambda."""
    combine, elementwise, addend = ADD_FORMS[form]
    gen = "powerlaw" if kernel == "window" else "banded"
    cases = [c for c in _launch_inputs(gen, reduce, dtype, True,
                                       coalesce=kernel == "dense_slice")
             if (c[0].gather == rir.COALESCED) == (kernel == "dense_slice")]
    assert cases
    for rl, cm, rplan, s, relem, pelem, x in cases:
        full = None if rl.full_mask is None else jnp.asarray(rl.full_mask,
                                                             jnp.int32)
        kw = dict(combine=combine, gathered=("x",), elementwise=elementwise,
                  op=rl.op_flag, reduce=reduce, full_flags=full,
                  out_dtype=jnp.dtype(dtype), out_trailing=(),
                  interpret=True)
        relems = {"value": relem} if elementwise else {}
        pelems = [pelem] if elementwise else []
        seg = jnp.asarray(rplan.seg_ids[s], jnp.int32)
        if kernel == "window":
            ls = max(rl.ls_flag, 1)
            ref = gpu_stage_a(
                jnp.asarray(rplan.window_ids[s][:, :ls], jnp.int32),
                {"x": reng._pad_gathered(rplan, jnp.asarray(x))}, relems,
                jnp.asarray(rplan.lane_slot[s], jnp.int32),
                jnp.asarray(rplan.lane_offset[s], jnp.int32), seg, ls=ls,
                stream=rl.stream, **kw)
            got = K.window_stage_a(
                cm.win, [torch.as_tensor(x)], pelems, cm.slot, cm.off,
                cm.seg, op=rl.op_flag, stream=rl.stream, reduce=reduce,
                full_flags=cm.full, combine="add_all", addend=addend)
        else:
            local = None if rl.local_offset is None else jnp.asarray(
                rl.local_offset, jnp.int32)
            ref = coalesced_stage_a(
                jnp.asarray(rl.slice_starts, jnp.int32),
                {"x": reng._pad_flat(rplan, jnp.asarray(x))}, relems, local,
                seg, **kw)
            got = K.dense_slice_stage_a(
                cm.starts, [torch.as_tensor(x)], pelems, cm.local, cm.seg,
                op=rl.op_flag, reduce=reduce, full_flags=cm.full,
                combine="add_all", addend=addend)
        _assert_rule(got.numpy(), np.asarray(ref), reduce, dtype)


def test_add_all_plain_wraps_and_propagates_like_torch():
    """The plain ``"add_all"`` is torch's ``+`` in operand order: int32
    wraps, NaN and inf propagate, and a float addend is added in the
    operand dtype."""
    seg = torch.zeros((1, 4), dtype=torch.int32)
    win = torch.zeros((1, 1), dtype=torch.int32)
    idx = torch.arange(4, dtype=torch.int32)[None]
    big = torch.tensor([2 ** 31 - 1, 5, -(2 ** 31), 0], dtype=torch.int32)
    got = K.window_stage_a(win, [big], [], idx * 0, idx, seg, op=0,
                           stream=False, reduce="min", combine="add_all",
                           addend=1)
    assert got.tolist() == [[-(2 ** 31), 6, -(2 ** 31) + 1, 1]]
    x = torch.tensor([np.nan, np.inf, -np.inf, 1.0])
    w = torch.tensor([[1.0, -np.inf, 1.0, 2.0]])
    got = K.dense_slice_stage_a(torch.zeros(1, dtype=torch.int32), [x], [w],
                                None, seg, op=0, reduce="min",
                                combine="add_all", addend=0.1)
    want = (x + w[0]) + torch.tensor(0.1, dtype=torch.float32)
    assert torch.equal(got[0].isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got[0]), torch.nan_to_num(want))


@pytest.mark.parametrize("b,r,want", [(12, 1, 1), (12, 5, 4), (12, 64, 12),
                                      (7, 4, 1), (0, 8, 1), (30, 8, 6)])
def test_rows_per_step_realizes_as_largest_divisor(b, r, want):
    assert K._largest_divisor(b, r) == want


@pytest.mark.parametrize("coalesce", [False, True])
def test_rows_per_step_is_bitwise_neutral(coalesce):
    """``rows_per_step`` only schedules: every requested value returns the
    bit-identical output; ``meta_prefetch`` is accepted and ignored."""
    m = _matrix("banded")
    _, plan = _plans("banded", "add")
    vals, x = _data(m, np.float32)

    def go(kp):
        run = eng.make_executor(plan, {"value": vals}, backend="cuda",
                                coalesce=coalesce, kernel_params=kp,
                                device="cpu")
        return run({"x": torch.as_tensor(x)},
                   torch.zeros(m.shape[0])).numpy()

    ref = go(None)
    for rows, prefetch in ((1, 1), (3, 2), (7, 4), (8, 8), (64, 64)):
        np.testing.assert_array_equal(
            go({"rows_per_step": rows, "meta_prefetch": prefetch}), ref)


def test_seed_without_kernel_combine_raises():
    """A seed the kernels cannot evaluate raises on the cuda backend
    instead of staying on the torch emitter."""
    _, plan = _plans("banded", "add")
    bare = CodeSeed(name="spmv", output="y", out_index="row",
                    gather_index="col", gathered=("x",),
                    elementwise=("value",),
                    combine=lambda v: v["value"] * v["x"])
    plan.seed, seed = bare, plan.seed
    try:
        with pytest.raises(ValueError, match="kernel_combine"):
            eng.make_executor(plan, {"value": np.ones(plan.nnz, np.float32)},
                              backend="cuda", device="cpu")
    finally:
        plan.seed = seed


def test_wrappers_reject_what_the_kernel_does_not_take():
    seg = torch.zeros((2, 8), dtype=torch.int32)
    idx = torch.zeros((2, 8), dtype=torch.int32)
    win = torch.zeros((2, 1), dtype=torch.int32)
    x = torch.ones(8)
    with pytest.raises(TypeError, match="one dtype"):
        K.window_stage_a(win, [x], [torch.ones((2, 8), dtype=torch.int32)],
                         idx, idx, seg, op=0, stream=False, reduce="add")
    with pytest.raises(ValueError, match="one trailing lane shape"):
        K.window_stage_a(win, [torch.ones((8, 3)), torch.ones((8, 4))], [],
                         idx, idx, seg, op=0, stream=False, reduce="add")
    with pytest.raises(TypeError, match="float32, float64 or int32"):
        K.dense_slice_stage_a(torch.zeros(2, dtype=torch.int32),
                              [x.half()], [], None, seg, op=0,
                              reduce="add")
    with pytest.raises(ValueError, match="needs combine 'add_all'"):
        K.window_stage_a(win, [x], [], idx, idx, seg, op=0, stream=False,
                         reduce="min", addend=1.0)
    with pytest.raises(ValueError, match="unknown combine"):
        K.window_stage_a(win, [x], [], idx, idx, seg, op=0, stream=False,
                         reduce="min", combine="max_all")


def _random_segments(rng, b, n):
    seg = np.zeros((b, n), dtype=np.int32)
    for bi in range(b):
        cuts = np.sort(rng.choice(np.arange(1, n), size=3, replace=False))
        for c in cuts:
            seg[bi, c:] += 1
    return seg


@pytest.mark.parametrize("reduce,dtype", [("add", np.int32),
                                          ("min", np.int32),
                                          ("add", np.float32)])
@pytest.mark.parametrize("bc,n,d", [(4, 8, 3), (8, 8, 3), (16, 16, 1)])
def test_ladder_tail_full_flags_select_whole_blocks(bc, n, d, reduce, dtype):
    """A fused mixed section's (Bc,) full flags select whole blocks of
    (Bc, N, D) lanes, over every trailing column: the reference's rule
    (``kernels/unroll_spmv/ops.py``, the full mask expanded to the term's
    rank).  Both ``Bc != N`` and ``Bc == N``."""
    rng = np.random.default_rng(bc * n * d)
    shape = (bc, n) + ((d,) if d > 1 else ())
    term = (rng.integers(-5, 6, shape) if dtype == np.int32
            else rng.standard_normal(shape)).astype(dtype)
    seg = _random_segments(rng, bc, n)
    flags = (np.arange(bc) % 3 == 1).astype(np.int32)
    red = reng.segmented_reduce(jnp.asarray(term), jnp.asarray(seg), 2,
                                reduce)
    native = reng.segmented_reduce(jnp.asarray(term), jnp.asarray(seg),
                                   rft.FULL_REDUCE, reduce)
    want = np.asarray(jnp.where(
        reng._expand_trailing(jnp.asarray(flags != 0)[:, None], term.ndim),
        native, red))
    got = common.ladder_tail(torch.as_tensor(term), torch.as_tensor(seg), 2,
                             reduce, torch.as_tensor(flags)).numpy()
    _assert_rule(got, want, reduce, dtype)
