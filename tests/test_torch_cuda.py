"""The CUDA kernels on the card, bitwise against their plain versions.

These tests need a CUDA device: the kernels have no interpret mode.  Each
one decides inside the test whether a card exists and skips, with the
reason, where there is none.  The file imports nothing of JAX or of the
reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import engine as eng
from repro_torch.core import ir
from repro_torch.core.apps import SpMV
from repro_torch.core.plan import CostModel, build_plan
from repro_torch.core.seed import spmv_seed
from repro_torch.core.spmm import SpMM
from repro_torch.kernels import common
from repro_torch.kernels.gather_vload import kernel as GV
from repro_torch.kernels.moe_dispatch import kernel as RG
from repro_torch.kernels.segment_reduce import kernel as SR
from repro_torch.kernels.unroll_spmv import kernel as K
from repro_torch.kernels.unroll_spmv import ops
from repro_torch.sparse import generators as G

pytestmark = pytest.mark.cuda

SEMIRINGS = [("add", np.float32), ("mul", np.float32), ("min", np.int32),
             ("max", np.int32)]


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no "
                    "interpret mode, so they run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _matrix(gen):
    return {"banded": G.banded(2000, 13), "powerlaw": G.power_law(4000, 6),
            "dense": G.dense(96)}[gen]


def _plan(gen, lane):
    m = _matrix(gen)
    return build_plan(spmv_seed(), {"row": m.rows, "col": m.cols},
                      m.shape[0], m.shape[1], CostModel(lane_width=lane))


def _data(m, dtype):
    rng = np.random.default_rng(0)
    if np.issubdtype(np.dtype(dtype), np.integer):
        return (rng.integers(-5, 6, m.nnz).astype(dtype),
                rng.integers(-5, 6, m.shape[1]).astype(dtype))
    return (rng.standard_normal(m.nnz).astype(dtype),
            rng.standard_normal(m.shape[1]).astype(dtype))


def _bits(t):
    return t.view(torch.int32) if t.element_size() == 4 else \
        t.view(torch.int16 if t.element_size() == 2 else torch.int64)


@pytest.mark.parametrize("reduce,dtype", SEMIRINGS)
@pytest.mark.parametrize("lane", [16, 24, 128])
@pytest.mark.parametrize("gen", ["banded", "powerlaw", "dense"])
def test_kernels_bitwise_vs_plain(gen, lane, reduce, dtype):
    """Every kernel launch of the fused and per-class lowerings, coalesced
    and not, against the plain version on the card, for several
    ``rows_per_step`` values."""
    dev = _cuda()
    plan = _plan(gen, lane)
    vals, x = _data(_matrix(gen), dtype)
    xd = torch.as_tensor(x, device=dev)
    elem = eng.reorder_elementwise(plan, vals, reduce=reduce, device=dev)
    seen = set()
    for fused in (False, True):
        for coalesce in (False, True):
            tree = ir.lower(plan, backend="cuda", fused=fused,
                            coalesce=coalesce)
            for cm in ops.stage_launch_meta(plan, tree.launches, dev):
                la = cm.launch
                if la.gather == ir.FALLBACK:
                    continue
                s = slice(la.start, la.stop)
                kw = dict(op=la.op_flag, reduce=reduce, full_flags=cm.full)
                if la.gather == ir.COALESCED:
                    args = (cm.starts, [xd], [elem[s]], cm.local, cm.seg)
                    kernel, plain = K.dense_slice_stage_a, \
                        K.dense_slice_stage_a_plain
                else:
                    args = (cm.win, [xd], [elem[s]], cm.slot, cm.off, cm.seg)
                    kw["stream"] = la.stream
                    kernel, plain = K.window_stage_a, K.window_stage_a_plain
                want = plain(*args, **kw)
                for rows in (1, 3, 8):
                    got = kernel(*args, rows_per_step=rows, **kw)
                    torch.cuda.synchronize()
                    assert torch.equal(_bits(got), _bits(want)), \
                        (la.gather, la.start, la.op_flag, rows)
                seen.add(kernel)
    assert seen, "no kernel launch in the lowering"


@pytest.mark.parametrize("d", [3, 16])
@pytest.mark.parametrize("reduce,dtype", SEMIRINGS)
@pytest.mark.parametrize("lane", [16, 24, 128])
@pytest.mark.parametrize("gen", ["banded", "powerlaw"])
def test_kernels_bitwise_vs_plain_trailing(gen, lane, reduce, dtype, d):
    """Trailing lane axes: every kernel launch of both lowerings on an
    (n, d) operand against the plain version, and column ``c`` of the
    launch bitwise equal to the launch on column ``c`` alone."""
    dev = _cuda()
    plan = _plan(gen, lane)
    m = _matrix(gen)
    vals, _ = _data(m, dtype)
    rng = np.random.default_rng(d)
    bmat = (rng.integers(-5, 6, (m.shape[1], d)) if dtype == np.int32
            else rng.standard_normal((m.shape[1], d))).astype(dtype)
    xd = torch.as_tensor(bmat, device=dev)
    elem = eng.reorder_elementwise(plan, vals, reduce=reduce, device=dev)
    for fused in (False, True):
        for coalesce in (False, True):
            tree = ir.lower(plan, backend="cuda", fused=fused,
                            coalesce=coalesce)
            for cm in ops.stage_launch_meta(plan, tree.launches, dev):
                la = cm.launch
                if la.gather == ir.FALLBACK:
                    continue
                s = slice(la.start, la.stop)
                kw = dict(op=la.op_flag, reduce=reduce, full_flags=cm.full)
                if la.gather == ir.COALESCED:
                    def args(x, cm=cm, s=s):
                        return (cm.starts, [x], [elem[s]], cm.local, cm.seg)
                    kernel, plain = K.dense_slice_stage_a, \
                        K.dense_slice_stage_a_plain
                else:
                    def args(x, cm=cm, s=s):
                        return (cm.win, [x], [elem[s]], cm.slot, cm.off,
                                cm.seg)
                    kw["stream"] = la.stream
                    kernel, plain = K.window_stage_a, K.window_stage_a_plain
                got = kernel(*args(xd), rows_per_step=3, **kw)
                want = plain(*args(xd), **kw)
                torch.cuda.synchronize()
                assert torch.equal(_bits(got), _bits(want)), \
                    (la.gather, la.start, la.op_flag)
                assert got.shape == (la.stop - la.start, lane, d)
                for c in (0, d - 1):
                    one = kernel(*args(xd[:, c].contiguous()), **kw)
                    assert torch.equal(_bits(got[..., c]), _bits(one))


@pytest.mark.parametrize("coalesce", [False, True])
@pytest.mark.parametrize("gen", ["banded", "powerlaw"])
def test_spmv_cuda_bitwise_vs_torch_backend(gen, coalesce):
    """End to end on the card: the cuda backend equals the torch backend
    bit for bit and counts its kernel launches."""
    dev = _cuda()
    m = _matrix(gen)
    vals, x = _data(m, np.float32)
    xd = torch.as_tensor(x, device=dev)
    ys = {}
    for backend in ("torch", "cuda"):
        for fn in K.KERNELS.values():
            fn.launches = 0
        sp = SpMV.from_coo(m.rows, m.cols, vals, m.shape, backend=backend,
                           coalesce=coalesce, device=dev)
        ys[backend] = sp.matvec(xd)
        torch.cuda.synchronize()
        launched = sum(fn.launches for fn in K.KERNELS.values())
        assert (launched > 0) == (backend == "cuda")
    assert torch.equal(_bits(ys["cuda"]), _bits(ys["torch"]))
    ref = np.zeros(m.shape[0])
    np.add.at(ref, m.rows, vals.astype(np.float64) * x[m.cols])
    y = ys["cuda"].cpu().numpy()
    assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()


def test_wrappers_reject_bad_operands_on_card():
    dev = _cuda()
    seg = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    win = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    x = torch.ones(8, device=dev)
    with pytest.raises(TypeError, match="must be torch.int32"):
        K.window_stage_a(win, [x], [], seg.long(), seg, seg, op=0,
                         stream=False, reduce="add")
    with pytest.raises(ValueError, match="is on cpu"):
        K.window_stage_a(win, [x.cpu()], [], seg, seg, seg, op=0,
                         stream=False, reduce="add")
    with pytest.raises(ValueError, match="shape"):
        K.dense_slice_stage_a(seg[0, :1], [x], [], None, seg, op=0,
                              reduce="add")


@pytest.mark.parametrize("reduce,dtype", SEMIRINGS)
@pytest.mark.parametrize("gen", ["banded", "powerlaw"])
def test_spmm_and_matvec_many_cuda_bitwise_vs_torch(gen, reduce, dtype):
    """SpMM at d = 16 on the card: cuda == torch bit for bit, fused and
    coalesced; ``matvec_many`` rows == ``matvec`` (add only: SpMV's
    seed)."""
    dev = _cuda()
    m = _matrix(gen)
    vals, _ = _data(m, dtype)
    rng = np.random.default_rng(1)
    bmat = (rng.integers(-5, 6, (m.shape[1], 16)) if dtype == np.int32
            else rng.standard_normal((m.shape[1], 16))).astype(dtype)
    bd = torch.as_tensor(bmat, device=dev)
    for coalesce in (False, True):
        ys = {}
        for backend in ("torch", "cuda"):
            for fn in K.KERNELS.values():
                fn.launches = 0
            sp = SpMM.from_coo(m.rows, m.cols, vals, m.shape,
                               backend=backend, coalesce=coalesce,
                               reduce=reduce, device=dev)
            ys[backend] = sp.matmat(bd)
            torch.cuda.synchronize()
            launched = sum(fn.launches for fn in K.KERNELS.values())
            assert (launched > 0) == (backend == "cuda")
        assert torch.equal(_bits(ys["cuda"]), _bits(ys["torch"]))
    if reduce == "add":
        sp = SpMV.from_coo(m.rows, m.cols, vals, m.shape, backend="cuda",
                           device=dev)
        xs = bd.T[:5].contiguous()
        many = sp.matvec_many(xs)
        for i in range(5):
            assert torch.equal(_bits(many[i]), _bits(sp.matvec(xs[i])))


def _segments(rng, b, n):
    seg = np.zeros((b, n), dtype=np.int32)
    for bi in range(b):
        cuts = rng.choice(np.arange(1, n), size=min(n - 1, 5),
                          replace=False)
        for c in cuts:
            seg[bi, c:] += 1
    return seg


@pytest.mark.parametrize("op_flag", [0, 3, 7, common.FULL_REDUCE])
@pytest.mark.parametrize("trailing", [(), (3,), (16,)])
@pytest.mark.parametrize("reduce,dtype", [("add", torch.float32),
                                          ("mul", torch.float32),
                                          ("min", torch.int32),
                                          ("max", torch.int32),
                                          ("add", torch.float64)])
@pytest.mark.parametrize("n", [16, 24, 128])
def test_segment_reduce_bitwise_vs_plain(n, reduce, dtype, trailing,
                                         op_flag):
    dev = _cuda()
    rng = np.random.default_rng(n)
    b = 40
    x = rng.standard_normal((b, n) + trailing)
    x = torch.as_tensor(np.rint(x * 3) if dtype == torch.int32 else x,
                        dtype=dtype, device=dev)
    seg = torch.as_tensor(_segments(rng, b, n), device=dev)
    want = SR.segment_reduce_plain(x, seg, op_flag, reduce)
    before = SR.segment_reduce.launches
    for rows in (1, 3, 8):
        got = SR.segment_reduce(x, seg, op_flag, reduce, rows_per_step=rows)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want)), rows
    assert SR.segment_reduce.launches == before + 3


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("trailing", [(), (3,), (16,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32,
                                   torch.bfloat16, torch.float64])
@pytest.mark.parametrize("ls", [1, 2, 4, 32])
def test_gather_vload_bitwise_vs_plain(ls, dtype, trailing, stream):
    dev = _cuda()
    n, b, nwin = 128, 50, 64
    rng = np.random.default_rng(ls)
    x_view = torch.as_tensor(rng.standard_normal((nwin, n) + trailing) * 9,
                             device=dev).to(dtype)
    win = torch.as_tensor(rng.integers(0, nwin, (b, 32)).astype(np.int32),
                          device=dev)
    slot = torch.as_tensor(rng.integers(0, ls, (b, n)).astype(np.int32),
                           device=dev)
    off = torch.as_tensor(rng.integers(0, n, (b, n)).astype(np.int32),
                          device=dev)
    kw = dict(ls=ls, stream=stream)
    got = GV.gather_vload(x_view, win, slot, off, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(GV.gather_vload_plain(
        x_view, win, slot, off, **kw)))


@pytest.mark.parametrize("d_tile", [1, 96, 512])
@pytest.mark.parametrize("d", [7, 128, 768, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_gather_bitwise_vs_plain(dtype, d, d_tile):
    dev = _cuda()
    rng = np.random.default_rng(d)
    src = torch.as_tensor(rng.standard_normal((65, d)), device=dev).to(dtype)
    rows = torch.as_tensor(np.sort(rng.integers(0, 65, 300)).astype(np.int32),
                           device=dev)
    got = RG.row_gather(src, rows, d_tile=d_tile)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(RG.row_gather_plain(src, rows)))
    # an odd-sized view: the kernel falls back to narrower words
    got = RG.row_gather(src[:, 1:].contiguous(), rows, d_tile=d_tile)
    assert torch.equal(_bits(got),
                       _bits(RG.row_gather_plain(src[:, 1:], rows)))
