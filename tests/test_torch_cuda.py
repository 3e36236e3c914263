"""The CUDA kernels on the card, bitwise against their plain versions.

These tests need a CUDA device: the kernels have no interpret mode.  Each
one decides inside the test whether a card exists and skips, with the
reason, where there is none.  The file imports nothing of JAX or of the
reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import functools
import math

import numpy as np
import pytest
import torch

from repro_torch.core import engine as eng
from repro_torch.core import ir
from repro_torch.core.apps import SpMV
from repro_torch.core.plan import CostModel, build_plan
from repro_torch.core.seed import spmv_seed
from repro_torch.core.spmm import SpMM
from repro_torch.kernels import build, common
from repro_torch.kernels.gather_vload import kernel as GV
from repro_torch.kernels.moe_dispatch import kernel as RG
from repro_torch.kernels.segment_reduce import kernel as SR
from repro_torch.kernels.unroll_spmv import kernel as K
from repro_torch.kernels.unroll_spmv import ops
from repro_torch.sparse import generators as G

pytestmark = pytest.mark.cuda

SEMIRINGS = [("add", np.float32), ("mul", np.float32), ("min", np.int32),
             ("max", np.int32)]
# lane widths: one warp or part of one, a warp and one lane, widths that are
# not powers of two, and every register count of the ladder up to 1024
LANES = [8, 16, 24, 32, 33, 64, 96, 128, 256, 1024]
ROWS = (1, 3, 8)


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
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("reduce,dtype", SEMIRINGS)
@pytest.mark.parametrize("lane", LANES)
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
                for rows in ROWS:
                    got = kernel(*args, rows_per_step=rows, **kw)
                    torch.cuda.synchronize()
                    assert torch.equal(_bits(got), _bits(want)), \
                        (la.gather, la.start, la.op_flag, rows)
                seen.add(kernel)
    assert seen, "no kernel launch in the lowering"


@pytest.mark.parametrize("d", [3, 4, 16, 17, 64])
@pytest.mark.parametrize("reduce,dtype", SEMIRINGS)
@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("gen", ["banded", "powerlaw"])
def test_kernels_bitwise_vs_plain_trailing(gen, lane, reduce, dtype, d):
    """Trailing lane axes: every kernel launch of both lowerings on an
    (n, d) operand against the plain version for several
    ``rows_per_step`` values, and column ``c`` of the launch bitwise equal
    to the launch on column ``c`` alone."""
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
                want = plain(*args(xd), **kw)
                for rows in ROWS:
                    got = kernel(*args(xd), rows_per_step=rows, **kw)
                    torch.cuda.synchronize()
                    assert torch.equal(_bits(got), _bits(want)), \
                        (la.gather, la.start, la.op_flag, rows)
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


def _depths(n):
    """Every ladder depth from 0 to ceil(log2 n) (and up to 7, the main
    path's, where that is deeper), then FULL_REDUCE."""
    return [*range(max(math.ceil(math.log2(n)), 7) + 1), common.FULL_REDUCE]


TRAILING = [(), (3,), (4,), (16,), (17,), (64,)]


@pytest.mark.parametrize("trailing", TRAILING)
@pytest.mark.parametrize("reduce,dtype", [("add", torch.float32),
                                          ("mul", torch.float32),
                                          ("min", torch.int32),
                                          ("max", torch.int32),
                                          ("add", torch.float64)])
@pytest.mark.parametrize("n", LANES)
def test_segment_reduce_bitwise_vs_plain(n, reduce, dtype, trailing):
    """Every depth and ``rows_per_step`` value, bitwise against the plain
    version."""
    dev = _cuda()
    rng = np.random.default_rng(n)
    b = 24
    x = rng.standard_normal((b, n) + trailing)
    x = torch.as_tensor(np.rint(x * 3) if dtype == torch.int32 else x,
                        dtype=dtype, device=dev)
    seg = torch.as_tensor(_segments(rng, b, n), device=dev)
    before = SR.segment_reduce.launches
    depths = _depths(n)
    for op_flag in depths:
        want = SR.segment_reduce_plain(x, seg, op_flag, reduce)
        for rows in ROWS:
            got = SR.segment_reduce(x, seg, op_flag, reduce,
                                    rows_per_step=rows)
            torch.cuda.synchronize()
            assert torch.equal(_bits(got), _bits(want)), (op_flag, rows)
    assert SR.segment_reduce.launches == before + len(ROWS) * len(depths)


def _stage_a_case(form, rng, bc, n, d, dtype, dev, two, local):
    """Random operands of one stage-A launch: the kernel's positional
    arguments, less the keyword ones."""
    rows = bc * n + 3 * n
    shape = (rows,) if d == 1 else (rows, d)

    def values(shape):
        v = (rng.integers(-3, 4, shape) if dtype == np.int32
             else rng.standard_normal(shape)).astype(dtype)
        return torch.as_tensor(v, device=dev)

    gathered = [values(shape)] + ([values(shape)] if two else [])
    elem = [values((bc, n))]
    seg = torch.as_tensor(_segments(rng, bc, n), device=dev)
    i32 = functools.partial(torch.as_tensor, dtype=torch.int32, device=dev)
    if form == "dense":
        starts = i32(rng.integers(0, rows - n + 1, bc))
        perm = i32(np.stack([rng.permutation(n) for _ in range(bc)])) \
            if local else None
        return (starts, gathered, elem, perm, seg)
    nwin = rows // n
    win = i32(rng.integers(0, nwin, (bc, 4)))
    slot = i32(rng.integers(0, 4, (bc, n)))
    off = i32(rng.integers(0, n, (bc, n)))
    return (win, gathered, elem, slot, off, seg)


@pytest.mark.parametrize("reduce,dtype", SEMIRINGS)
@pytest.mark.parametrize("form", ["dense", "window"])
@pytest.mark.parametrize("d", [1, 3, 4, 16, 17, 64])
@pytest.mark.parametrize("n", [8, 24, 32, 33, 64, 96, 128, 256, 1024])
def test_stage_a_every_depth_bitwise_vs_plain(n, d, form, reduce, dtype):
    """Both stage-A kernels on random operands: every depth from 0 to
    ceil(log2 n) and FULL_REDUCE, with and without the fused mixed
    section's per-block full flags, one and two gathered operands,
    permuted and identity slices (dense form), window and stream launches
    (window form), each ``rows_per_step`` value, bitwise against the plain
    version."""
    dev = _cuda()
    rng = np.random.default_rng(n * 100 + d)
    bc = 24
    kernel, plain = {"dense": (K.dense_slice_stage_a,
                               K.dense_slice_stage_a_plain),
                     "window": (K.window_stage_a,
                                K.window_stage_a_plain)}[form]
    full = torch.as_tensor((rng.random(bc) < 0.3).astype(np.int32),
                           device=dev)
    before = kernel.launches
    launched = 0
    for variant in (False, True):   # two operands; permuted / stream
        args = _stage_a_case(form, rng, bc, n, d, dtype, dev, variant,
                             variant)
        extra = {"stream": variant} if form == "window" else {}
        for op in _depths(n):
            for flags in (None, full):
                kw = dict(op=op, reduce=reduce, full_flags=flags, **extra)
                want = plain(*args, **kw)
                for rows in ROWS:
                    got = kernel(*args, rows_per_step=rows, **kw)
                    torch.cuda.synchronize()
                    launched += 1
                    assert torch.equal(_bits(got), _bits(want)), \
                        (variant, op, flags is not None, rows)
    assert kernel.launches == before + launched


def _edge_values(rng, shape, dtype, dev):
    """Random operand values with the edges of each type mixed in: NaN and
    +-inf for floats, INT32_MAX / INT32_MIN and their neighbours for
    int32 (where + and * wrap)."""
    if dtype == np.int32:
        edges = np.array([2 ** 31 - 1, 2 ** 31 - 2, -(2 ** 31),
                          -(2 ** 31) + 1, 1 << 30], np.int64)
        v = rng.integers(-3, 4, shape)
    else:
        edges = np.array([np.nan, np.inf, -np.inf])
        v = rng.standard_normal(shape)
    pick = rng.random(shape) < 0.05
    v = np.where(pick, edges[rng.integers(0, edges.size, shape)], v)
    return torch.as_tensor(v.astype(dtype), device=dev)


def _same_bits(got, want) -> bool:
    """Bitwise equal, except that a float64 NaN equals any NaN in the same
    word: the card keeps float64 NaN signs and payloads, and which operand's
    a sum or product of two NaNs carries is the compiler's choice (float32
    NaN results are canonical, so float32 stays bit for bit)."""
    if got.dtype == torch.float64:
        nan = got.isnan()
        if not torch.equal(nan, want.isnan()):
            return False
        got, want = got.masked_fill(nan, 0.0), want.masked_fill(nan, 0.0)
    return torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float64],
                         ids=lambda t: t.__name__)
@pytest.mark.parametrize("reduce", ["add", "mul", "max", "min"])
@pytest.mark.parametrize("form", ["dense", "window"])
@pytest.mark.parametrize("d", [1, 4, 17, 64])
@pytest.mark.parametrize("n", [8, 33, 128, 1024])
def test_add_all_every_depth_bitwise_vs_plain(n, d, form, reduce, dtype):
    """The ``"add_all"`` combine in both stage-A kernels, with and without
    its addend, over one gathered operand plus an elementwise one (SSSP,
    BFS), two gathered ones, and one alone (CC), on values with NaN, +-inf
    and int32 extremes: every depth, with and without the fused mixed
    section's flags, permuted and identity slices, window and stream
    launches, two ``rows_per_step`` values, bitwise against the plain
    version (float64 NaN words as NaN: :func:`_same_bits`); float64 also
    runs ``"mul_all"``."""
    dev = _cuda()
    rng = np.random.default_rng(n * 7 + d)
    bc = 16
    kernel, plain = {"dense": (K.dense_slice_stage_a,
                               K.dense_slice_stage_a_plain),
                     "window": (K.window_stage_a,
                                K.window_stage_a_plain)}[form]
    full = torch.as_tensor((rng.random(bc) < 0.3).astype(np.int32),
                           device=dev)
    addend = 1 if dtype == np.int32 else 0.25
    combines = [("add_all", addend), ("add_all", None)]
    if dtype == np.float64:
        combines.append(("mul_all", None))
    for variant in range(3):    # g0 + e0; g0 + g1 (permuted / stream); g0
        args = list(_stage_a_case(form, rng, bc, n, d, dtype, dev,
                                  variant == 1, variant == 1))
        args[1] = [_edge_values(rng, tuple(g.shape), dtype, dev)
                   for g in args[1]]
        args[2] = [] if variant else [_edge_values(rng, (bc, n), dtype, dev)]
        extra = {"stream": variant == 1} if form == "window" else {}
        for combine, c in combines:
            for op in _depths(n):
                for flags in (None, full):
                    kw = dict(op=op, reduce=reduce, full_flags=flags,
                              combine=combine, addend=c, **extra)
                    want = plain(*args, **kw)
                    for rows in (1, 8):
                        got = kernel(*args, rows_per_step=rows, **kw)
                        torch.cuda.synchronize()
                        assert _same_bits(got, want), \
                            (variant, combine, c, op, flags is not None,
                             rows)


@pytest.mark.parametrize("xdtype", [np.float64, np.float16, np.int32],
                         ids=lambda t: t.__name__)
@pytest.mark.parametrize("coalesce", [False, True])
@pytest.mark.parametrize("gen", ["banded", "dense"])
def test_cuda_backend_takes_every_x_dtype_on_card(gen, coalesce, xdtype):
    """Float32 values with a float64, float16 or int32 ``x`` (and a float64
    ``B``) on the card: the kernels run in the promoted dtype, bitwise equal
    to the torch backend."""
    dev = _cuda()
    m = _matrix(gen)
    vals = np.asarray(m.vals, np.float32)
    rng = np.random.default_rng(3)
    x = (rng.integers(-5, 6, m.shape[1]) if xdtype == np.int32
         else rng.standard_normal(m.shape[1])).astype(xdtype)
    xd = torch.as_tensor(x, device=dev)
    bd = torch.as_tensor(rng.standard_normal((m.shape[1], 4)), device=dev)
    ys = {}
    for backend in ("torch", "cuda"):
        for fn in K.KERNELS.values():
            fn.launches = 0
        sp = SpMV.from_coo(m.rows, m.cols, vals, m.shape, lane_width=8,
                           backend=backend, coalesce=coalesce, device=dev)
        smm = SpMM.from_coo(m.rows, m.cols, vals, m.shape, lane_width=8,
                            backend=backend, coalesce=coalesce, device=dev)
        ys[backend] = (sp.matvec(xd), smm.matmat(bd))
        torch.cuda.synchronize()
        launched = sum(fn.launches for fn in K.KERNELS.values())
        assert (launched > 0) == (backend == "cuda")
    for got, want in zip(ys["cuda"], ys["torch"]):
        assert got.dtype == want.dtype
        assert torch.equal(_bits(got), _bits(want))
    assert ys["cuda"][0].dtype == xd.dtype
    assert ys["cuda"][1].dtype == torch.float64


@pytest.mark.parametrize("kind", ["powerlaw", "uniform", "ring", "isolated",
                                  "empty"])
def test_graph_apps_cuda_bitwise_vs_torch(kind):
    """BFS, SSSP, CC and PageRank at a small size on the card: the kernel
    backend equals the torch backend bit for bit in states and
    convergence reports, on both drivers, and ``run_multi`` rows equal
    ``run``; the kernels were launched."""
    from repro_torch.core.apps import PageRank
    from repro_torch.core.graphs import BFS, SSSP, ConnectedComponents
    dev = _cuda()
    c = G.graph_case(kind, 4000 if kind != "ring" else 300, 6)
    apps = {"bfs": (BFS, (c.src, c.dst, c.num_nodes)),
            "sssp": (SSSP, (c.src, c.dst, c.weight, c.num_nodes)),
            "cc": (ConnectedComponents, (c.src, c.dst, c.num_nodes)),
            "pagerank": (PageRank, (c.src, c.dst, c.num_nodes))}
    for name, (cls, edges) in apps.items():
        outs = {}
        for backend in ("torch", "cuda"):
            for driver in ("resident", "host"):
                for fn in K.KERNELS.values():
                    fn.launches = 0
                app = cls.from_edges(*edges, lane_width=128, backend=backend,
                                     driver=driver, device=dev)
                if name == "pagerank":
                    out, report = app.run(iters=10), None
                else:
                    out = app.run() if name == "cc" else app.run(0)
                    report = app.convergence
                torch.cuda.synchronize()
                launched = sum(fn.launches for fn in K.KERNELS.values())
                if kind != "empty":
                    assert (launched > 0) == (backend == "cuda"), name
                outs[backend, driver] = (_bits(out).cpu(), report)
                if name in ("bfs", "sssp") and driver == "resident":
                    multi = app.run_multi([0, 5, 9])
                    for i, s in enumerate([0, 5, 9]):
                        assert torch.equal(_bits(multi[i]),
                                           _bits(app.run(s))), (name, i)
        base = outs["torch", "resident"]
        for key, (bits, report) in outs.items():
            assert torch.equal(bits, base[0]) and report == base[1], \
                (name, key)


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


@pytest.mark.parametrize("n", [8, 32, 128, 256])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 16, 17, 64])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32,
                                   torch.float64])
def test_gather_vload_row_copy_bitwise_vs_plain(dtype, d, n):
    """Every access width and shape of the row copy: 1- to 8-byte elements,
    rows of 1 to 64 elements, 8 to 256 lanes; a view that starts one element
    into its buffer (no 16-byte access is legal); 0, 1 and 37 blocks (not a
    multiple of a CTA's items); window ids wider than ``ls``, and ``ls``
    past 32 (window ids loaded, not shuffled); and the stream form."""
    dev = _cuda()
    rng = np.random.default_rng(100 * n + d)
    nwin = 40
    trailing = () if d == 1 else (d,)
    buf = torch.as_tensor(rng.standard_normal(nwin * n * d + 1) * 9,
                          device=dev).to(dtype)
    for shift in (0, 1):
        x_view = buf[shift:shift + nwin * n * d].view((nwin, n) + trailing)
        for b in (0, 1, 37):
            for ls in (1, 32, 40):
                win = torch.as_tensor(rng.integers(0, nwin, (b, ls + 5))
                                      .astype(np.int32), device=dev)
                slot = torch.as_tensor(rng.integers(0, ls, (b, n))
                                       .astype(np.int32), device=dev)
                off = torch.as_tensor(rng.integers(0, n, (b, n))
                                      .astype(np.int32), device=dev)
                for stream in (False, True):
                    kw = dict(ls=ls, stream=stream)
                    got = GV.gather_vload(x_view, win, slot, off, **kw)
                    torch.cuda.synchronize()
                    assert torch.equal(_bits(got), _bits(
                        GV.gather_vload_plain(x_view, win, slot, off, **kw))
                    ), (shift, b, ls, stream)


@pytest.mark.parametrize("d", [1, 7, 8, 100, 4096])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32,
                                   torch.float64])
def test_row_gather_row_copy_bitwise_vs_plain(dtype, d):
    """No rows and one row; repeated, sorted ids and the appended zero row;
    sources that start one element and one row into their buffer."""
    dev = _cuda()
    rng = np.random.default_rng(d)
    t = 50
    buf = torch.as_tensor(rng.standard_normal((t + 1) * d + 1) * 9,
                          device=dev).to(dtype)
    zero = torch.zeros((1, d), dtype=dtype, device=dev)
    srcs = [torch.cat([buf[:t * d].view(t, d), zero]),
            buf[1:1 + t * d].view(t, d), buf[d:d + t * d].view(t, d)]
    for src in srcs:
        for ids in ([], [3], np.sort(rng.integers(0, src.shape[0], 300)),
                    [src.shape[0] - 1] * 40 + [0] * 3):
            rows = torch.as_tensor(np.asarray(ids, dtype=np.int32),
                                   device=dev)
            got = RG.row_gather(src, rows)
            torch.cuda.synchronize()
            assert torch.equal(_bits(got),
                               _bits(RG.row_gather_plain(src, rows)))


def test_row_gather_source_past_2_31_bytes():
    """A 4.3 GB bf16 source gathered in reverse: source and output row
    offsets pass 2^31 bytes."""
    dev = _cuda()
    t, d = 2 ** 19 + 1, 4096
    src = torch.empty((t, d), dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for start in range(0, t, 1 << 16):
        part = src[start:start + (1 << 16)]
        part.copy_(torch.randn(part.shape, generator=gen, device=dev))
    rows = torch.arange(t - 1, -1, -1, dtype=torch.int32, device=dev)
    got = RG.row_gather(src, rows)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(src.flip(0)))
    del got
    tail = torch.tensor([t - 1, 0, t - 2, t - 1], dtype=torch.int32,
                        device=dev)
    assert torch.equal(_bits(RG.row_gather(src, tail)),
                       _bits(RG.row_gather_plain(src, tail)))


@pytest.mark.parametrize("log_tpl", [0, 2, 3, 5])
def test_row_copy_shape_is_neutral_on_card(log_tpl):
    """Any number of threads per row gives the same bits (rows of 10 words
    go the long-row way below 16 threads); only the access width must suit
    the pointers."""
    dev = _cuda()
    rng = np.random.default_rng(log_tpl)
    src = torch.as_tensor(rng.standard_normal((30, 40)).astype(np.float32),
                          device=dev)
    rows = torch.as_tensor(rng.integers(0, 30, 77).astype(np.int32),
                           device=dev)
    out = torch.empty((77, 40), device=dev)
    assert RG.library().row_gather(
        src.data_ptr(), rows.data_ptr(), out.data_ptr(), 77, 160, 16,
        log_tpl, build.stream_of(src)) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, RG.row_gather_plain(src, rows))
    view = src.view(20, 6, 10)
    win = torch.as_tensor(rng.integers(0, 20, (9, 4)).astype(np.int32),
                          device=dev)
    slot = torch.as_tensor(rng.integers(0, 4, (9, 6)).astype(np.int32),
                           device=dev)
    off = torch.as_tensor(rng.integers(0, 6, (9, 6)).astype(np.int32),
                          device=dev)
    out = torch.empty((9, 6, 10), device=dev)
    assert GV.library().gather_vload(
        view.data_ptr(), win.data_ptr(), 4, 4, 0, slot.data_ptr(),
        off.data_ptr(), out.data_ptr(), 9, 6, 40, 8, log_tpl,
        build.stream_of(src)) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, GV.gather_vload_plain(view, win, slot, off, ls=4))


def test_row_copy_rejects_widths_the_pointers_do_not_allow():
    """The C entry points return cudaErrorInvalidValue (1) for an access
    width that does not divide the row or a pointer, and for a shape out of
    range, and launch nothing."""
    dev = _cuda()
    src = torch.zeros((4, 8), device=dev)
    out = torch.full((2, 8), 7.0, device=dev)
    ids = torch.zeros(2, dtype=torch.int32, device=dev)
    st = build.stream_of(src)
    lib = RG.library()
    p, o, i = src.data_ptr(), out.data_ptr(), ids.data_ptr()
    assert lib.row_gather(p + 4, i, o, 2, 32, 16, 1, st) == 1
    assert lib.row_gather(p, i, o + 8, 2, 32, 16, 1, st) == 1
    assert lib.row_gather(p, i, o, 2, 24, 16, 1, st) == 1
    assert lib.row_gather(p, i, o, 2, 32, 3, 1, st) == 1
    assert lib.row_gather(p, i, o, 2, 32, 16, 6, st) == 1
    assert lib.row_gather(p, i, o, 2, 32, 16, -1, st) == 1
    assert GV.library().gather_vload(
        p + 4, i, 1, 1, 0, i, i, o, 1, 2, 16, 16, 0, st) == 1
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())
