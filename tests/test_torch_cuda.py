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
from repro_torch.core.seed import reduce_identity_for, spmv_seed
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


@pytest.mark.parametrize("d", [None, 5])
@pytest.mark.parametrize("reduce,dtype", SEMIRINGS)
@pytest.mark.parametrize("gen", ["banded", "powerlaw"])
def test_segsum_on_card_vs_cpu(gen, reduce, dtype, d):
    """``backend="segsum"`` on the card against the same program on the CPU:
    its float add/mul is atomic on the card, so ``allclose``; int32 and
    min/max are exact."""
    dev = _cuda()
    m = _matrix(gen)
    vals, x = _data(m, dtype)
    if d is not None:
        x = np.stack([np.roll(x, k) for k in range(d)], axis=1)
    plan = _plan(gen, 16)
    y0 = np.full((m.shape[0],) + x.shape[1:],
                 reduce_identity_for(reduce, dtype), dtype)
    outs = []
    for device in (dev, torch.device("cpu")):
        run = eng.make_executor(plan, {"value": vals}, backend="segsum",
                                device=device)
        outs.append(run({"x": torch.as_tensor(x, device=device)},
                        torch.as_tensor(y0, device=device)).cpu())
    got, want = outs
    if reduce in ("min", "max") or np.issubdtype(np.dtype(dtype),
                                                 np.integer):
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_autotune_on_card_measures_a_cuda_candidate(tmp_path):
    """``backend="auto"`` on the card: the space holds the kernels, at least
    one ``cuda`` candidate is measured and none is disqualified, the winner
    matches the plain torch backend, and a warm rebuild measures
    nothing."""
    import warnings
    from repro_torch import tune as T
    dev = _cuda()
    m = _matrix("banded")
    vals, x = _data(m, np.float32)
    kw = dict(backend="auto", tune_cache_dir=str(tmp_path), device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        app = SpMV.from_coo(m.rows, m.cols, vals, m.shape, **kw)
    res = app.tuning
    assert res.platform == "cuda" and res.picked_by == "measurement"
    assert any(mm.candidate.backend == "cuda" for mm in res.measurements)
    assert all(mm.ok and np.isfinite(mm.us_per_call)
               for mm in res.measurements)
    xd = torch.as_tensor(x, device=dev)
    want = SpMV.from_coo(m.rows, m.cols, vals, m.shape,
                         device=dev).matvec(xd)
    torch.testing.assert_close(app.matvec(xd), want, rtol=1e-5, atol=1e-5)
    before = T.measurement_count()
    warm = SpMV.from_coo(m.rows, m.cols, vals, m.shape, **kw)
    assert warm.tuning.cache_hit and warm.tuning.best == res.best
    assert T.measurement_count() == before
    assert app.report().totals["launches"] == len(app._run.tree.launches)


@pytest.mark.parametrize("stage", ["launch", "timed"])
def test_autotune_on_card_raises_when_a_kernel_candidate_fails(
        stage, monkeypatch):
    """On the card a ``cuda`` candidate that raises makes the tuned build
    raise, where the tuner would otherwise disqualify it and let a plain
    torch form win: at its first launch (both stage-A wrappers broken) or
    in a timed call after a good oracle check."""
    from repro_torch import tune as T
    from repro_torch.tune import search as tsearch
    dev = _cuda()
    m = _matrix("banded")
    vals, x = _data(m, np.float32)
    if stage == "launch":
        def broken(*a, **k):
            raise RuntimeError("stage-A launch failed")
        monkeypatch.setattr(ops, "window_stage_a", broken)
        monkeypatch.setattr(ops, "dense_slice_stage_a", broken)
        with pytest.raises(T.KernelCandidateError, match="launch failed"):
            SpMV.from_coo(m.rows, m.cols, vals, m.shape, backend="auto",
                          device=dev)
        return

    def factory(plan, cand, static_data, elem_exec):
        run = tsearch._default_exec_factory(plan, cand, static_data,
                                            elem_exec, device=dev)
        if cand.backend != "cuda":
            return run
        calls = []

        def flaky(mutable, out_init):
            calls.append(1)
            if len(calls) > 1:
                raise RuntimeError("timed launch failed")
            return run(mutable, out_init)
        return flaky
    with pytest.raises(T.KernelCandidateError, match="during measurement"):
        T.autotune(spmv_seed(), {"row": m.rows, "col": m.cols}, m.shape[0],
                   m.shape[1], {"value": vals},
                   {"x": torch.as_tensor(x, device=dev)},
                   torch.zeros(m.shape[0], device=dev), exec_factory=factory)


# ------------------------------------------------------ serving on the card
def _serve_apps(dev):
    from repro_torch.core.graphs import BFS, SSSP
    c = G.graph_case("powerlaw", 3000, avg_deg=6, seed=7)
    m = _matrix("banded")
    vals, _ = _data(m, np.float32)
    kw = dict(backend="cuda", lane_width=128, fused=True, device=dev)
    return {"bfs": BFS.from_edges(c.src, c.dst, c.num_nodes, **kw),
            "sssp": SSSP.from_edges(c.src, c.dst, c.weight, c.num_nodes,
                                    **kw),
            "spmv": SpMV.from_coo(m.rows, m.cols, vals, m.shape,
                                  coalesce=True, **kw)}


def _serve_payloads(apps, n=12):
    rng = np.random.default_rng(0)
    nodes = apps["bfs"].num_nodes
    cols = apps["spmv"].shape[1]
    return ([("bfs", int(s)) for s in rng.integers(0, nodes, n)]
            + [("sssp", int(s)) for s in rng.integers(0, nodes, n)]
            + [("spmv", x) for x in
               rng.standard_normal((n, cols)).astype(np.float32)])


def test_served_batches_bitwise_sequential_on_card(monkeypatch):
    """Every endpoint over a ``backend="cuda"`` app: each served response
    is bitwise the sequential ``run`` / ``matvec``; the stage-A counters,
    zeroed after warm-up, grow during the traffic; each batch runs on the
    dispatcher thread, on the app's card and its default stream; and
    ``warmup`` leaves every endpoint warm."""
    import threading
    from repro_torch.serve import query as Q
    dev = _cuda()
    apps = _serve_apps(dev)
    seen = []

    def spy(app, name):
        real = getattr(app, name)

        def call(*a, **k):
            seen.append((threading.current_thread().name,
                         torch.cuda.current_device(),
                         torch.cuda.current_stream(dev)
                         == torch.cuda.default_stream(dev)))
            return real(*a, **k)
        monkeypatch.setattr(app, name, call)
    spy(apps["bfs"], "run_multi")
    spy(apps["sssp"], "run_multi")
    spy(apps["spmv"], "matvec_many")
    eps = [Q.bfs_endpoint(apps["bfs"], max_batch=8),
           Q.sssp_endpoint(apps["sssp"], max_batch=8),
           Q.spmv_endpoint(apps["spmv"], max_batch=16)]
    payloads = _serve_payloads(apps)
    side = torch.cuda.Stream(dev)
    with Q.QueryEngine(eps, queue_capacity=len(payloads)) as engine:
        with torch.cuda.stream(side):     # the caller's stream is not used
            for ep in eps:
                first = next(p for k, p in payloads if k == ep.name)
                engine.warmup(ep.name, first, batch=ep.max_batch)
        health = engine.health()
        for ep in eps:
            assert health["endpoints"][ep.name]["warm"] is True
        K.window_stage_a.launches = 0
        K.dense_slice_stage_a.launches = 0
        seen.clear()
        tickets = [(k, p, engine.submit(k, p)) for k, p in payloads]
        responses = [(k, p, t.result(120)) for k, p, t in tickets]
        torch.cuda.synchronize(dev)
        window = K.window_stage_a.launches
        dense = K.dense_slice_stage_a.launches
        health = engine.health()
    assert window > 0 and dense > 0
    assert seen and all(name == "repro-serve-dispatcher" and d == dev.index
                        and default for name, d, default in seen)
    assert health["breaker"]["state"] == "closed"
    assert health["counters"]["served"] == len(payloads) + len(eps)
    for kind, payload, r in responses:
        assert isinstance(r.value, np.ndarray)
        if kind == "spmv":
            want = apps["spmv"].matvec(torch.as_tensor(payload, device=dev))
        else:
            want = apps[kind].run(payload)
        assert np.array_equal(_bits(torch.as_tensor(r.value)).numpy(),
                              _bits(want.cpu()).numpy()), (kind, r.batch_size)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_row_gather_dispatch_bitwise_on_card(dtype, monkeypatch):
    """A reduced qwen3-moe layer on the card: its dispatch and combine run
    the row-gather kernel (two launches per group), and its output is
    bitwise that of the same layer on the plain row gather."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    dev = _cuda()
    cfg = get_config("qwen3-moe-235b-a22b").reduced().replace(
        param_dtype=dtype, compute_dtype=dtype, moe_group_size=40,
        capacity_factor=0.5)                   # 40 slots for 80 entries
    gen = torch.Generator(dev).manual_seed(0)
    p = {k: v.value for k, v in moe.init_moe(gen, cfg).items()}
    x = torch.randn((4, 40, cfg.d_model), generator=gen, device=dev,
                    dtype=dtype)
    RG.row_gather.launches = 0
    got, aux = moe.moe(p, x, cfg)
    torch.cuda.synchronize()
    assert RG.row_gather.launches == 2 * 4       # 160 tokens, 4 groups
    monkeypatch.setattr(moe, "row_gather", RG.row_gather_plain)
    want, want_aux = moe.moe(p, x, cfg)
    assert torch.equal(_bits(got), _bits(want))
    assert all(torch.equal(aux[k], want_aux[k]) for k in aux)
    assert float(aux["moe_dropped_frac"]) >= 0.5


# ---------------------------------------------------- sharded execution
def _edges_case():
    """A power-law graph with its edges sorted by destination, so its
    plans cut into several non-empty shards."""
    c = G.graph_case("powerlaw", 3000, 8)
    o = np.lexsort((c.src, c.dst))
    return c.src[o], c.dst[o], c.weight[o], c.num_nodes


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_apps_bitwise_on_card(k):
    """A simulated mesh of ``k`` shards on the one card: sharded SpMV, SpMM
    (min) and BFS / SSSP / PageRank (both drivers) bitwise the
    single-device run of the ``torch`` backend on the card, with equal
    sweeps and flags; ``segsum`` (atomic float sums on the card) within
    the reference's tolerance."""
    from repro_torch.core import graphs
    from repro_torch.core.apps import PageRank
    from repro_torch.launch.mesh import make_shard_mesh
    dev = _cuda()
    sim = dict(shards=k, simulate_mesh=True, device=dev)
    gsim = dict(mesh=make_shard_mesh(k, device=dev, simulate=True),
                device=dev)

    def live(app):
        return sum(p.num_rows > 0 for p in app._shard_parts)
    m = _matrix("powerlaw")
    vals, x = _data(m, np.float32)
    xd = torch.as_tensor(x, device=dev)
    single = SpMV.from_coo(m.rows, m.cols, vals, m.shape, lane_width=32,
                           device=dev).matvec(xd)
    app = SpMV.from_coo(m.rows, m.cols, vals, m.shape, lane_width=32, **sim)
    assert app.mesh.devices == (dev,) * k
    assert torch.equal(_bits(app.matvec(xd)), _bits(single))
    seg = SpMV.from_coo(m.rows, m.cols, vals, m.shape, lane_width=32,
                        backend="segsum", **sim).matvec(xd)
    torch.testing.assert_close(seg, single, rtol=1e-5, atol=1e-5)
    b = torch.as_tensor(np.stack([x, np.roll(x, 1), -x], axis=1),
                        device=dev)
    want = SpMM.from_coo(m.rows, m.cols, vals, m.shape, lane_width=32,
                         reduce="min", device=dev).matmat(b)
    got = SpMM.from_coo(m.rows, m.cols, vals, m.shape, lane_width=32,
                        reduce="min", **sim).matmat(b)
    assert torch.equal(_bits(got), _bits(want))
    src, dst, w, n = _edges_case()
    for driver in ("resident", "host"):
        for cls, args in ((graphs.BFS, (src, dst, n)),
                          (graphs.SSSP, (src, dst, w, n))):
            a1 = cls.from_edges(*args, lane_width=32, driver=driver,
                                device=dev)
            ak = cls.from_edges(*args, lane_width=32, driver=driver, **gsim)
            assert live(ak) >= 2
            assert torch.equal(_bits(ak.run(0)), _bits(a1.run(0)))
            assert ak.convergence == a1.convergence
        p1 = PageRank.from_edges(src, dst, n, lane_width=32, device=dev)
        pk = PageRank.from_edges(src, dst, n, lane_width=32, **gsim)
        assert live(pk) >= 2
        assert torch.equal(_bits(pk.run(20, driver=driver)),
                           _bits(p1.run(20, driver=driver)))
    with pytest.raises(ValueError, match="single-device"):
        SpMV.from_coo(m.rows, m.cols, vals, m.shape, backend="cuda", **sim)


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_cc_from_edges_on_card(k):
    """``ConnectedComponents.from_edges(mesh=...)`` on a simulated mesh of
    ``k`` shards on the card, both drivers: labels, sweeps and flags
    bitwise the single-device ``torch`` run (``chip_smoke.py``'s full-size
    CC cell shards the graph phase's plan instead of building it again)."""
    from repro_torch.core import graphs
    from repro_torch.launch.mesh import make_shard_mesh
    dev = _cuda()
    src, dst, _, n = _edges_case()
    mesh = make_shard_mesh(k, device=dev, simulate=True)
    for driver in ("resident", "host"):
        c1 = graphs.ConnectedComponents.from_edges(src, dst, n, lane_width=32,
                                                   driver=driver, device=dev)
        ck = graphs.ConnectedComponents.from_edges(src, dst, n, lane_width=32,
                                                   driver=driver, mesh=mesh,
                                                   device=dev)
        assert ck.mesh is mesh and len(ck._shard_parts) == k
        assert torch.equal(_bits(ck.run()), _bits(c1.run()))
        assert ck.convergence == c1.convergence


def test_sharded_spmv_on_a_real_mesh():
    """Shards on distinct cards (skips on a machine with one card): the
    sharded SpMV bitwise the single-card run."""
    from repro_torch.launch.mesh import make_shard_mesh
    dev = _cuda()
    k = torch.cuda.device_count()
    if k < 2:
        pytest.skip("needs two or more CUDA devices for a real mesh")
    mesh = make_shard_mesh(k)
    assert len(set(mesh.devices)) == k
    m = _matrix("banded")
    vals, x = _data(m, np.float32)
    xd = torch.as_tensor(x, device=dev)
    single = SpMV.from_coo(m.rows, m.cols, vals, m.shape, lane_width=32,
                           device=dev).matvec(xd)
    got = SpMV.from_coo(m.rows, m.cols, vals, m.shape, lane_width=32,
                        mesh=mesh, device=dev).matvec(xd)
    assert got.device == dev and torch.equal(_bits(got), _bits(single))


# ----------------------------------------------------------- LM training
def _moe_case(dev, dtype):
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("qwen3-moe-235b-a22b").reduced().replace(
        param_dtype=dtype, compute_dtype=dtype, moe_group_size=40,
        capacity_factor=0.5)                   # 40 slots for 80 entries
    gen = torch.Generator(dev).manual_seed(1)
    p = {k: v.value.requires_grad_(True)
         for k, v in moe.init_moe(gen, cfg).items()}
    x = torch.randn((4, 40, cfg.d_model), generator=gen, device=dev,
                    dtype=dtype, requires_grad=True)
    cot = torch.randn((4, 40, cfg.d_model), generator=gen, device=dev,
                      dtype=dtype)
    return cfg, p, x, cot


def _moe_grads(moe, cfg, p, x, cot):
    for t in [x, *p.values()]:
        t.grad = None
    y, aux = moe.moe(p, x, cfg)
    ((y.float() * cot.float()).sum() + aux["moe_aux_loss"]).backward()
    return [y.detach(), x.grad] + [p[k].grad for k in sorted(p)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_row_gather_backward_bitwise_on_card(dtype, monkeypatch):
    """The MoE layer's forward and backward on the card: every row gather
    (two forward and two backward launches per group) is bitwise the
    plain gather on the same operands, and the output and every gradient
    are bitwise those of the same layer on the plain row gather."""
    from repro_torch.models import moe
    dev = _cuda()
    cfg, p, x, cot = _moe_case(dev, dtype)
    calls = []

    def checked(src, ids, d_tile=512):
        got = RG.row_gather(src, ids, d_tile)
        assert torch.equal(_bits(got), _bits(RG.row_gather_plain(src, ids)))
        calls.append(tuple(ids.shape))
        return got

    monkeypatch.setattr(moe, "row_gather", checked)
    RG.row_gather.launches = 0
    got = _moe_grads(moe, cfg, p, x, cot)
    torch.cuda.synchronize()
    assert RG.row_gather.launches == len(calls) == 4 * 4   # 4 groups
    monkeypatch.setattr(moe, "row_gather", RG.row_gather_plain)
    want = _moe_grads(moe, cfg, p, x, cot)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    assert float(x.grad.abs().sum()) > 0


def _train_step_on(dev, cfg, model, batch):
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    model = model.to(dev)
    state = adamw.init(model.tree(), opt)
    state, metrics = loop.make_train_step(cfg, opt)(
        model, state, {k: torch.as_tensor(v, device=dev)
                       for k, v in batch.items()})
    return model, metrics


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-moe-235b-a22b"])
def test_train_step_on_card_matches_cpu(arch):
    """One float32 train step of a reduced model on the card and on the
    CPU from the same weights and batch.  The loss and the gradient norm
    agree at ``rtol=1e-4`` (float32 sums in other orders); every weight
    after the update within ``2.5 lr`` plus that tolerance (AdamW's first
    step moves a weight by about ``lr`` whatever its gradient's size, so a
    near-zero gradient whose sign differs moves it by ``2 lr``)."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models import lm
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    model = lm.init_model(cfg, generator=torch.Generator().manual_seed(3),
                          device="cpu")
    batch = synth_batch(cfg, 4, 16, step=0)
    card, got = _train_step_on(dev, cfg, copy.deepcopy(model), batch)
    cpu, want = _train_step_on(torch.device("cpu"), cfg, model, batch)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    for a, b in zip(card.parameters(), cpu.parameters()):
        scale = max(1.0, float(b.detach().abs().max()))
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   b.detach().numpy(), rtol=1e-4,
                                   atol=2.5e-3 + 1e-5 * scale)


# ------------------------------------------------ recurrent LM families
RECURRENT = {"rwkv6-3b": None,       # 64 tokens: 2 WKV chunks of 32
             "zamba2-1.2b": 8}       # 8 layers, not a multiple of 6
SERVE_TOL = dict(rtol=2e-2, atol=2e-3)     # tests/test_serve.py


def _recurrent_case(arch):
    import copy
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    if RECURRENT[arch]:
        cfg = cfg.replace(num_layers=RECURRENT[arch])
    cpu = lm.init_model(cfg, generator=torch.Generator().manual_seed(4),
                        device="cpu")
    return dev, cfg, cpu, copy.deepcopy(cpu).to(dev)


@pytest.mark.parametrize("arch", sorted(RECURRENT))
def test_recurrent_generate_on_card_matches_cpu(arch):
    """Greedy ``generate`` of a reduced float32 rwkv6 / zamba2 on the card
    and on the CPU from the same weights: the prefill's logits and the
    final cache within ``tests/test_serve.py``'s rule, the tokens equal
    (zamba2 at 8 layers: decode runs the 2 trailing layers)."""
    from repro_torch.serve import engine
    dev, cfg, cpu, card = _recurrent_case(arch)
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(5),
                         dtype=torch.int32)
    for model, where in ((card, dev), (cpu, torch.device("cpu"))):
        cache, last = engine.prefill(model, cfg,
                                     {"tokens": toks.to(where)}, 80)
        out, fin = engine.generate(model, cfg, {"tokens": toks.to(where)},
                                   steps=8, max_len=80)
        if where == dev:
            got = (last.cpu(), out.cpu(), {k: v.cpu() for k, v in
                                           fin.items()})
    np.testing.assert_allclose(got[0].numpy(), last.numpy(), **SERVE_TOL)
    assert torch.equal(got[1], out)
    for k, v in fin.items():
        np.testing.assert_allclose(got[2][k].float().numpy(),
                                   v.float().numpy(), **SERVE_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("arch", sorted(RECURRENT))
def test_recurrent_loss_and_backward_on_card_match_cpu(arch):
    """``loss_fn`` + backward of a reduced float32 rwkv6 / zamba2 on the
    card and on the CPU: the loss and every gradient leaf within
    ``tests/test_serve.py``'s rule (atol times the leaf's scale)."""
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models import lm
    dev, cfg, cpu, card = _recurrent_case(arch)
    batch = synth_batch(cfg, 2, 64, step=0)
    grads = []
    for model, where in ((card, dev), (cpu, torch.device("cpu"))):
        model.requires_grad_(True)
        loss, _ = lm.loss_fn(model, cfg, {k: torch.as_tensor(v, device=where)
                                          for k, v in batch.items()})
        loss.backward()
        grads.append((float(loss.detach()), {k: p.grad.cpu() for k, p in
                                    model.named_parameters()}))
    (lc, gc), (lw, gw) = grads
    np.testing.assert_allclose(lc, lw, **SERVE_TOL)
    assert sorted(gc) == sorted(gw)
    for k, w in gw.items():
        scale = max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(gc[k].numpy(), w.numpy(),
                                   rtol=SERVE_TOL["rtol"],
                                   atol=SERVE_TOL["atol"] * scale,
                                   err_msg=k)


# ------------------------------------------- encoder-decoder and vlm
MODALITY = ("paligemma-3b", "whisper-small")


def _modality_case(arch):
    """A reduced float32 whisper (2 encoder layers over 16 frames) or
    paligemma (8 patch tokens) on the CPU and its copy on the card, and a
    ``synth_batch`` of 2 x 16 tokens with its frames or patches."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models import lm
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    cpu = lm.init_model(cfg, generator=torch.Generator().manual_seed(6),
                        device="cpu")
    batch = synth_batch(cfg, 2, 16, step=0)
    return dev, cfg, cpu, copy.deepcopy(cpu).to(dev), batch


@pytest.mark.parametrize("arch", MODALITY)
def test_modality_generate_on_card_matches_cpu(arch):
    """Greedy ``generate`` of a reduced float32 whisper / paligemma on the
    card and on the CPU from the same weights and inputs: the prefill's
    logits and the final cache (paligemma's prefix slots, whisper's cross
    k/v) within ``tests/test_serve.py``'s rule, the tokens equal."""
    from repro_torch.serve import engine
    dev, cfg, cpu, card, batch = _modality_case(arch)
    batch = {k: v for k, v in batch.items() if k not in ("labels",
                                                         "loss_mask")}
    max_len = cfg.num_prefix + 16 + 8 + 4
    for model, where in ((card, dev), (cpu, torch.device("cpu"))):
        b = {k: torch.as_tensor(v, device=where) for k, v in batch.items()}
        cache, last = engine.prefill(model, cfg, b, max_len)
        out, fin = engine.generate(model, cfg, b, steps=8, max_len=max_len)
        if where == dev:
            got = (last.cpu(), out.cpu(), {k: v.cpu() for k, v in
                                           fin.items()})
    np.testing.assert_allclose(got[0].numpy(), last.numpy(), **SERVE_TOL)
    assert torch.equal(got[1], out)
    assert sorted(got[2]) == sorted(fin)
    for k, v in fin.items():
        np.testing.assert_allclose(got[2][k].float().numpy(),
                                   v.float().numpy(), **SERVE_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("arch", MODALITY)
def test_modality_loss_and_backward_on_card_match_cpu(arch):
    """``loss_fn`` + backward of a reduced float32 whisper / paligemma on
    the card and on the CPU: the loss and every gradient leaf (whisper's
    encoder included) within ``tests/test_serve.py``'s rule (atol times
    the leaf's scale)."""
    from repro_torch.models import lm
    dev, cfg, cpu, card, batch = _modality_case(arch)
    grads = []
    for model, where in ((card, dev), (cpu, torch.device("cpu"))):
        model.requires_grad_(True)
        loss, _ = lm.loss_fn(model, cfg, {k: torch.as_tensor(v, device=where)
                                          for k, v in batch.items()})
        loss.backward()
        grads.append((float(loss.detach()), {k: p.grad.cpu() for k, p in
                                             model.named_parameters()}))
    (lc, gc), (lw, gw) = grads
    np.testing.assert_allclose(lc, lw, **SERVE_TOL)
    assert sorted(gc) == sorted(gw)
    for k, w in gw.items():
        scale = max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(gc[k].numpy(), w.numpy(),
                                   rtol=SERVE_TOL["rtol"],
                                   atol=SERVE_TOL["atol"] * scale,
                                   err_msg=k)


@pytest.mark.parametrize("block", [True, False])
def test_checkpoint_round_trip_of_card_tensors(block, tmp_path):
    from repro_torch.checkpoint import checkpoint as ck
    dev = _cuda()
    gen = torch.Generator(dev).manual_seed(0)
    tree = {"w": torch.randn((64, 33), generator=gen, device=dev),
            "b": torch.randn(100, generator=gen, device=dev).to(
                torch.bfloat16),
            "opt": {"step": torch.tensor(7, dtype=torch.int32, device=dev),
                    "q": torch.arange(-5, 5, dtype=torch.int8, device=dev)}}
    want = {k: v.clone() for k, v in ck._flatten(tree).items()}
    th = ck.save(str(tmp_path), 9, tree, block=block)
    for t in ck._flatten(tree).values():   # in place at once: not torn
        t.zero_()
    if th is not None:
        th.join(timeout=60)
    back = ck.restore(str(tmp_path), 9, tree, shardings=dev)
    for k, v in ck._flatten(back).items():
        assert v.device == dev and v.dtype == want[k].dtype
        assert torch.equal(_bits(v), _bits(want[k])), k


# ------------------------------------------- vocab-sharded decode embedding
@pytest.mark.parametrize("data,model", [(1, 1), (1, 4), (2, 2), (1, 3)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_embed_lookup_psum_on_card_vs_plain(data, model, dtype,
                                            monkeypatch):
    """``embed_lookup_psum`` over a simulated ``data x model`` mesh on the
    card: one ``row_gather`` launch per distinct block of the table (a
    vocabulary of 1536 over 3 pieces too), ``torch.equal`` to the whole
    table's gather and bitwise to the same lookup on the plain row
    gather."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import ShardMesh
    from repro_torch.models import layers as L
    dev = _cuda()
    mesh = ShardMesh(devices=(dev,) * (data * model), data=data,
                     model=model, simulated=True)
    shd = sh.Shd(mesh, sh.default_rules(mesh))
    gen = torch.Generator(dev).manual_seed(7)
    table = torch.randn((1536, 256), generator=gen, device=dev).to(dtype)
    ids = torch.randint(0, 1536, (4, 3), generator=gen, device=dev,
                        dtype=torch.int32)
    before = RG.row_gather.launches
    got = L.embed_lookup_psum(table, ids, torch.float32, shd)
    torch.cuda.synchronize()
    assert RG.row_gather.launches - before == data * model
    assert torch.equal(got, L.embed_lookup(table, ids, torch.float32))
    monkeypatch.setattr(L, "row_gather", RG.row_gather_plain)
    plain = L.embed_lookup_psum(table, ids, torch.float32, shd)
    assert got.dtype == plain.dtype and torch.equal(
        got.view(torch.int32), plain.view(torch.int32))


def test_data_parallel_moe_step_on_card_matches_cpu():
    """One float32 data-parallel step of a reduced qwen3-moe (one dispatch
    group across the replicas) at 2 simulated shards on the card and on
    the CPU from the same weights and batch: loss and grad norm at
    ``rtol=1e-4``; the card's row gathers counted (6 a layer)."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_shard_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-moe-235b-a22b").reduced().replace(remat="full")
    model = lm.init_model(cfg, generator=torch.Generator().manual_seed(3),
                          device="cpu")
    batch = synth_batch(cfg, 4, 16, step=0)
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=5)
    got = {}
    for where in (dev, torch.device("cpu")):
        m = copy.deepcopy(model).to(where)
        m.axes = model.axes
        mesh = make_shard_mesh(2, device=where, simulate=True)
        shd = sh.Shd(mesh, sh.default_rules(mesh))
        dp = loop.DataParallel(m, shd)
        before = RG.row_gather.launches
        _, got[where.type] = loop.make_train_step(cfg, opt, shd=shd)(
            dp, adamw.init(dp.tree(), opt),
            {k: torch.as_tensor(v, device=where) for k, v in batch.items()})
        if where.type == "cuda":
            torch.cuda.synchronize()
            assert RG.row_gather.launches - before == 6 * cfg.num_layers
    for k in ("loss", "grad_norm", "lr", "moe_aux"):
        np.testing.assert_allclose(float(got["cuda"][k]),
                                   float(got["cpu"][k]), rtol=1e-4,
                                   err_msg=k)
