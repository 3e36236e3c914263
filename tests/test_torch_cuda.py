"""The CUDA stage-A kernels on the card, bitwise against their plain versions.

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
from repro_torch.kernels.unroll_spmv import kernel as K
from repro_torch.kernels.unroll_spmv import ops
from repro_torch.sparse import generators as G

pytestmark = pytest.mark.cuda

SEMIRINGS = [("add", np.float32), ("mul", np.float32), ("min", np.int32),
             ("max", np.int32)]


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stage-A kernels have no "
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
    return t.view(torch.int32)


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
