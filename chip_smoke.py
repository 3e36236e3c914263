#!/usr/bin/env python3
"""On-card smoke run of the ``repro_torch`` port: SpMV, SpMM and the graph
apps on the H100.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's main paths — ``SpMV.from_coo(..., backend="cuda")``
then ``.matvec(x)`` and ``.matvec_many(xs)``, and ``SpMM.from_coo(...,
backend="cuda")`` then ``.matmat(B)`` — on two SuiteSparse analogues at
their published sizes (``sparse/generators.py``), and the entry points of
the three standalone kernels at real sizes, and fails (non-zero exit, no
result line) if any phase fails:

1. device: CUDA present; prints the card's name and power limit on a line
   of their own, as ``nvidia-smi`` gives them;
2. build: compiles every kernel source of ``src/repro_torch`` with ``nvcc``
   for ``sm_90a`` into ``build/repro_torch`` (one ``nvcc`` per source, all
   at once) and prints the times and the compiler's register/spill report;
3. stage-A kernel phases: every window / dense-slice launch of both
   matrices, fused and per-class, coalesced and not, bitwise against the
   kernel's plain torch version on the card, for add and mul on float32
   and min and max on int32, at ``D`` 1 (``x`` a vector) and 16 (a dense
   ``(n, 16)`` operand: trailing lane axes);
4. main paths: ``matvec`` and ``matmat`` (``D = 16``) with ``fused=True``
   and ``coalesce`` False and True, against a float64 numpy ``np.add.at``
   oracle (max rel err <= 1e-5) and bitwise against the port's ``"torch"``
   backend; ``matvec_many`` on the pwtk analogue (``S = 8``) bitwise
   against 8 ``matvec`` calls; the launch counters, zeroed just before each
   run and read just after, must show every kernel the lowering names;
5. standalone kernels, each bitwise against its plain version on the card
   and each driven once through its entry point with the counters zeroed:
   ``segment_reduce_op`` on the pwtk plan's own blocks and combined terms
   (op_flag 7 and FULL_REDUCE; add/mul f32, min/max i32, add f64; ``D`` 1
   and 16), ``gather_vload_op`` on the webbase plan's window blocks (``ls``
   1, 2, 4 and 32, and stream; f32 and i32; ``D`` 1 and 16) and
   ``row_gather_op`` at the token dispatch of one qwen3-moe-235b-a22b layer
   (4,096 tokens of ``d_model`` 4,096 plus a zero row, top-8 of 128
   experts, so 32,768 row ids sorted by expert; bf16 and f32); the timed
   ``gather_vload`` cases (the fused section at ``D`` 1 and 16 in f32, and
   16 in bf16) are also held bitwise to their plain version and to
   ``torch.take``;
6. graph apps: ``BFS``, ``SSSP`` (the case's weights, uniform in 0.1-1.0),
   ``ConnectedComponents`` (on the symmetrized edges) and ``PageRank`` (20
   iterations, damping 0.85) through ``from_edges(..., backend="cuda",
   lane_width=128, fused=True)`` on the soc-Pokec analogue
   (``G.graph_case("powerlaw", 1632803, avg_deg=19)``, ~30.9M edges, not
   cut), each run with both drivers and held bitwise (state and
   ``ConvergenceReport``) to the ``"torch"`` backend on the same plan and
   to ``scipy.sparse.csgraph``: BFS levels equal to
   ``shortest_path(unweighted=True)``, SSSP within 1e-5 relative of
   float64 Dijkstra, CC's partition and min labels equal to
   ``connected_components``, PageRank within 1e-5 (max abs error over max
   rank) of a float64 power iteration; ``run_multi`` with 8 sources
   (``D = 8`` on the kernels) row for row bitwise ``run``; the stage-A
   counters, zeroed before each run, must grow on every ``"cuda"`` run.
   Per app it prints the plan build time, the fallback share of blocks, the
   sweeps, end-to-end ms with each driver, device ms per sweep, the idle
   share and the top kernels under ``torch.profiler``;
7. timings: ``matvec``, ``matvec_many`` and ``matmat`` end to end (host
   clock around the call and a synchronize, median of 20) and in device
   time (CUDA events around back-to-back calls queued behind a spin kernel,
   so launch overhead leaves no gaps; median of 5 such measurements); a
   ``torch.profiler`` breakdown of device time by kernel; each kernel's
   device time beside its bound (each distinct input word read once, each
   output word written once), its plain version's and, where one PyTorch
   call computes the same function, that call's time (``index_select`` for
   ``row_gather``, ``take`` for ``gather_vload``), and for ``row_gather``
   the time the card takes to write its output alone; and cuSPARSE's SpMV and
   SpMM (``torch.sparse_csr_tensor(...) @ x``) as end-to-end yardsticks;
   the ``"mul_all"`` dense-slice time at ``D = 16`` beside the number of
   its design before the ``"add_all"`` combine (``PERF.md``);
8. card tests: the ``cuda``-marked tests of ``tests/test_torch_cuda.py``
   (every kernel bitwise against its plain version at the edges of the
   ladder's shapes) in a child process.

The build phase prints, per kernel, the registers, stack and spilled bytes
of the compiler's report.  The line before the last is the kernels JSON
line; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
REL_ERR_LIMIT = 1e-5
CARD_TESTS_S = 900             # time limit of the card-test phase
SEMIRINGS = (("add", np.float32), ("mul", np.float32), ("min", np.int32),
             ("max", np.int32))
# the two SuiteSparse analogues of the paper's evaluation
MATRICES = {
    "pwtk": dict(kind="banded", n=217918, band=26),        # Boeing/pwtk
    "webbase-1M": dict(kind="power_law", n=1000005, avg_deg=3),
}
SPMM_D = 16                    # SpMM's dense operand is (n, SPMM_D)
MANY_S = 8                     # vectors of the matvec_many run
# segment_reduce cases on the pwtk blocks: (reduce, dtype)
SEGMENT_CASES = (("add", np.float32), ("mul", np.float32),
                 ("min", np.int32), ("max", np.int32), ("add", np.float64))
GATHER_LS = (1, 2, 4, 32)      # window counts of the gather_vload phase
# one MoE layer of src/repro/configs/qwen3_moe_235b_a22b.py
MOE = dict(tokens=4096, d_model=4096, num_experts=128, top_k=8, d_tile=512)
# the soc-Pokec analogue (SNAP soc-Pokec: 1,632,803 nodes, 30,622,564
# edges), named among the paper's graphs in sparse/generators.py
GRAPH = dict(kind="powerlaw", n=1632803, avg_deg=19)
GRAPH_S = 8                    # sources of the run_multi runs (D = 8)
PAGERANK_ITERS = 20
# the "mul_all" dense slice at D = 16 on pwtk before the kernels gained the
# "add_all" combine (PERF.md section 6; NVIDIA H100 80GB HBM3, 700.00 W)
PARENT_DENSE_D16_MS = 0.6030
SOURCES = {
    "unroll_spmv.window":
        "src/repro_torch/kernels/unroll_spmv/csrc/stage_a.cu",
    "unroll_spmv.dense_slice":
        "src/repro_torch/kernels/unroll_spmv/csrc/stage_a.cu",
    "segment_reduce":
        "src/repro_torch/kernels/segment_reduce/csrc/segment_reduce.cu",
    "gather_vload":
        "src/repro_torch/kernels/gather_vload/csrc/gather_vload.cu",
    "row_gather": "src/repro_torch/kernels/moe_dispatch/csrc/row_gather.cu",
}
REPLACES = {
    "unroll_spmv.window":
        "src/repro/kernels/unroll_spmv/kernel.py:135 (class_stage_a; "
        "gpu_stage_a :357)",
    "unroll_spmv.dense_slice":
        "src/repro/kernels/unroll_spmv/kernel.py:255 (coalesced_stage_a)",
    "segment_reduce":
        "src/repro/kernels/segment_reduce/kernel.py:52 (segment_reduce)",
    "gather_vload": "src/repro/kernels/gather_vload/kernel.py:37 "
                    "(gather_vload)",
    "row_gather": "src/repro/kernels/moe_dispatch/kernel.py:27 (row_gather)",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def host_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """End-to-end time of one call as a caller sees it: median over
    ``reps`` of the host clock around ``fn`` and a synchronize."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, reps: int = 20, repeats: int = 5,
              sleep_cycles: int = 200_000_000) -> float:
    """Device time of one call, the median of ``repeats`` measurements:
    each puts CUDA events around ``reps`` back-to-back calls, enqueued
    behind a spin kernel so the host's launch overhead never leaves the
    card idle between them.  The launch queue holds about a thousand
    kernels and blocks the host when full, so a call of many small kernels
    is measured again with fewer repeats until the whole batch fits behind
    the spin."""
    import torch
    fn()
    torch.cuda.synchronize()
    samples = []
    while len(samples) < repeats:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        covered = not start.query()
        end.synchronize()
        if not covered and reps > 1:
            reps = max(1, reps // 4)
            continue
        if not covered:
            log("[time] note: the host could not keep ahead of the card; "
                "this device time includes launch gaps")
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def profile_breakdown(fn, reps: int = 5):
    """Device time per call under ``torch.profiler``: (wall ms, device-busy
    ms, top kernels as (name, ms, launches)) per call, or None when the
    profiler records no device activity.  Wall time includes the
    profiler's own overhead, so the idle share it implies is an upper
    bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    if busy_ms <= 0:
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return wall_ms, busy_ms, [(e.key[:70], e.self_device_time_total / 1e3
                               / reps, e.count // reps) for e in top]


def log_profile(tag: str, what: str, fn) -> None:
    prof = profile_breakdown(fn)
    if prof is None:
        log(f"[profile] {tag} {what}: no device time recorded (not "
            "measured)")
        return
    wall_ms, busy_ms, top = prof
    log(f"[profile] {tag} {what}: device busy {busy_ms:.4f} ms of "
        f"{wall_ms:.4f} ms wall per call under the profiler (idle share <= "
        f"{1 - busy_ms / wall_ms:.3f})")
    for kname, kms, kcount in top:
        log(f"[profile]   {kms:.4f} ms in {kcount} launches: {kname}")


def make_matrix(G, spec):
    if spec["kind"] == "banded":
        return G.banded(spec["n"], band=spec["band"])
    return G.power_law(spec["n"], avg_deg=spec["avg_deg"])


def data_for(m, dtype, d: int | None = None, seed=SEED):
    """Values (nnz,) and a dense operand, (n,) or (n, d), from a seed."""
    rng = np.random.default_rng(seed)
    shape = (m.shape[1],) if d is None else (m.shape[1], d)
    if np.issubdtype(np.dtype(dtype), np.integer):
        return (rng.integers(-5, 6, m.nnz).astype(dtype),
                rng.integers(-5, 6, shape).astype(dtype))
    return (rng.standard_normal(m.nnz).astype(dtype),
            rng.standard_normal(shape).astype(dtype))


def add_at_oracle(m, vals, x) -> np.ndarray:
    """float64 ``np.add.at`` product, one column at a time."""
    v = vals.astype(np.float64)
    x2 = x.reshape(x.shape[0], -1).astype(np.float64)
    out = np.zeros((m.shape[0], x2.shape[1]), np.float64)
    for c in range(x2.shape[1]):
        np.add.at(out[:, c], m.rows, v * x2[m.cols, c])
    return out.reshape((m.shape[0],) + x.shape[1:])


def same_bits(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return torch.equal(a.view(view[a.element_size()]),
                       b.view(view[b.element_size()]))


def max_abs_diff(a, b) -> float:
    """0.0 exactly when the two agree bit for bit; else the max abs
    difference of the finite words, ``inf`` when only non-finite words
    differ."""
    if same_bits(a, b):
        return 0.0
    diff = (a.double() - b.double()).abs()
    diff = diff[~diff.isnan()]
    return float(diff.max()) if diff.numel() and diff.max() > 0 \
        else float("inf")


def ptxas_report(build_log: str) -> list[tuple[str, int, int, int]]:
    """(kernel, registers, stack bytes, spill store + load bytes) per
    kernel of an ``nvcc -Xptxas -v`` log; the ladder kernels' mangled names
    are shortened to body, type, reduce, lanes per thread and index, the
    row copy's to word size and index policy."""
    out, name, stack, spill = [], "?", 0, 0
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            short = re.search(r"(rows|cols)_kernelI([fid])Li(\d)ELi(\d+)E"
                              r"\w*?((?:Dense|Window|Rows)Index)", name)
            copy = re.search(r"copy_rows_kernelI(h|t|j|5uint2|5uint4)"
                             r"\w*?(IdRows|WindowLanes)", name)
            if short:
                body, ty, red, lanes, index = short.groups()
                red = ("add", "mul", "max", "min")[int(red)]
                name = f"{body}_kernel<{ty}, {red}, L={lanes}, {index}>"
            elif copy:
                word, rows = copy.groups()
                word = {"h": "1 B", "t": "2 B", "j": "4 B", "5uint2": "8 B",
                        "5uint4": "16 B"}[word]
                name = f"copy_rows_kernel<{word} words, {rows}>"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            stack, spill = int(m.group(1)), int(m.group(2)) + int(m.group(3))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((name, int(m.group(1)), stack, spill))
            stack = spill = 0
    return out


def bound(nbytes: float, nops: float = 0.0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def launch_bytes_ops(cm, d: int = 1) -> tuple[int, int]:
    """Least bytes a stage-A launch must move and the operations it must
    do, from this launch's metadata, for a gathered operand of ``d``
    columns: each distinct input word read once, each output word written
    once (see the kernel source's header).  Of ``x`` that is the distinct
    rows the launch's lanes read, however many lanes share one; of the
    window ids, those some lane of the block selects."""
    import torch
    from repro_torch.core import ir
    la = cm.launch
    bc, n = cm.seg.shape
    lanes = bc * n
    lane = torch.arange(n, device=cm.seg.device)
    if la.gather == ir.COALESCED:
        local = cm.local is not None
        idx = cm.starts.long()[:, None] + (cm.local.long() if local else lane)
        per_lane = 3 if local else 2             # (local_off,) seg, value
        head = bc * 4                            # starts
    elif la.stream:
        idx = cm.win[:, :1].long() * n + lane
        per_lane = 2                             # seg, value
        head = bc * 4                            # window 0's id
    else:
        slot = cm.slot.long()
        idx = torch.gather(cm.win.long(), 1, slot) * n + cm.off.long()
        per_lane = 4                             # slot, off, seg, value
        used = torch.zeros(cm.win.shape, dtype=torch.bool,
                           device=cm.win.device).scatter_(1, slot, True)
        head = int(used.sum()) * 4               # the window ids selected
    if cm.full is not None:
        head += bc * 4
    x_rows = int(torch.unique(idx).numel())
    steps = max(la.op_flag, 0)
    if la.op_flag < 0 or cm.full is not None:
        steps = max(steps, int(np.ceil(np.log2(max(n, 2)))))
    ops = lanes * d * (1 + steps)             # combine + ladder steps
    return (head + lanes * per_lane * 4 + lanes * d * 4 + x_rows * d * 4,
            ops)


def run_launch_both(K, ir, cm, xd, elem, reduce):
    """One launch through its kernel and its plain version on the card;
    returns the kernel's name and both outputs."""
    la = cm.launch
    s = slice(la.start, la.stop)
    kw = dict(op=la.op_flag, reduce=reduce, full_flags=cm.full)
    if la.gather == ir.COALESCED:
        key = "unroll_spmv.dense_slice"
        args = (cm.starts, [xd], [elem[s]], cm.local, cm.seg)
        return key, K.dense_slice_stage_a(*args, **kw), \
            K.dense_slice_stage_a_plain(*args, **kw)
    key = "unroll_spmv.window"
    args = (cm.win, [xd], [elem[s]], cm.slot, cm.off, cm.seg)
    kw["stream"] = la.stream
    return key, K.window_stage_a(*args, **kw), \
        K.window_stage_a_plain(*args, **kw)


class Smoke:
    """The phases, in order; ``run`` drives them all."""

    def __init__(self, dev, card: str, kind: str):
        import torch
        from repro_torch.core import engine as eng
        from repro_torch.core import graphs, ir
        from repro_torch.core.apps import PageRank, SpMV
        from repro_torch.core.plan import CostModel, build_plan
        from repro_torch.core.seed import spmv_seed
        from repro_torch.core.spmm import SpMM
        from repro_torch.kernels import build
        from repro_torch.kernels.gather_vload import kernel as GV
        from repro_torch.kernels.gather_vload import ops as gv_ops
        from repro_torch.kernels.moe_dispatch import kernel as RG
        from repro_torch.kernels.moe_dispatch import ops as rg_ops
        from repro_torch.kernels.segment_reduce import kernel as SR
        from repro_torch.kernels.segment_reduce import ops as sr_ops
        from repro_torch.kernels.unroll_spmv import kernel as K
        from repro_torch.kernels.unroll_spmv import ops
        from repro_torch.sparse import generators as G
        self.torch, self.eng, self.ir, self.ops, self.G = torch, eng, ir, ops, G
        self.SpMV, self.SpMM = SpMV, SpMM
        self.graphs, self.PageRank = graphs, PageRank
        self.CostModel, self.build_plan, self.spmv_seed = \
            CostModel, build_plan, spmv_seed
        self.build, self.K, self.SR, self.GV, self.RG = build, K, SR, GV, RG
        self.sr_op = sr_ops.segment_reduce_op
        self.gv_op = gv_ops.gather_vload_op
        self.rg_op = rg_ops.row_gather_op
        self.dev, self.card, self.kind = dev, card, kind
        self.tag = f"[{card}]"
        # each kernel's launch counter, by the name the kernels line uses
        self.wrappers = {
            "unroll_spmv.window": K.window_stage_a,
            "unroll_spmv.dense_slice": K.dense_slice_stage_a,
            "segment_reduce": SR.segment_reduce,
            "gather_vload": GV.gather_vload,
            "row_gather": RG.row_gather}
        self.main_counts = {k: 0 for k in self.wrappers}
        self.max_err = {k: 0.0 for k in self.wrappers}
        self.compared = {k: 0 for k in self.wrappers}
        self.line = {}
        self.mats, self.plans = {}, {}

    # ------------------------------------------------------------ helpers
    def zero_counts(self) -> None:
        for fn in self.wrappers.values():
            fn.launches = 0

    def read_counts(self) -> dict:
        self.torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in self.wrappers.items()}
        for k, c in counts.items():
            self.main_counts[k] += c
        return counts

    def held(self, key: str, got, want, what: str) -> None:
        """Record one kernel-vs-plain comparison; fail unless bitwise."""
        self.torch.cuda.synchronize()
        err = max_abs_diff(got, want)
        self.max_err[key] = max(self.max_err[key], err)
        self.compared[key] += 1
        check(err == 0.0, f"{key} differs from its plain version ({what}; "
              f"max abs err {err})")

    def kernel_entry(self, key, ms, plain_ms, nbytes, nops, library_ms):
        bound_ms, by = bound(nbytes, nops)
        self.line[key] = {
            "name": key, "route": "cuda", "source": SOURCES[key],
            "replaces": REPLACES[key], "launches": self.main_counts[key],
            "max_abs_err": self.max_err[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms}

    # ------------------------------------------------------------- phases
    def build_kernels(self) -> None:
        libs = {"unroll_spmv": self.K.library,
                "segment_reduce": self.SR.library,
                "gather_vload": self.GV.library,
                "row_gather": self.RG.library}
        t0 = time.perf_counter()
        self.build.build_all(libs.values())
        log(f"[build] {len(libs)} kernel libraries ready in "
            f"{time.perf_counter() - t0:.2f} s (one nvcc each, in parallel)")
        for name, lib in libs.items():
            kernels = ptxas_report(lib.build_log)
            regs = [k[1] for k in kernels] or [0]
            log(f"[build] {name}: nvcc {lib.build_seconds:.2f} s, "
                f"{len(kernels)} kernels, {min(regs)}-{max(regs)} registers, "
                f"{sum(k[3] > 0 for k in kernels)} with spills")
            for kname, nregs, stack, spill in kernels:
                log(f"[build]   {kname}: {nregs} registers, {stack} B stack, "
                    f"{spill} B spilled")

    def make_plans(self) -> None:
        for name, spec in MATRICES.items():
            t0 = time.perf_counter()
            m = self.mats[name] = make_matrix(self.G, spec)
            t1 = time.perf_counter()
            p = self.plans[name] = self.build_plan(
                self.spmv_seed(), {"row": m.rows, "col": m.cols},
                m.shape[0], m.shape[1], self.CostModel(lane_width=128))
            fb = sum(c.num_blocks for c in p.classes if c.ls_flag == 0)
            log(f"[matrix] {name}: {m.shape[0]} rows, {m.nnz} nnz, "
                f"{p.num_blocks} blocks ({fb} gather-fallback, "
                f"{fb / p.num_blocks:.4f}), {p.stats.num_classes} classes; "
                f"generate {t1 - t0:.2f} s, build_plan "
                f"{time.perf_counter() - t1:.2f} s")
            for fused in (True, False):
                t = self.ir.lower(p, backend="cuda", fused=fused,
                                  coalesce=True)
                log(f"[matrix] {name}: cuda fused={fused} coalesce=True -> "
                    f"{len(t.launches)} launches, coalesced fraction "
                    f"{self.ir.coalesced_fraction(t):.4f}; torch form "
                    f"{self.ir.coalesce_stats(p, fused=fused)}")

    def kernel_launches(self, plan, fused, coalesce):
        tree = self.ir.lower(plan, backend="cuda", fused=fused,
                             coalesce=coalesce)
        return [cm for cm in self.ops.stage_launch_meta(plan, tree.launches,
                                                        self.dev)
                if cm.launch.gather != self.ir.FALLBACK]

    def stage_a_phase(self) -> None:
        """Every kernel launch of both matrices against its plain version,
        at D = 1 and D = SPMM_D."""
        torch = self.torch
        for name, plan in self.plans.items():
            lowerings = {(f, c): self.kernel_launches(plan, f, c)
                         for f in (True, False) for c in (False, True)}
            for d in (1, SPMM_D):
                for reduce, dtype in SEMIRINGS:
                    vals, x = data_for(self.mats[name], dtype,
                                       None if d == 1 else d)
                    xd = torch.as_tensor(x, device=self.dev)
                    elem = self.eng.reorder_elementwise(
                        plan, vals, reduce=reduce, device=self.dev)
                    for (fused, coalesce), metas in lowerings.items():
                        for cm in metas:
                            key, got, want = run_launch_both(
                                self.K, self.ir, cm, xd, elem, reduce)
                            self.held(key, got, want, f"{name} D={d} fused="
                                      f"{fused} coalesce={coalesce} {reduce}/"
                                      f"{np.dtype(dtype).name} launch "
                                      f"[{cm.launch.start}, {cm.launch.stop})"
                                      f" op={cm.launch.op_flag}")
                        log(f"[kernels] {name} D={d} fused={fused} "
                            f"coalesce={coalesce} {reduce}/"
                            f"{np.dtype(dtype).name}: {len(metas)} kernel "
                            "launches bitwise equal to the plain versions")

    def check_named(self, app, counts, what) -> None:
        """Each stage-A kernel the lowering names was launched."""
        ir = self.ir
        named = {"unroll_spmv.dense_slice" if la.gather == ir.COALESCED
                 else "unroll_spmv.window"
                 for la in app._run.tree.launches if la.gather != ir.FALLBACK}
        for k in named:
            check(counts[k] > 0, f"{k} named by the lowering of {what} but "
                  "never launched")

    def product_run(self, name, coalesce, d):
        """One main-path run: ``matvec`` (d None) or ``matmat`` (d columns),
        held to the float64 oracle and bitwise to the torch backend."""
        torch = self.torch
        m = self.mats[name]
        vals, x = data_for(m, np.float32, d)
        xd = torch.as_tensor(x, device=self.dev)
        oracle = add_at_oracle(m, vals, x)
        t0 = time.perf_counter()
        if d is None:
            app = self.SpMV.from_coo(m.rows, m.cols, vals, m.shape,
                                     backend="cuda", fused=True,
                                     coalesce=coalesce, device=self.dev)
            call = app.matvec
        else:
            app = self.SpMM.from_coo(m.rows, m.cols, vals, m.shape,
                                     backend="cuda", fused=True,
                                     coalesce=coalesce, device=self.dev)
            call = app.matmat
        build_s = time.perf_counter() - t0
        what = f"{name} coalesce={coalesce} " + \
            ("matvec" if d is None else f"matmat D={d}")
        self.zero_counts()
        y = call(xd)
        counts = self.read_counts()
        self.check_named(app, counts, what)
        check(tuple(y.shape) == oracle.shape and y.dtype == torch.float32,
              f"{what}: bad output {tuple(y.shape)} {y.dtype}")
        yh = y.cpu().numpy()
        check(bool(np.isfinite(yh).all()), f"{what}: non-finite output")
        rel = float(np.abs(yh - oracle).max() / np.abs(oracle).max())
        check(rel <= REL_ERR_LIMIT, f"{what}: rel err {rel:.3e} vs the "
              "float64 oracle")
        torch_run = self.eng.make_executor(
            app.plan, {"value": vals}, backend="torch", fused=True,
            coalesce=coalesce, device=self.dev)
        y_torch = torch_run({"x": xd}, torch.zeros_like(y))
        check(same_bits(y, y_torch), f"{what}: cuda backend differs from "
              "the torch backend")
        log(f"[main] {what} fused=True: {len(app._run.tree.launches)} "
            f"launches, kernel launches "
            f"{ {k: c for k, c in counts.items() if c} }, max rel err vs "
            f"float64 oracle {rel:.3e}, bitwise equal to the torch backend; "
            f"from_coo {build_s:.2f} s")
        return dict(matrix=name, coalesce=coalesce, d=d, app=app, call=call,
                    x=xd, vals=vals, counts=counts, rel_err=rel,
                    torch_run=torch_run, build_s=build_s)

    def main_paths(self) -> None:
        self.runs = [self.product_run(name, coalesce, d)
                     for d in (None, SPMM_D) for name in self.mats
                     for coalesce in (False, True)]
        for r in self.runs:
            if r["matrix"] == "webbase-1M" and not r["coalesce"]:
                check(r["counts"]["unroll_spmv.window"] > 0,
                      "window kernel not launched on webbase-1M "
                      "coalesce=False")
            if r["matrix"] == "pwtk" and r["coalesce"]:
                check(r["counts"]["unroll_spmv.dense_slice"] > 0,
                      "dense-slice kernel not launched on pwtk coalesce=True")

    def matvec_many_phase(self) -> None:
        torch = self.torch
        run = self.run_of("pwtk", True, None)
        app = run["app"]
        xs = torch.as_tensor(np.random.default_rng(SEED + 1).standard_normal(
            (MANY_S, app.shape[1])).astype(np.float32), device=self.dev)
        self.zero_counts()
        ys = app.matvec_many(xs)
        counts = self.read_counts()
        self.check_named(app, counts, "pwtk matvec_many")
        check(tuple(ys.shape) == (MANY_S, app.shape[0]),
              f"matvec_many: bad output {tuple(ys.shape)}")
        for i in range(MANY_S):
            check(same_bits(ys[i], app.matvec(xs[i])),
                  f"matvec_many row {i} differs from matvec(xs[{i}])")
        many_ms = host_ms(lambda: app.matvec_many(xs))
        many_dev = device_ms(lambda: app.matvec_many(xs))
        loop_ms = host_ms(lambda: [app.matvec(xs[i]) for i in range(MANY_S)])
        log(f"[main] pwtk coalesce=True matvec_many S={MANY_S}: kernel "
            f"launches {counts['unroll_spmv.dense_slice']} dense-slice, "
            f"rows bitwise equal to {MANY_S} matvec calls")
        log(f"[time] {self.tag} pwtk coalesce=True matvec_many S={MANY_S}: "
            f"{many_ms:.4f} ms end to end, {many_dev:.4f} ms of device time; "
            f"{MANY_S} separate matvec calls {loop_ms:.4f} ms end to end")

    def run_of(self, name, coalesce, d):
        return next(r for r in self.runs if r["matrix"] == name
                    and r["coalesce"] == coalesce and r["d"] == d)

    def main_timings(self) -> None:
        torch = self.torch
        for r in self.runs:
            app, xd, call = r["app"], r["x"], r["call"]
            what = f"{r['matrix']} coalesce={r['coalesce']} " + \
                ("matvec" if r["d"] is None else f"matmat D={r['d']}")
            y0 = torch.zeros((app.shape[0],) + tuple(xd.shape[1:]),
                             device=self.dev)
            stage_a = app._run.sweep_body.stage_a
            r["ms"] = host_ms(lambda: call(xd))
            r["dev_ms"] = device_ms(lambda: call(xd))
            r["stage_a_dev_ms"] = device_ms(lambda: stage_a({"x": xd}))
            r["torch_ms"] = host_ms(lambda: r["torch_run"]({"x": xd}, y0))
            log(f"[time] {self.tag} {what}: cuda {r['ms']:.4f} ms end to "
                f"end, {r['dev_ms']:.4f} ms of device time (stage A "
                f"{r['stage_a_dev_ms']:.4f} ms); torch backend "
                f"{r['torch_ms']:.4f} ms end to end")
            log_profile(self.tag, what, lambda: call(xd))
        for name, m in self.mats.items():
            indptr = np.r_[0, np.cumsum(np.bincount(m.rows,
                                                    minlength=m.shape[0]))]
            for d in (None, SPMM_D):
                vals, x = data_for(m, np.float32, d)
                a_csr = torch.sparse_csr_tensor(
                    torch.as_tensor(indptr, device=self.dev),
                    torch.as_tensor(m.cols, device=self.dev),
                    torch.as_tensor(vals, device=self.dev), size=m.shape)
                xd = torch.as_tensor(x, device=self.dev)
                y_lib = (a_csr @ xd).cpu().numpy()
                y_ref = self.run_of(name, False, d)["call"](xd).cpu().numpy()
                check(np.allclose(y_lib, y_ref, rtol=1e-4, atol=1e-4),
                      f"cuSPARSE disagrees with the port on {name} D={d}")
                lib_dev = device_ms(lambda: a_csr @ xd)
                lib_host = host_ms(lambda: a_csr @ xd)
                what = "SpMV" if d is None else f"SpMM D={d}"
                log(f"[time] {self.tag} {name}: cuSPARSE {what} "
                    f"(torch.sparse_csr_tensor @ x, the yardstick) "
                    f"{lib_dev:.4f} ms of device time, {lib_host:.4f} ms end "
                    "to end")

    def stage_a_kernel_times(self, key, name, coalesce, d):
        """The kernel's launches of one main-path call, timed as a sequence,
        beside the plain versions and the bound."""
        torch, K, ir = self.torch, self.K, self.ir
        run = self.run_of(name, coalesce, d)
        app, xd = run["app"], run["x"]
        plan = app.plan
        elem = self.eng.reorder_elementwise(plan, run["vals"],
                                            device=self.dev)
        metas = [cm for cm in app._run.sweep_body.stage_a.launch_meta
                 if cm.launch.gather != ir.FALLBACK
                 and (cm.launch.gather == ir.COALESCED)
                 == (key == "unroll_spmv.dense_slice")]
        lanes = torch.empty((plan.num_blocks, plan.lane_width)
                            + tuple(xd.shape[1:]), device=self.dev)

        def run_all(plain=False):
            for cm in metas:
                s = slice(cm.launch.start, cm.launch.stop)
                if not plain:
                    self.ops.run_launch(plan, cm, [xd], [elem[s]],
                                        out=lanes[s])
                elif cm.launch.gather == ir.COALESCED:
                    lanes[s] = K.dense_slice_stage_a_plain(
                        cm.starts, [xd], [elem[s]], cm.local, cm.seg,
                        op=cm.launch.op_flag, reduce="add",
                        full_flags=cm.full)
                else:
                    lanes[s] = K.window_stage_a_plain(
                        cm.win, [xd], [elem[s]], cm.slot, cm.off, cm.seg,
                        op=cm.launch.op_flag, stream=cm.launch.stream,
                        reduce="add", full_flags=cm.full)

        ms = device_ms(run_all)
        plain_ms = device_ms(lambda: run_all(plain=True), reps=3)
        nbytes = nops = 0
        for cm in metas:
            b, o = launch_bytes_ops(cm, 1 if d is None else d)
            nbytes += b
            nops += o
        return dict(ms=ms, plain_ms=plain_ms, nbytes=nbytes, nops=nops,
                    launches=len(metas), main=run["counts"][key])

    def stage_a_timings(self) -> None:
        representative = {"unroll_spmv.window": ("webbase-1M", False),
                          "unroll_spmv.dense_slice": ("pwtk", True)}
        for key, (name, coalesce) in representative.items():
            for d in (None, SPMM_D):
                t = self.stage_a_kernel_times(key, name, coalesce, d)
                bound_ms, by = bound(t["nbytes"], t["nops"])
                what = "matvec" if d is None else f"matmat D={d}"
                log(f"[time] {self.tag} {key} on {name} coalesce={coalesce} "
                    f"{what}: {t['launches']} launches/call (main-path "
                    f"counter {t['main']}), {t['ms']:.4f} ms vs bound "
                    f"{bound_ms:.4f} ms ({t['nbytes']} B at "
                    f"{HBM_BYTES_PER_S:.3g} B/s; {t['nops']} ops), "
                    f"{bound_ms / t['ms']:.3f} of the bound; plain version "
                    f"{t['plain_ms']:.4f} ms; no single PyTorch call "
                    "computes it")
                if key == "unroll_spmv.dense_slice" and d == SPMM_D:
                    log(f"[time] {self.tag} {key} \"mul_all\" D={d}: "
                        f"{t['ms']:.4f} ms with the \"add_all\" form in the "
                        f"kernel, {PARENT_DENSE_D16_MS:.4f} ms before it "
                        "(PERF.md, an earlier call)")
                if d is None:           # the kernels line keeps matvec's
                    self.kernel_entry(key, t["ms"], t["plain_ms"],
                                      t["nbytes"], t["nops"], None)

    def segment_reduce_phase(self) -> None:
        torch, SR = self.torch, self.SR
        m, plan = self.mats["pwtk"], self.plans["pwtk"]
        seg = torch.as_tensor(plan.seg_ids, device=self.dev)
        gidx = torch.as_tensor(plan.gather_idx, device=self.dev).long()
        b, n = seg.shape
        main = None
        for reduce, dtype in SEGMENT_CASES:
            for d in (1, SPMM_D):
                vals, x = data_for(m, dtype, None if d == 1 else d)
                elem = self.eng.reorder_elementwise(plan, vals, reduce=reduce,
                                                    device=self.dev)
                xg = torch.as_tensor(x, device=self.dev)[gidx]
                term = elem * xg if d == 1 else elem[..., None] * xg
                for op in (7, -1):
                    got = SR.segment_reduce(term, seg, op, reduce)
                    want = SR.segment_reduce_plain(term, seg, op, reduce)
                    self.held("segment_reduce", got, want,
                              f"pwtk blocks D={d} op={op} {reduce}/"
                              f"{np.dtype(dtype).name}")
                log(f"[kernels] segment_reduce pwtk blocks ({b} x {n}) D={d} "
                    f"{reduce}/{np.dtype(dtype).name}: op_flag 7 and "
                    "FULL_REDUCE bitwise equal to the plain version")
                if (reduce, dtype) == ("add", np.float32):
                    timing = self.segment_reduce_time(term, seg)
                    if d == SPMM_D:
                        main = term
                del term, xg, elem
        self.zero_counts()
        out = self.sr_op(main, seg, 7, "add")
        counts = self.read_counts()
        check(counts["segment_reduce"] == 1 and out.shape == main.shape,
              f"segment_reduce_op launched {counts['segment_reduce']} "
              "kernels, expected 1")
        self.kernel_entry("segment_reduce", *timing, None)   # D = 16's

    def segment_reduce_time(self, term, seg):
        SR = self.SR
        ms = device_ms(lambda: SR.segment_reduce(term, seg, 7, "add"))
        plain_ms = device_ms(
            lambda: SR.segment_reduce_plain(term, seg, 7, "add"), reps=3)
        es = term.element_size()
        nbytes = 2 * term.numel() * es + seg.numel() * 4
        nops = term.numel() * 7
        bound_ms, by = bound(nbytes, nops)
        log(f"[time] {self.tag} segment_reduce pwtk blocks "
            f"{tuple(term.shape)} float32 add op_flag 7: {ms:.4f} ms vs "
            f"bound {bound_ms:.4f} ms ({nbytes} B; {nops} ops), "
            f"{bound_ms / ms:.3f} of the bound; plain version "
            f"{plain_ms:.4f} ms; no single PyTorch call computes it")
        return ms, plain_ms, nbytes, nops

    def gather_cases(self):
        """(metadata, ls, stream) of the webbase plan's window blocks: its
        launches of ls 1, 2, 4 and 32 per class and fused (the fused section
        runs at the section-wide ls 32), and the ls-1 launches once more in
        stream mode (window 0 copied); and the fused section's metadata."""
        ir, plan = self.ir, self.plans["webbase-1M"]
        cases, section = [], None
        for fused in (False, True):
            for cm in self.kernel_launches(plan, fused, False):
                la = cm.launch
                if la.gather == ir.COALESCED or la.ls_flag not in GATHER_LS:
                    continue
                cases.append((cm, la.ls_flag, la.stream))
                if la.ls_flag == 1 and not la.stream:
                    cases.append((cm, 1, True))
                if fused and (section is None or cm.seg.shape[0]
                              > section.seg.shape[0]):
                    section = cm
        return cases, section

    def gather_vload_phase(self) -> None:
        torch, GV, ir = self.torch, self.GV, self.ir
        m, plan = self.mats["webbase-1M"], self.plans["webbase-1M"]
        n = plan.lane_width
        cases, cm = self.gather_cases()
        seen = {(ls, stream) for _, ls, stream in cases}
        for ls in GATHER_LS:
            check((ls, False) in seen, f"no webbase window launch of ls {ls}")
        check((1, True) in seen, "no stream gather_vload case")
        views = {}
        for dtype in (np.float32, np.int32):
            for d in (1, SPMM_D):
                _, x = data_for(m, dtype, None if d == 1 else d)
                xd = torch.as_tensor(x, device=self.dev)
                view = self.eng._pad_gathered(plan, xd).contiguous()
                views[dtype, d] = view
                for cm, ls, stream in cases:
                    got = GV.gather_vload(view, cm.win, cm.slot, cm.off,
                                          ls=ls, stream=stream)
                    want = GV.gather_vload_plain(view, cm.win, cm.slot,
                                                 cm.off, ls=ls, stream=stream)
                    self.held("gather_vload", got, want,
                              f"webbase blocks ls={ls} stream={stream} D={d} "
                              f"{np.dtype(dtype).name}")
                log(f"[kernels] gather_vload webbase window blocks D={d} "
                    f"{np.dtype(dtype).name}: {len(cases)} launches (ls "
                    f"{sorted({c[1] for c in cases})}, stream) bitwise equal "
                    "to the plain version")
        # the entry point on the fused section (ls 32), float32, D = 1
        check(cm is not None and cm.launch.ls_flag == max(GATHER_LS),
              "no fused webbase window section of ls 32")
        ls = max(GATHER_LS)
        views[torch.bfloat16, SPMM_D] = \
            views[np.float32, SPMM_D].to(torch.bfloat16)
        for dtype, d in ((np.float32, 1), (np.float32, SPMM_D),
                         (torch.bfloat16, SPMM_D)):
            view = views[dtype, d]
            if d == 1:
                self.zero_counts()
                out = self.gv_op(view, cm.win, cm.slot, cm.off, ls)
                counts = self.read_counts()
                check(counts["gather_vload"] == 1
                      and out.shape == cm.slot.shape,
                      f"gather_vload_op launched {counts['gather_vload']} "
                      "kernels, expected 1")
            else:
                self.held("gather_vload", GV.gather_vload(
                    view, cm.win, cm.slot, cm.off, ls=ls),
                    GV.gather_vload_plain(view, cm.win, cm.slot, cm.off,
                                          ls=ls),
                    f"webbase fused section D={d} {view.dtype}")
            rows = (torch.gather(cm.win.long(), 1, cm.slot.long()) * n
                    + cm.off.long())
            flat = view.reshape((-1,) + tuple(view.shape[2:]))
            if d == 1:
                lib = lambda: torch.take(flat, rows)      # noqa: E731
            else:
                elems = (rows[..., None] * d
                         + torch.arange(d, device=self.dev))
                lib = lambda: torch.take(flat, elems)     # noqa: E731
            check(same_bits(lib(), GV.gather_vload(view, cm.win, cm.slot,
                                                   cm.off, ls=ls)),
                  "torch.take disagrees with gather_vload")
            ms = device_ms(lambda: GV.gather_vload(view, cm.win, cm.slot,
                                                   cm.off, ls=ls))
            plain_ms = device_ms(lambda: GV.gather_vload_plain(
                view, cm.win, cm.slot, cm.off, ls=ls), reps=3)
            lib_ms = device_ms(lib)
            used = torch.zeros(cm.win.shape, dtype=torch.bool,
                               device=self.dev).scatter_(1, cm.slot.long(),
                                                         True)
            lanes, es = cm.slot.numel(), view.element_size()
            nbytes = (int(used.sum()) * 4 + lanes * 8
                      + int(torch.unique(rows).numel()) * d * es
                      + lanes * d * es)
            bound_ms, _ = bound(nbytes)
            log(f"[time] {self.tag} gather_vload webbase fused section "
                f"({cm.slot.shape[0]} blocks, ls {ls}) {view.dtype} D={d}: "
                f"{ms:.4f} ms vs bound {bound_ms:.4f} ms ({nbytes} B), "
                f"{bound_ms / ms:.3f} of the bound; plain version "
                f"{plain_ms:.4f} ms; torch.take on the flat view "
                f"(yardstick) {lib_ms:.4f} ms")
            if d == 1:
                self.kernel_entry("gather_vload", ms, plain_ms, nbytes, 0.0,
                                  lib_ms)

    def moe_row_ids(self) -> np.ndarray:
        """Token ids of one MoE layer's dispatch, sorted by expert as
        ``models/moe.py`` sorts them: top-k of random router logits."""
        rng = np.random.default_rng(SEED)
        t, e, k = MOE["tokens"], MOE["num_experts"], MOE["top_k"]
        logits = rng.standard_normal((t, e)).astype(np.float32)
        eidx = np.argsort(-logits, axis=1, kind="stable")[:, :k]
        order = np.argsort(eidx.reshape(-1), kind="stable")
        return ((np.arange(t * k) // k)[order]).astype(np.int32)

    def row_gather_phase(self) -> None:
        torch, RG = self.torch, self.RG
        t, dm, dtile = MOE["tokens"], MOE["d_model"], MOE["d_tile"]
        ids = torch.as_tensor(self.moe_row_ids(), device=self.dev)
        rng = np.random.default_rng(SEED + 2)
        x = torch.as_tensor(rng.standard_normal((t, dm)).astype(np.float32),
                            device=self.dev)
        srcs = {}
        for dtype in (torch.bfloat16, torch.float32):
            src = torch.cat([x.to(dtype), torch.zeros((1, dm), dtype=dtype,
                                                      device=self.dev)])
            srcs[dtype] = src
            got = RG.row_gather(src, ids, d_tile=dtile)
            self.held("row_gather", got, RG.row_gather_plain(src, ids),
                      f"qwen3-moe dispatch {dtype}")
            log(f"[kernels] row_gather qwen3-moe-235b-a22b dispatch "
                f"({ids.numel()} rows of {dm}, {dtype}): bitwise equal to the "
                "plain version")
        self.zero_counts()
        out = self.rg_op(srcs[torch.bfloat16], ids, dtile)
        counts = self.read_counts()
        check(counts["row_gather"] == 1 and out.shape == (ids.numel(), dm),
              f"row_gather_op launched {counts['row_gather']} kernels, "
              "expected 1")
        distinct = int(torch.unique(ids).numel())
        for dtype, src in srcs.items():
            ms = device_ms(lambda: RG.row_gather(src, ids, d_tile=dtile))
            plain_ms = device_ms(lambda: RG.row_gather_plain(src, ids))
            lib_ms = device_ms(lambda: torch.index_select(src, 0, ids))
            check(same_bits(torch.index_select(src, 0, ids),
                            RG.row_gather(src, ids, d_tile=dtile)),
                  "index_select disagrees with row_gather")
            es = src.element_size()
            nbytes = ids.numel() * 4 + (distinct + ids.numel()) * dm * es
            bound_ms, _ = bound(nbytes)
            out = torch.empty((ids.numel(), dm), dtype=dtype, device=self.dev)
            write_ms = device_ms(out.zero_)
            log(f"[time] {self.tag} row_gather qwen3-moe dispatch {dtype} "
                f"({ids.numel()} x {dm}, d_tile {dtile}): {ms:.4f} ms vs "
                f"bound {bound_ms:.4f} ms ({nbytes} B), {bound_ms / ms:.3f} "
                f"of the bound; plain version {plain_ms:.4f} ms; "
                f"index_select (yardstick) {lib_ms:.4f} ms; writing the "
                f"output alone (Tensor.zero_) {write_ms:.4f} ms")
            del out
            if dtype == torch.bfloat16:
                self.kernel_entry("row_gather", ms, plain_ms, nbytes, 0.0,
                                  lib_ms)

    # ------------------------------------------------------- graph apps
    def graph_phase(self) -> None:
        """The four graph apps on the soc-Pokec analogue (see the module
        docstring, phase 6)."""
        from scipy.sparse import csr_matrix
        t0 = time.perf_counter()
        c = self.G.graph_case(GRAPH["kind"], GRAPH["n"],
                              avg_deg=GRAPH["avg_deg"])
        log(f"[graph] soc-Pokec analogue: {c.num_nodes} nodes, "
            f"{c.num_edges} edges; generate {time.perf_counter() - t0:.2f} s")
        n = c.num_nodes
        adj = csr_matrix((np.ones(c.num_edges), (c.src, c.dst)),
                         shape=(n, n))
        # the GRAPH_S nodes of most out-edges (run() starts at the first)
        sources = np.argsort(-np.bincount(c.src, minlength=n),
                             kind="stable")[:GRAPH_S]
        apps = {"bfs": (self.graphs.BFS, (c.src, c.dst, n), {}),
                "sssp": (self.graphs.SSSP, (c.src, c.dst, c.weight, n),
                         {"weight": np.asarray(c.weight, np.float32)}),
                "cc": (self.graphs.ConnectedComponents, (c.src, c.dst, n),
                       {}),
                "pagerank": (self.PageRank, (c.src, c.dst, n), {})}
        for name, (cls, edges, static) in apps.items():
            self.graph_app(name, cls, edges, static, c, adj, sources)

    def graph_app(self, name, cls, edges, static, c, adj, sources) -> None:
        torch, ir = self.torch, self.ir
        t0 = time.perf_counter()
        app = cls.from_edges(*edges, lane_width=128, backend="cuda",
                             fused=True, device=self.dev)
        build_s = time.perf_counter() - t0
        plan = app.plan
        fb = sum(k.num_blocks for k in plan.classes if k.ls_flag == 0)
        torch_app = dataclasses.replace(app, _run=self.eng.make_executor(
            plan, static, backend="torch", fused=True, device=self.dev))
        kernels = {"unroll_spmv.dense_slice" if la.gather == ir.COALESCED
                   else "unroll_spmv.window"
                   for la in app._run.tree.launches
                   if la.gather != ir.FALLBACK}
        log(f"[graph] {name}: {plan.nnz} edges in {plan.num_blocks} blocks, "
            f"fallback share {fb / max(plan.num_blocks, 1):.4f}, "
            f"{len(app._run.tree.launches)} launches per sweep; from_edges "
            f"(validation, build_plan, staging) {build_s:.2f} s")
        pagerank = name == "pagerank"

        def run(a, driver):
            a.driver = driver
            if pagerank:
                return a.run(iters=PAGERANK_ITERS), None
            out = a.run() if name == "cc" else a.run(int(sources[0]))
            return out, a.convergence

        results = {}
        for backend, a in (("cuda", app), ("torch", torch_app)):
            for driver in ("resident", "host"):
                if backend == "torch" and driver == "host":
                    continue
                self.zero_counts()
                out, report = run(a, driver)
                counts = self.read_counts()
                if backend == "cuda":
                    for k in kernels:
                        check(counts[k] > 0, f"{name} {driver}: {k} named "
                              "by the lowering but never launched")
                results[backend, driver] = (out, report, counts)
        out, report, counts = results["cuda", "resident"]
        for key, (o, r, _) in results.items():
            check(same_bits(o, out) and r == report, f"{name}: {key} "
                  "differs from the cuda resident run")
        self.graph_oracle(name, out.cpu().numpy(), c, adj, sources[0])
        launched = {k: v for k, v in counts.items() if v}
        sweeps = PAGERANK_ITERS if pagerank else report.sweeps
        log(f"[graph] {name}: {report or f'{PAGERANK_ITERS} iterations'}; "
            f"kernel launches {launched} per run; cuda == torch backend "
            "bitwise, resident == host bitwise, oracle held")
        if name in ("bfs", "sssp"):
            self.graph_multi(name, app, torch_app, sources)
        e2e = {}
        for driver in ("resident", "host"):
            app.driver = driver
            e2e[driver] = host_ms(lambda: run(app, driver), warmup=1, reps=3)
        state = out if not pagerank else torch.full(
            (app.num_nodes,), 1.0 / app.num_nodes, device=self.dev)
        sweep_ms = device_ms(
            (lambda: app._step(state)) if pagerank
            else (lambda: app.sweep(state)), reps=5, repeats=3)
        log(f"[time] {self.tag} graph {name}: {sweeps} sweeps; "
            f"{e2e['resident']:.4f} ms end to end with the resident driver, "
            f"{e2e['host']:.4f} ms with the host driver; {sweep_ms:.4f} ms of "
            f"device time per sweep ({sweeps * sweep_ms:.4f} ms for the "
            f"sweeps); build {build_s:.2f} s")
        app.driver = "resident"
        log_profile(self.tag, f"graph {name} resident run",
                    lambda: run(app, "resident"))

    def graph_multi(self, name, app, torch_app, sources) -> None:
        """``run_multi`` of GRAPH_S sources with both drivers: rows bitwise
        ``run``, and bitwise the torch backend's."""
        app.driver = torch_app.driver = "resident"
        self.zero_counts()
        multi = app.run_multi(sources)
        counts = self.read_counts()
        check(sum(counts.values()) > 0, f"{name} run_multi: no kernel launch")
        report = app.convergence
        check(same_bits(multi, torch_app.run_multi(sources)),
              f"{name} run_multi: cuda differs from the torch backend")
        for i, s in enumerate(sources):
            check(same_bits(multi[i], app.run(int(s))),
                  f"{name} run_multi row {i} differs from run({s})")
        app.driver = "host"
        self.zero_counts()
        host = app.run_multi(sources)
        self.read_counts()
        check(same_bits(multi, host) and app.convergence == report,
              f"{name} run_multi: the host driver differs from the resident")
        app.driver = "resident"
        ms = host_ms(lambda: app.run_multi(sources), warmup=1, reps=3)
        log(f"[graph] {name} run_multi S={len(sources)}: {report}; rows "
            f"bitwise equal to run(), to the host driver and to the torch "
            f"backend; kernel "
            f"launches {counts['unroll_spmv.window']} window, "
            f"{counts['unroll_spmv.dense_slice']} dense-slice")
        log(f"[time] {self.tag} graph {name} run_multi S={len(sources)}: "
            f"{ms:.4f} ms end to end (resident driver)")

    def graph_oracle(self, name, got, c, adj, source) -> None:
        """Hold one app's result to scipy.sparse.csgraph / a float64 power
        iteration."""
        from scipy.sparse import csgraph, csr_matrix
        n = c.num_nodes
        if name == "bfs":
            hops = csgraph.shortest_path(adj, method="D", unweighted=True,
                                         indices=int(source))
            want = np.where(np.isinf(hops), -1, hops).astype(np.int32)
            check(np.array_equal(got, want), "bfs levels differ from "
                  "scipy shortest_path(unweighted=True)")
        elif name == "sssp":
            # parallel edges: keep the least weight per (src, dst) pair
            order = np.lexsort((c.weight, c.dst, c.src))
            s, d, w = c.src[order], c.dst[order], c.weight[order]
            first = np.ones(s.size, bool)
            first[1:] = (s[1:] != s[:-1]) | (d[1:] != d[:-1])
            m = csr_matrix((w[first].astype(np.float64),
                            (s[first], d[first])), shape=(n, n))
            want = csgraph.shortest_path(m, method="D", indices=int(source))
            fin = np.isfinite(want)
            check(np.array_equal(np.isfinite(got), fin),
                  "sssp: reachable set differs from Dijkstra")
            rel = float(np.max(np.abs(got[fin] - want[fin])
                               / np.maximum(np.abs(want[fin]), 1e-30)))
            check(rel <= REL_ERR_LIMIT, f"sssp: rel err {rel:.3e} vs "
                  "float64 Dijkstra")
            log(f"[graph] sssp: max rel err vs float64 Dijkstra {rel:.3e}")
        elif name == "cc":
            ncomp, comp = csgraph.connected_components(adj, directed=False)
            mins = np.full(ncomp, n, np.int64)
            np.minimum.at(mins, comp, np.arange(n))
            check(np.array_equal(got, mins[comp]), "cc labels differ from "
                  "the min node id of scipy's components")
            log(f"[graph] cc: {ncomp} components, labels equal to scipy's")
        else:
            deg = np.bincount(c.src, minlength=n).astype(np.float64)
            inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
            push = csr_matrix((np.ones(c.num_edges), (c.dst, c.src)),
                              shape=(n, n))
            rank = np.full(n, 1.0 / n)
            for _ in range(PAGERANK_ITERS):
                rank = (1 - 0.85) / n + 0.85 * (push @ (rank * inv)
                                                + rank[deg == 0].sum() / n)
            err = float(np.abs(got - rank).max() / np.abs(rank).max())
            check(err <= REL_ERR_LIMIT, f"pagerank: err {err:.3e} vs the "
                  "float64 power iteration")
            log(f"[graph] pagerank: max abs err / max rank vs float64 "
                f"power iteration {err:.3e}")

    def card_tests(self) -> None:
        """The ``cuda``-marked tests of ``tests/test_torch_cuda.py`` on this
        card, in a child process (the kernels are already built)."""
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "-p",
             "no:cacheprovider", "tests/test_torch_cuda.py"], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=CARD_TESTS_S)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0:
            for line in lines[-40:]:
                log(f"[tests]   {line}")
        check(proc.returncode == 0, "tests/test_torch_cuda.py failed on the "
              f"card (pytest exit {proc.returncode})")
        log(f"[tests] tests/test_torch_cuda.py on the card: "
            f"{lines[-1] if lines else '?'} ({time.perf_counter() - t0:.1f} s)")

    def run(self) -> None:
        t0 = time.perf_counter()
        self.build_kernels()
        self.make_plans()
        self.stage_a_phase()
        self.main_paths()
        self.matvec_many_phase()
        self.segment_reduce_phase()
        self.gather_vload_phase()
        self.row_gather_phase()
        self.graph_phase()
        self.main_timings()
        self.stage_a_timings()
        for key, c in self.compared.items():
            check(c > 0, f"{key} was never compared with its plain version")
            check(self.main_counts[key] > 0,
                  f"{key} was never launched on its main path")
        self.card_tests()
        log(f"[done] all phases in {time.perf_counter() - t0:.1f} s")
        log(json.dumps({"kernels": [self.line[k] for k in self.wrappers]}))


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch.core.spmm  # noqa: F401
    except ImportError as e:
        fail(f"the repro_torch package is not beside this script ({e})")
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"[device] {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {card}")
    Smoke(dev, card, kind).run()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
