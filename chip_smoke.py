#!/usr/bin/env python3
"""On-card smoke run of the ``repro_torch`` port: SpMV on the H100.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's main path — ``SpMV.from_coo(..., backend="cuda")``
then ``.matvec(x)`` — on two SuiteSparse analogues at their published
sizes (``sparse/generators.py``), and fails (non-zero exit, no result
line) if any phase fails:

1. device: CUDA present; prints the card's name and power limit on a line
   of their own, as ``nvidia-smi`` gives them;
2. build: compiles the stage-A kernels from ``src/repro_torch`` with
   ``nvcc`` for ``sm_90a`` into ``build/repro_torch`` and prints the time
   and the compiler's register/spill report;
3. kernel phases: every window / dense-slice launch of both matrices,
   fused and per-class, coalesced and not, bitwise against the kernel's
   plain torch version on the card, for add and mul on float32 and min
   and max on int32;
4. main path: ``matvec`` with ``fused=True`` and ``coalesce`` False and
   True, against a float64 numpy oracle (max rel err <= 1e-5) and bitwise
   against the port's ``"torch"`` backend; the launch counters, zeroed
   just before, must show every kernel the lowering names;
5. timings: ``matvec`` per matrix and mode, end to end (host clock
   around the call and a synchronize, median of 20) and in device time
   (CUDA events around 20 back-to-back calls queued behind a spin kernel,
   so launch overhead leaves no gaps; median of 5 such measurements); a ``torch.profiler`` breakdown of
   device time by kernel; each kernel's device time on the main path
   beside its bytes bound (each distinct word once) and its plain
   version; and cuSPARSE's SpMV
   (``torch.sparse_csr_tensor(...) @ x``) as the end-to-end yardstick.

The line before the last is the kernels JSON line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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
SEMIRINGS = (("add", np.float32), ("mul", np.float32), ("min", np.int32),
             ("max", np.int32))
# the two SuiteSparse analogues of the paper's evaluation
MATRICES = {
    "pwtk": dict(kind="banded", n=217918, band=26),        # Boeing/pwtk
    "webbase-1M": dict(kind="power_law", n=1000005, avg_deg=3),
}
KERNEL_SOURCE = "src/repro_torch/kernels/unroll_spmv/csrc/stage_a.cu"
REPLACES = {
    "unroll_spmv.window":
        "src/repro/kernels/unroll_spmv/kernel.py:135 (class_stage_a; "
        "gpu_stage_a :357)",
    "unroll_spmv.dense_slice":
        "src/repro/kernels/unroll_spmv/kernel.py:255 (coalesced_stage_a)",
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


def make_matrix(G, spec):
    if spec["kind"] == "banded":
        return G.banded(spec["n"], band=spec["band"])
    return G.power_law(spec["n"], avg_deg=spec["avg_deg"])


def data_for(m, dtype, seed=SEED):
    rng = np.random.default_rng(seed)
    if np.issubdtype(np.dtype(dtype), np.integer):
        return (rng.integers(-5, 6, m.nnz).astype(dtype),
                rng.integers(-5, 6, m.shape[1]).astype(dtype))
    return (rng.standard_normal(m.nnz).astype(dtype),
            rng.standard_normal(m.shape[1]).astype(dtype))


def launch_bytes_ops(cm) -> tuple[int, int]:
    """Least bytes a stage-A launch must move and the operations it must
    do, from this launch's metadata: each distinct input word read once,
    each output word written once (see the kernel source's header).  Of
    ``x`` that is the distinct words the launch's lanes read, however many
    lanes share one; of the window ids, those some lane of the block
    selects."""
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
    x_words = int(torch.unique(idx).numel())
    steps = max(la.op_flag, 0)
    if la.op_flag < 0 or cm.full is not None:
        steps = max(steps, int(np.ceil(np.log2(max(n, 2)))))
    ops = lanes * (1 + steps)                 # combine + ladder steps
    return head + lanes * (per_lane + 1) * 4 + x_words * 4, ops


def compare_launch(K, ir, cm, xd, elem, reduce) -> tuple[str, float]:
    """One launch through its kernel and its plain version on the card;
    returns the kernel's name and the max abs difference (0.0 exactly when
    the two agree bit for bit, ``inf`` when they differ only in non-finite
    words)."""
    import torch
    la = cm.launch
    s = slice(la.start, la.stop)
    kw = dict(op=la.op_flag, reduce=reduce, full_flags=cm.full)
    if la.gather == ir.COALESCED:
        key = "unroll_spmv.dense_slice"
        args = (cm.starts, [xd], [elem[s]], cm.local, cm.seg)
        got = K.dense_slice_stage_a(*args, **kw)
        torch.cuda.synchronize()
        want = K.dense_slice_stage_a_plain(*args, **kw)
    else:
        key = "unroll_spmv.window"
        args = (cm.win, [xd], [elem[s]], cm.slot, cm.off, cm.seg)
        kw["stream"] = la.stream
        got = K.window_stage_a(*args, **kw)
        torch.cuda.synchronize()
        want = K.window_stage_a_plain(*args, **kw)
    torch.cuda.synchronize()
    if torch.equal(got.view(torch.int32), want.view(torch.int32)):
        return key, 0.0
    diff = (got.double() - want.double()).abs()
    diff = diff[torch.isfinite(diff)]
    return key, float(diff.max()) if diff.numel() and diff.max() > 0 \
        else float("inf")


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
        from repro_torch.core import engine as eng
        from repro_torch.core import ir
        from repro_torch.core.apps import SpMV
        from repro_torch.core.plan import CostModel, build_plan
        from repro_torch.core.seed import spmv_seed
        from repro_torch.kernels.unroll_spmv import kernel as K
        from repro_torch.kernels.unroll_spmv import ops
        from repro_torch.sparse import generators as G
    except ImportError as e:
        fail(f"the repro_torch package is not beside this script ({e})")
    dev = torch.device("cuda", torch.cuda.current_device())

    # ---- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"[device] {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {card}")

    # ---- 2. build
    t0 = time.perf_counter()
    K.library()
    log(f"[build] stage-A kernels ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {K.library.build_seconds:.2f} s)")
    for line in K.library.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # ---- matrices and plans (host)
    mats, plans = {}, {}
    for name, spec in MATRICES.items():
        t0 = time.perf_counter()
        m = mats[name] = make_matrix(G, spec)
        t1 = time.perf_counter()
        plans[name] = build_plan(spmv_seed(), {"row": m.rows, "col": m.cols},
                                 m.shape[0], m.shape[1],
                                 CostModel(lane_width=128))
        p = plans[name]
        fb = sum(c.num_blocks for c in p.classes if c.ls_flag == 0)
        log(f"[matrix] {name}: {m.shape[0]} rows, {m.nnz} nnz, "
            f"{p.num_blocks} blocks ({fb} gather-fallback, "
            f"{fb / p.num_blocks:.4f}), {p.stats.num_classes} classes; "
            f"generate {t1 - t0:.2f} s, build_plan "
            f"{time.perf_counter() - t1:.2f} s")
        for fused in (True, False):
            t = ir.lower(p, backend="cuda", fused=fused, coalesce=True)
            log(f"[matrix] {name}: cuda fused={fused} coalesce=True -> "
                f"{len(t.launches)} launches, coalesced fraction "
                f"{ir.coalesced_fraction(t):.4f}; torch form "
                f"{ir.coalesce_stats(p, fused=fused)}")

    # ---- 3. kernel phases: each kernel bitwise against its plain version
    max_err = {k: 0.0 for k in K.KERNELS}
    compared = {k: 0 for k in K.KERNELS}
    for name, plan in plans.items():
        lowerings = {}
        for fused in (True, False):
            for coalesce in (False, True):
                tree = ir.lower(plan, backend="cuda", fused=fused,
                                coalesce=coalesce)
                lowerings[fused, coalesce] = [
                    cm for cm in ops.stage_launch_meta(plan, tree.launches,
                                                       dev)
                    if cm.launch.gather != ir.FALLBACK]
        for reduce, dtype in SEMIRINGS:
            vals, x = data_for(mats[name], dtype)
            xd = torch.as_tensor(x, device=dev)
            elem = eng.reorder_elementwise(plan, vals, reduce=reduce,
                                           device=dev)
            for (fused, coalesce), metas in lowerings.items():
                for cm in metas:
                    key, err = compare_launch(K, ir, cm, xd, elem, reduce)
                    max_err[key] = max(max_err[key], err)
                    compared[key] += 1
                    check(err == 0.0, f"{key} differs from its plain version "
                          f"({name} fused={fused} coalesce={coalesce} "
                          f"{reduce}/{np.dtype(dtype).name} launch "
                          f"[{cm.launch.start}, {cm.launch.stop}) "
                          f"op={cm.launch.op_flag}; max abs err {err})")
                log(f"[kernels] {name} fused={fused} coalesce={coalesce} "
                    f"{reduce}/{np.dtype(dtype).name}: {len(metas)} kernel "
                    "launches bitwise equal to the plain versions")
    for key in K.KERNELS:
        check(compared[key] > 0, f"{key} was never compared")

    # ---- 4. main path
    apps, runs = {}, []
    main_counts = {k: 0 for k in K.KERNELS}
    for name, m in mats.items():
        vals, x = data_for(m, np.float32)
        xd = torch.as_tensor(x, device=dev)
        oracle = np.zeros(m.shape[0], np.float64)
        np.add.at(oracle, m.rows, vals.astype(np.float64)
                  * x.astype(np.float64)[m.cols])
        for coalesce in (False, True):
            t0 = time.perf_counter()
            app = SpMV.from_coo(m.rows, m.cols, vals, m.shape,
                                backend="cuda", fused=True,
                                coalesce=coalesce, device="cuda")
            build_s = time.perf_counter() - t0
            apps[name, coalesce] = app
            for fn in K.KERNELS.values():
                fn.launches = 0
            y = app.matvec(xd)
            torch.cuda.synchronize()
            counts = {k: fn.launches for k, fn in K.KERNELS.items()}
            for k, c in counts.items():
                main_counts[k] += c
            tree = app._run.tree
            named = {"unroll_spmv.dense_slice" if la.gather == ir.COALESCED
                     else "unroll_spmv.window"
                     for la in tree.launches if la.gather != ir.FALLBACK}
            for k in named:
                check(counts[k] > 0, f"{k} named by the lowering of {name} "
                      f"coalesce={coalesce} but never launched")
            check(tuple(y.shape) == (m.shape[0],) and y.dtype ==
                  torch.float32, f"bad output {tuple(y.shape)} {y.dtype}")
            yh = y.cpu().numpy()
            check(bool(np.isfinite(yh).all()), "non-finite output")
            rel = float(np.abs(yh - oracle).max() / np.abs(oracle).max())
            check(rel <= REL_ERR_LIMIT, f"{name} coalesce={coalesce}: rel "
                  f"err {rel:.3e} vs the float64 oracle")
            torch_run = eng.make_executor(app.plan, {"value": vals},
                                          backend="torch", fused=True,
                                          coalesce=coalesce, device=dev)
            y_torch = torch_run({"x": xd}, torch.zeros_like(y))
            torch.cuda.synchronize()
            check(torch.equal(y.view(torch.int32),
                              y_torch.view(torch.int32)),
                  f"{name} coalesce={coalesce}: cuda backend differs from "
                  "the torch backend")
            runs.append(dict(matrix=name, coalesce=coalesce,
                             launches=len(tree.launches), counts=counts,
                             rel_err=rel, build_s=build_s, x=xd,
                             torch_run=torch_run))
            log(f"[main] {name} fused=True coalesce={coalesce}: "
                f"{len(tree.launches)} launches, kernel launches {counts}, "
                f"max rel err vs float64 oracle {rel:.3e}, bitwise equal "
                f"to the torch backend; from_coo {build_s:.2f} s")
    for r in runs:
        if r["matrix"] == "webbase-1M" and not r["coalesce"]:
            check(r["counts"]["unroll_spmv.window"] > 0,
                  "window kernel not launched on webbase-1M coalesce=False")
        if r["matrix"] == "pwtk" and r["coalesce"]:
            check(r["counts"]["unroll_spmv.dense_slice"] > 0,
                  "dense-slice kernel not launched on pwtk coalesce=True")

    # ---- 5. timings
    tag = f"[{card}]"
    for r in runs:
        app = apps[r["matrix"], r["coalesce"]]
        xd = r["x"]
        y0 = torch.zeros(app.shape[0], device=dev)
        stage_a = app._run.sweep_body.stage_a
        r["matvec_ms"] = host_ms(lambda: app.matvec(xd))
        r["matvec_dev_ms"] = device_ms(lambda: app.matvec(xd))
        r["stage_a_dev_ms"] = device_ms(lambda: stage_a({"x": xd}))
        r["torch_ms"] = host_ms(lambda: r["torch_run"]({"x": xd}, y0))
        log(f"[time] {tag} {r['matrix']} coalesce={r['coalesce']}: "
            f"matvec cuda {r['matvec_ms']:.4f} ms end to end, "
            f"{r['matvec_dev_ms']:.4f} ms of device time (stage A "
            f"{r['stage_a_dev_ms']:.4f} ms); torch backend "
            f"{r['torch_ms']:.4f} ms end to end")
        prof = profile_breakdown(lambda: app.matvec(xd))
        if prof is None:
            log(f"[profile] {tag} {r['matrix']} coalesce={r['coalesce']}: "
                "no device time recorded (not measured)")
            continue
        wall_ms, busy_ms, top = prof
        log(f"[profile] {tag} {r['matrix']} coalesce={r['coalesce']}: "
            f"device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms wall per "
            f"matvec under the profiler (idle share <= "
            f"{1 - busy_ms / wall_ms:.3f})")
        for kname, kms, kcount in top:
            log(f"[profile]   {kms:.4f} ms in {kcount} launches: {kname}")
    library_ms = {}
    for name, m in mats.items():
        vals, x = data_for(m, np.float32)
        indptr = np.r_[0, np.cumsum(np.bincount(m.rows,
                                                minlength=m.shape[0]))]
        a_csr = torch.sparse_csr_tensor(
            torch.as_tensor(indptr, device=dev),
            torch.as_tensor(m.cols, device=dev),
            torch.as_tensor(vals, device=dev), size=m.shape)
        xd = torch.as_tensor(x, device=dev)
        y_lib = (a_csr @ xd).cpu().numpy()
        y_ref = apps[name, False].matvec(xd).cpu().numpy()
        check(np.allclose(y_lib, y_ref, rtol=1e-4, atol=1e-4),
              f"cuSPARSE disagrees with the port on {name}")
        library_ms[name] = device_ms(lambda: a_csr @ xd)
        lib_host = host_ms(lambda: a_csr @ xd)
        log(f"[time] {tag} {name}: cuSPARSE SpMV (torch.sparse_csr_tensor "
            f"@ x, the yardstick) {library_ms[name]:.4f} ms of device time, "
            f"{lib_host:.4f} ms end to end")

    # each kernel on the main path: its launches of one matvec, timed as a
    # sequence, beside the plain versions and the bound
    representative = {"unroll_spmv.window": ("webbase-1M", False),
                      "unroll_spmv.dense_slice": ("pwtk", True)}
    kernels_line = []
    for key, (name, coalesce) in representative.items():
        app = apps[name, coalesce]
        plan = app.plan
        xd = next(r["x"] for r in runs if r["matrix"] == name)
        elem = eng.reorder_elementwise(plan, data_for(mats[name],
                                                      np.float32)[0],
                                       device=dev)
        metas = [cm for cm in app._run.sweep_body.stage_a.launch_meta
                 if cm.launch.gather != ir.FALLBACK
                 and (cm.launch.gather == ir.COALESCED)
                 == (key == "unroll_spmv.dense_slice")]
        lanes = torch.empty((plan.num_blocks, plan.lane_width), device=dev)

        def run_all(plain=False, metas=metas, lanes=lanes, xd=xd,
                    elem=elem, plan=plan):
            for cm in metas:
                s = slice(cm.launch.start, cm.launch.stop)
                if plain:
                    lanes[s] = (K.dense_slice_stage_a_plain(
                        cm.starts, [xd], [elem[s]], cm.local, cm.seg,
                        op=cm.launch.op_flag, reduce="add",
                        full_flags=cm.full)
                        if cm.launch.gather == ir.COALESCED else
                        K.window_stage_a_plain(
                            cm.win, [xd], [elem[s]], cm.slot, cm.off,
                            cm.seg, op=cm.launch.op_flag,
                            stream=cm.launch.stream, reduce="add",
                            full_flags=cm.full))
                else:
                    ops.run_launch(plan, cm, [xd], [elem[s]], out=lanes[s])

        ms = device_ms(run_all)
        plain_ms = device_ms(lambda: run_all(plain=True), reps=5)
        nbytes = nops = 0
        for cm in metas:
            b, o = launch_bytes_ops(cm)
            nbytes += b
            nops += o
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_OPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        run = next(r for r in runs if r["matrix"] == name
                   and r["coalesce"] == coalesce)
        kernels_line.append({
            "name": key, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[key], "launches": main_counts[key],
            "max_abs_err": max_err[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
        log(f"[time] {tag} {key} on {name} coalesce={coalesce}: "
            f"{len(metas)} launches/matvec (main-path counter "
            f"{run['counts'][key]}), {ms:.4f} ms vs bound {bound_ms:.4f} ms "
            f"({nbytes} B at {HBM_BYTES_PER_S:.3g} B/s; {nops} ops), "
            f"{bound_ms / ms:.3f} of the bound; plain version "
            f"{plain_ms:.4f} ms; no single PyTorch call computes it")

    log(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
