"""Concurrent query-serving launcher (DESIGN.md §12).

Builds one shared graph/matrix on ``--device`` (default ``cuda``, which
raises where torch sees no CUDA device), wraps it in a
:class:`~repro_torch.serve.query.QueryEngine`, and fires a multi-threaded
client load at it, printing p50/p99 latency, QPS, and the
shed/deadline/breaker counters — the operational smoke test for the
serving layer.

    PYTHONPATH=src python -m repro_torch.launch.serve_queries \\
        --app bfs --graph powerlaw --nodes 4096 --requests 256 \\
        --threads 4 --max-batch 32 --deadline 5.0

A port of the JAX package's ``launch/serve_queries.py``, with ``--device``
added and ``--backend`` defaulting to ``cuda`` (the hand-written stage-A
kernels); ``main(argv)`` returns the JSON summary.  ``--check K`` (also
added) holds K evenly spaced served responses against the same endpoint
over a ``backend="torch"`` build of the same graph or matrix — exactly for
BFS/SSSP, within ``allclose(rtol=1e-5, atol=1e-6)`` for SpMV (whose
``segsum`` backend sums in another order), counting the bitwise-equal ones
too — and exits non-zero (after writing ``--json``) when one is outside.
"""
from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np

from repro_torch.core import engine as eng
from repro_torch.serve import query as Q


def _build_endpoint(args, device):
    from repro_torch.sparse import generators as G
    if args.app in ("bfs", "sssp"):
        case = G.graph_case(args.graph, args.nodes, avg_deg=args.avg_deg)
        from repro_torch.core import graphs as GR
        if args.app == "bfs":
            app = GR.BFS.from_edges(case.src, case.dst, case.num_nodes,
                                    backend=args.backend, device=device)
            ep = Q.bfs_endpoint(app, max_batch=args.max_batch)
        else:
            app = GR.SSSP.from_edges(case.src, case.dst, case.weight,
                                     case.num_nodes, backend=args.backend,
                                     device=device)
            ep = Q.sssp_endpoint(app, max_batch=args.max_batch)
        payloads = np.random.default_rng(0).integers(
            0, case.num_nodes, args.requests)
        return ep, list(payloads)
    if args.app == "spmv":
        from repro_torch.core.apps import SpMV
        m = G.power_law(args.nodes, args.avg_deg, seed=3)
        app = SpMV.from_coo(m.rows, m.cols, m.vals, m.shape,
                            backend=args.backend, device=device)
        rng = np.random.default_rng(0)
        xs = rng.standard_normal(
            (args.requests, m.shape[1])).astype(np.float32)
        return Q.spmv_endpoint(app, max_batch=args.max_batch), list(xs)
    raise SystemExit(f"unknown --app {args.app!r}")


def _check_sample(args, device, payloads, values) -> dict:
    """Hold ``args.check`` evenly spaced served responses against one
    batch of the same payloads through a ``backend="torch"`` build."""
    idx = sorted({int(i) for i in np.linspace(0, len(payloads) - 1,
                                              args.check)})
    idx = [i for i in idx if values[i] is not None]
    plain, _ = _build_endpoint(
        argparse.Namespace(**dict(vars(args), backend="torch")), device)
    want = plain.batch_fn([payloads[i] for i in idx]) if idx else []
    if hasattr(want, "cpu"):
        want = want.cpu().numpy()
    bitwise, bad = 0, []
    for i, w in zip(idx, want):
        got = np.ascontiguousarray(values[i])
        w = np.ascontiguousarray(w)
        if got.dtype != w.dtype or got.shape != w.shape:
            bad.append(i)
        elif np.array_equal(got.view(np.uint8), w.view(np.uint8)):
            bitwise += 1
        elif args.app != "spmv" or not np.allclose(got, w, rtol=1e-5,
                                                   atol=1e-6):
            bad.append(i)
    return {"checked": len(idx), "bitwise": bitwise, "mismatched": len(bad),
            "first_mismatch": bad[0] if bad else None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", default="bfs",
                    choices=["bfs", "sssp", "spmv"])
    ap.add_argument("--graph", default="powerlaw",
                    choices=["powerlaw", "uniform", "banded", "ring"])
    ap.add_argument("--nodes", type=int, default=4096)
    ap.add_argument("--avg-deg", type=int, default=8)
    ap.add_argument("--backend", default="cuda",
                    help="torch, segsum, cuda (default) or auto")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a CUDA device) "
                         "or cpu")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--queue-cap", type=int, default=256)
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline in seconds (default: none)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also dump latency summary + health as JSON")
    ap.add_argument("--check", type=int, default=0, metavar="K",
                    help="hold K evenly spaced responses bitwise against a "
                         "backend='torch' build (default 0: none)")
    args = ap.parse_args(argv)
    device = eng.resolve_device(args.device)

    print(f"[serve] building {args.app} over {args.graph} "
          f"n={args.nodes} on {device} backend={args.backend} ...")
    t0 = time.perf_counter()
    ep, payloads = _build_endpoint(args, device)
    print(f"[serve] plan built in {time.perf_counter() - t0:.2f}s "
          f"fingerprint={ep.fingerprint}")

    engine = Q.QueryEngine([ep], queue_capacity=args.queue_cap,
                           default_deadline_s=args.deadline)
    try:
        engine.warmup(ep.name, payloads[0], batch=ep.max_batch)
        print(f"[serve] warm: {engine.health()['endpoints'][ep.name]}")

        lat: list[float] = []
        values = [None] * len(payloads)
        errors = {"shed": 0, "deadline": 0, "other": 0}
        lock = threading.Lock()

        def client(chunk):
            tickets = []
            for i in chunk:
                try:
                    tickets.append((i, engine.submit(ep.name, payloads[i])))
                except Q.RejectedError:
                    with lock:
                        errors["shed"] += 1
            for i, t in tickets:
                try:
                    r = t.result(120)
                    values[i] = r.value
                    with lock:
                        lat.append(r.total_s)
                except Q.DeadlineExceeded:
                    with lock:
                        errors["deadline"] += 1
                except Q.ServeError:
                    with lock:
                        errors["other"] += 1

        chunks = [range(i, len(payloads), args.threads)
                  for i in range(args.threads)]
        walls = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in chunks]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - walls
        health = engine.health()
    finally:
        engine.close()

    served = len(lat)
    qps = served / wall if wall > 0 else 0.0
    lat_ms = sorted(x * 1e3 for x in lat) or [0.0]
    p50 = lat_ms[len(lat_ms) // 2]
    p99 = lat_ms[min(len(lat_ms) - 1, int(len(lat_ms) * 0.99))]

    print(f"[serve] served={served}/{args.requests} in {wall:.2f}s "
          f"({qps:.1f} qps) p50={p50:.1f}ms p99={p99:.1f}ms")
    print(f"[serve] shed={errors['shed']} deadline={errors['deadline']} "
          f"other={errors['other']}")
    print(f"[serve] counters={health['counters']} "
          f"breaker={health['breaker']['state']}")
    summary = {"app": args.app, "graph": args.graph, "device": str(device),
               "backend": args.backend, "requests": args.requests,
               "served": served, "qps": qps, "p50_ms": p50, "p99_ms": p99,
               "errors": errors, "health": health}
    if args.check:
        summary["check"] = _check_sample(args, device, payloads, values)
        print(f"[serve] check against backend=torch: {summary['check']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"[serve] wrote {args.json}")
    if args.check and summary["check"]["mismatched"]:
        raise SystemExit(f"[serve] {summary['check']['mismatched']} of "
                         f"{summary['check']['checked']} sampled responses "
                         "differ from the backend='torch' build")
    return summary


if __name__ == "__main__":
    main()
