"""Reading of :data:`repro_torch.tune.cost.CUDA_SCALE` on a CUDA card.

Run from the root of a checkout, on a machine with a CUDA card:

    PYTHONPATH=src python -m repro_torch.tune.calibrate

It measures every candidate of the SpMV space (``top_k=None``, float32)
with the tuner's own harness on the SuiteSparse analogues of the paper's
evaluation at their published sizes, Boeing/pwtk (``banded(217918,
band=26)``) and webbase-1M (``power_law(1000005, avg_deg=3)``), and
prints per candidate its measured µs beside the cost model's prediction
and the model before its backend's scale.  Per matrix it prints the
constant's reading: measured over unscaled model of the fused
window-kernel candidate (``cuda/fused/gather``) over measured over
predicted of the fused torch one (``torch/fused/gather``).  The last line
is the geometric mean of the readings, the number ``CUDA_SCALE`` rounds.
A candidate rejected by the oracle or disqualified fails the run.
"""
from __future__ import annotations

import argparse
import math
import subprocess
import time
import warnings

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.core.seed import spmv_seed
from repro_torch.sparse import generators as G
from repro_torch.tune import cost as tcost
from repro_torch.tune import search

MATRICES = {
    "pwtk": lambda: G.banded(217918, band=26),
    "webbase-1M": lambda: G.power_law(1000005, avg_deg=3),
}
KERNEL_LABEL = "cuda/fused/gather"
TORCH_LABEL = "torch/fused/gather"


def measure_space(m, device, seed: int = 0) -> list[dict]:
    """Every candidate of the SpMV space measured on matrix ``m`` (float32
    values and ``x`` from ``seed``), fastest first: label, backend,
    measured, predicted and unscaled-model µs."""
    dev = eng.resolve_device(device)
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(m.nnz).astype(np.float32)
    x = torch.as_tensor(rng.standard_normal(m.shape[1]).astype(np.float32),
                        device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        _, _, res = search.autotune(
            spmv_seed(), {"row": m.rows, "col": m.cols}, m.shape[0],
            m.shape[1], {"value": vals}, {"x": x},
            torch.zeros(m.shape[0], device=dev), top_k=None)
    bad = [mm.candidate.label for mm in res.measurements
           if not mm.ok or not math.isfinite(mm.us_per_call)]
    if bad:
        raise RuntimeError(f"candidates rejected or disqualified: {bad}")
    return [{"label": mm.candidate.label, "backend": mm.candidate.backend,
             "measured_us": mm.us_per_call, "predicted_us": mm.predicted_us,
             "unscaled_us": mm.predicted_us
             / tcost.backend_scale(mm.candidate, res.platform)}
            for mm in sorted(res.measurements,
                             key=lambda mm: mm.us_per_call)]


def _form(label: str) -> str:
    """A candidate's label without its lane-width part ("/n128")."""
    return "/".join(p for p in label.split("/")
                    if not (p[:1] == "n" and p[1:].isdigit()))


def reading(rows: list[dict]) -> float:
    """The constant's reading on one matrix (see the module docstring)."""
    by = {_form(r["label"]): r for r in rows}
    k, t = by[KERNEL_LABEL], by[TORCH_LABEL]
    return ((k["measured_us"] / k["unscaled_us"])
            / (t["measured_us"] / t["predicted_us"]))


def main(argv=None, matrices: dict | None = None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device to measure on (default: cuda)")
    args = ap.parse_args(argv)
    dev = eng.resolve_device(args.device)
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(f"[calibrate] {torch.cuda.get_device_name(dev)}; nvidia-smi: "
              f"{smi.stdout.strip() or smi.stderr.strip()}", flush=True)
    readings = []
    for name, make in (matrices or MATRICES).items():
        m = make()
        t0 = time.perf_counter()
        rows = measure_space(m, dev)
        wall = time.perf_counter() - t0
        for r in rows:
            print(f"[calibrate] {name} {r['label']}: measured "
                  f"{r['measured_us']:.2f} us, predicted "
                  f"{r['predicted_us']:.2f} us (model before its backend's "
                  f"scale {r['unscaled_us']:.2f} us)", flush=True)
        readings.append(reading(rows))
        print(f"[calibrate] {name}: {m.shape[0]} rows, {m.nnz} nnz, "
              f"{len(rows)} candidates in {wall:.2f} s; winner "
              f"{rows[0]['label']}; reading {readings[-1]:.4f}", flush=True)
    scale = math.exp(sum(map(math.log, readings)) / len(readings))
    print(f"[calibrate] geometric mean of the readings {scale:.4f} "
          f"(CUDA_SCALE = {tcost.CUDA_SCALE})", flush=True)
    return scale


if __name__ == "__main__":
    main()
