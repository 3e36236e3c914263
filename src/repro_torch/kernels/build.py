"""Build and load the port's CUDA C++ kernels (route b of the Hopper guide).

Each kernel source (``*/csrc/*.cu``) compiles with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -split-compile=0 -Xptxas -v -I kernels/csrc \\
         -o lib<name>_<hash>.so

``-split-compile=0`` optimises a source's kernels in parallel on every core:
the ladder sources instantiate a few hundred kernels (type x reduce x lanes
per thread x index form x D = 1 or not), and it halves their build.

A :class:`Library` is only a description until it is first called: nothing
is built when a module is imported.  The first call builds (once per hash of
the source, the shared headers of ``kernels/csrc`` and the flags) into the
ignored ``build/repro_torch/`` of the checkout, so an edited source rebuilds
and an unchanged one loads in milliseconds.  :func:`build_all` starts one
``nvcc`` per library at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import torch

# headers shared by several kernel sources (the segmented ladder, the row
# copy of the gather kernels)
INCLUDE_DIR = Path(__file__).with_name("csrc")
# repo-root/build/repro_torch, listed in .gitignore
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-split-compile=0",
              "-Xptxas", "-v")

# ctypes argument codes of the C interfaces
P, I, LL, F64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_double)


def largest_divisor(b: int, r: int) -> int:
    """Largest step size <= r that divides b (>= 1) — kernel params are
    upper bounds; the realized value keeps the grid exact so no block is
    ever padded or dropped (bitwise-stable across any requested value)."""
    r = max(1, min(int(r), max(b, 1)))
    while b % r:
        r -= 1
    return r


class RowCopyShape(NamedTuple):
    """Launch shape of the row copy of ``kernels/csrc/row_copy.cuh``."""
    width: int      # bytes per access: 16, 8, 4, 2 or 1
    log_tpl: int    # log2 of the threads that share one row (at most a warp)


def row_copy_shape(elem_bytes: int, row_elems: int, *addresses: int
                   ) -> RowCopyShape:
    """Shape of a copy of rows of ``row_elems`` elements of ``elem_bytes``
    bytes between the given base addresses: the widest access that divides
    the row's bytes and every address, and the least power of two of
    threads covering a row's words, at most a warp (longer rows are moved
    in strips of a warp's words)."""
    row_bytes = elem_bytes * row_elems
    width = 16
    while width > 1 and (row_bytes % width
                         or any(a % width for a in addresses)):
        width //= 2
    words = max(1, row_bytes // width)
    log_tpl = min(5, (words - 1).bit_length())
    return RowCopyShape(width, log_tpl)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from their csrc/ sources at "
                           "first use")
    return found


class Library:
    """One kernel source, built at first call and loaded with ``ctypes``.

    ``signatures`` maps each exported C function to its argument types; every
    function returns an ``int`` CUDA error code.  ``build_seconds`` and
    ``build_log`` (the compiler's ``-Xptxas -v`` report: registers, shared
    memory, spills) record this process's build of it; both stay empty when
    the library was already built."""

    def __init__(self, name: str, source: Path, signatures: dict):
        self.name = name
        self.source = Path(source)
        self.signatures = signatures
        self.build_seconds = 0.0
        self.build_log = ""
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    def _key(self) -> str:
        h = hashlib.sha256(self.source.read_bytes())
        for hdr in sorted(INCLUDE_DIR.glob("*.cuh")):
            h.update(hdr.name.encode() + hdr.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return h.hexdigest()[:16]

    def __call__(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._load()
            return self._lib

    def _load(self) -> ctypes.CDLL:
        so = BUILD_DIR / f"lib{self.name}_{self._key()}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o",
                 str(tmp), str(self.source)], capture_output=True, text=True)
            self.build_seconds = time.perf_counter() - t0
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {self.source}:\n{self.build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in self.signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = I
        return lib


def build_all(libraries) -> None:
    """Build every library at once, one ``nvcc`` process each; raises the
    first build's error."""
    libraries = list(libraries)
    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        for fut in [pool.submit(lib) for lib in libraries]:
            fut.result()


def check_launch(err: int, fn: str) -> None:
    """Raise on a non-zero CUDA error code returned by a C entry point."""
    if err:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err}")


def check_operand(name: str, t: torch.Tensor, device: torch.device,
                  dtype: torch.dtype | None = None,
                  shape: tuple | None = None) -> None:
    """Raise unless ``t`` lies on ``device``, has ``dtype`` and ``shape``
    (where given) and is contiguous: a kernel reads raw pointers, so what it
    does not take must raise before the launch."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the C entry points
    take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
