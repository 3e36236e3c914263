"""Synthetic sparse-matrix / graph corpus (SuiteSparse-like families).

The paper evaluates on SuiteSparse matrices spanning regular (Dense, QCD)
to highly irregular (Webbase-1M, dc2) structure, plus power-law graphs for
PageRank.  This module generates deterministic synthetic analogues of each
family so the paper's Table 5/6/7/8 and Fig. 7 experiments are reproducible
offline.  All generators return sorted COO (row-major, like CSR expansion).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class COOMatrix:
    name: str
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def nnz_per_row(self) -> float:
        return self.nnz / self.shape[0]


def _finish(name, r, c, v, shape) -> COOMatrix:
    order = np.lexsort((c, r))
    return COOMatrix(name, r[order].astype(np.int64),
                     c[order].astype(np.int64),
                     v[order].astype(np.float32), shape)


def dense(n: int = 512, seed: int = 0) -> COOMatrix:
    """Fully dense matrix in COO (paper's 'Dense': perfect L/S=1, Op=full)."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), n)
    c = np.tile(np.arange(n), n)
    return _finish("dense", r, c, rng.standard_normal(n * n), (n, n))


def banded(n: int = 4096, band: int = 27, seed: int = 1) -> COOMatrix:
    """FEM-like banded matrix (paper's FEM_Ship / Wind Tunnel family)."""
    rng = np.random.default_rng(seed)
    offs = np.arange(-band, band + 1)
    r = np.repeat(np.arange(n), offs.size)
    c = (r.reshape(n, offs.size) + offs[None, :]).ravel()
    keep = (c >= 0) & (c < n)
    r, c = r[keep], c[keep]
    return _finish("banded", r, c, rng.standard_normal(r.size), (n, n))


def random_uniform(n: int = 4096, nnz_per_row: int = 7, seed: int = 2
                   ) -> COOMatrix:
    """Unstructured random (paper's dc2 / CirCuit family: bad L/S)."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), nnz_per_row)
    c = rng.integers(0, n, size=r.size)
    return _finish("random", r, c, rng.standard_normal(r.size), (n, n))


def power_law(n: int = 8192, avg_deg: int = 16, alpha: float = 1.8,
              seed: int = 3, name: str = "powerlaw") -> COOMatrix:
    """Power-law graph adjacency (paper's Webbase / twitter family)."""
    rng = np.random.default_rng(seed)
    # Zipfian column popularity, row degrees power-law distributed
    deg = np.minimum(rng.zipf(alpha, size=n), n // 4)
    deg = (deg * (avg_deg * n / max(deg.sum(), 1))).astype(np.int64)
    deg = np.maximum(deg, 1)
    r = np.repeat(np.arange(n), deg)
    pop = 1.0 / np.arange(1, n + 1) ** 0.9
    pop /= pop.sum()
    c = rng.choice(n, size=r.size, p=pop)
    return _finish(name, r, c, rng.standard_normal(r.size), (n, n))


def block_diag(n: int = 4096, block: int = 64, fill: float = 0.6,
               seed: int = 4) -> COOMatrix:
    """Block-structured (paper's mip1 family: mostly L/S=1)."""
    rng = np.random.default_rng(seed)
    rs, cs = [], []
    for b0 in range(0, n, block):
        size = min(block, n - b0)
        mask = rng.random((size, size)) < fill
        rr, cc = np.nonzero(mask)
        rs.append(rr + b0)
        cs.append(cc + b0)
    r = np.concatenate(rs)
    c = np.concatenate(cs)
    return _finish("blockdiag", r, c, rng.standard_normal(r.size), (n, n))


def stencil_qcd(n_side: int = 24, seed: int = 5) -> COOMatrix:
    """4D nearest-neighbour stencil (paper's QCD family: regular stride)."""
    rng = np.random.default_rng(seed)
    n = n_side ** 2
    grid = np.arange(n).reshape(n_side, n_side)
    rs, cs = [], []
    for dr, dc in [(0, 0), (0, 1), (0, -1), (1, 0), (-1, 0)]:
        nb = np.roll(np.roll(grid, dr, 0), dc, 1)
        rs.append(grid.ravel())
        cs.append(nb.ravel())
    r = np.concatenate(rs)
    c = np.concatenate(cs)
    return _finish("qcd", r, c, rng.standard_normal(r.size), (n, n))


def suite(scale: str = "small") -> list[COOMatrix]:
    """The benchmark corpus: one synthetic analogue per paper dataset class."""
    if scale == "small":
        return [dense(128), banded(1024, band=13), random_uniform(1024, 5),
                power_law(2048, 8), block_diag(1024, 32), stencil_qcd(16)]
    return [dense(512), banded(8192, band=27), random_uniform(8192, 7),
            power_law(16384, 16), block_diag(8192, 64), stencil_qcd(48),
            power_law(32768, 20, alpha=1.6, seed=7, name="social")]


def graph_edges(kind: str, n: int, avg_deg: int = 16, seed: int = 11
                ) -> tuple[np.ndarray, np.ndarray, int]:
    """Edge lists for the graph applications (paper's amazon/twitter/pokec
    analogues, plus the degenerate classes that stress the engine's
    identity handling: empty graphs and isolated/dangling nodes)."""
    if kind == "powerlaw":
        m = power_law(n, avg_deg, seed=seed)
        return np.asarray(m.rows), np.asarray(m.cols), n
    if kind == "uniform":
        m = random_uniform(n, avg_deg, seed=seed)
        return np.asarray(m.rows), np.asarray(m.cols), n
    if kind == "banded":
        m = banded(n, band=max(2, avg_deg // 2), seed=seed)
        return np.asarray(m.rows), np.asarray(m.cols), n
    if kind == "ring":
        src = np.arange(n)
        dst = (src + 1) % n
        return src, dst, n
    if kind == "empty":
        z = np.zeros(0, np.int64)
        return z, z.copy(), n
    if kind == "isolated":
        # edges only among the first half of the nodes; the second half is
        # isolated, and within the connected half some nodes are dangling
        # (out-degree 0) because edges are random.
        m = random_uniform(max(n // 2, 1), avg_deg, seed=seed)
        return np.asarray(m.rows), np.asarray(m.cols), n
    raise ValueError(kind)


@dataclasses.dataclass(frozen=True)
class GraphCase:
    """One graph-application benchmark/test input: weighted directed edges."""
    name: str
    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray   # float32, positive (SSSP-safe)
    num_nodes: int

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


def graph_case(kind: str, n: int, avg_deg: int = 16, seed: int = 11
               ) -> GraphCase:
    src, dst, n = graph_edges(kind, n, avg_deg=avg_deg, seed=seed)
    rng = np.random.default_rng(seed + 1000)
    w = rng.uniform(0.1, 1.0, size=src.shape[0]).astype(np.float32)
    return GraphCase(kind, src, dst, w, n)


def graph_suite(scale: str = "small") -> list[GraphCase]:
    """The graph-application corpus (BFS/SSSP/CC benchmarks + oracles)."""
    if scale == "small":
        n = 512
    else:
        n = 8192
    return [graph_case("powerlaw", n, 8),
            graph_case("uniform", n, 6),
            graph_case("banded", n, 8),
            graph_case("ring", n),
            graph_case("isolated", n, 6),
            graph_case("empty", 64)]
