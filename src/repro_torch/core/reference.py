"""Numpy oracles for the port (``repro.core.reference`` semantics).

The reference's oracles loop over edges in Python; these give the same
answers vectorized, so that they answer in seconds on the R-MAT-22 graph
(41 M edges) the card runs:

* :func:`bfs_ref` is level-synchronous over CSR segments (hop counts do
  not depend on visiting order);
* :func:`sssp_ref` and :func:`wcc_ref` call ``scipy.sparse.csgraph``
  (Dijkstra; connected components, each labelled with its minimum
  original id).  Dijkstra sums in float64 where the reference's loop,
  under NumPy 2's promotion of ``float + np.float32``, sums in float32,
  so the two agree within float32 rounding (1e-6 relative on R-MAT-8),
  well inside the ``rtol=1e-5`` that SSSP results are held to;
* :func:`kcore_ref` peels every vertex below ``k`` at once per step with
  one ``np.add.at`` of the decrements (the core is the same fixed point
  whatever the peeling order);
* :func:`pagerank_ref` and :func:`spmv_ref` are the reference's own
  ``np.add.at`` code, and :func:`triangles_ref` its set loop (only ever
  run on small graphs).

:func:`spmv_f32_bound` is the per-vertex limit of a float32 SpMV's
rounding error, for graphs whose in-degrees make the reference's fixed
tolerance too tight for a float32 sum.
"""
from __future__ import annotations

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components, dijkstra

from repro_torch.core.graph import CSRGraph


def _src(g: CSRGraph) -> np.ndarray:
    """Source vertex of every edge."""
    return np.repeat(np.arange(g.num_vertices), g.ptr[1:] - g.ptr[:-1])


def _out_edges(g: CSRGraph, verts: np.ndarray) -> np.ndarray:
    """Indices of every out-edge of ``verts``, as one flat gather."""
    start = g.ptr[verts]
    deg = g.ptr[verts + 1] - start
    within = np.arange(int(deg.sum()), dtype=np.int64) \
        - np.repeat(np.cumsum(deg) - deg, deg)
    return np.repeat(start, deg) + within


def _matrix(g: CSRGraph, data) -> csr_matrix:
    n = g.num_vertices
    return csr_matrix((data, g.dst, g.ptr), shape=(n, n))


def bfs_ref(g: CSRGraph, root: int) -> np.ndarray:
    """Hop counts from root; unreachable = +inf."""
    dist = np.full(g.num_vertices, np.inf, np.float64)
    dist[root] = 0
    frontier = np.array([root], np.int64)
    d = 0
    while frontier.size:
        nbr = g.dst[_out_edges(g, frontier)]
        nbr = np.unique(nbr[dist[nbr] == np.inf])
        dist[nbr] = d + 1
        frontier, d = nbr, d + 1
    return dist


def sssp_ref(g: CSRGraph, root: int) -> np.ndarray:
    """Float64 shortest path lengths (nonnegative weights); unreachable =
    +inf."""
    return dijkstra(_matrix(g, g.val.astype(np.float64)), directed=True,
                    indices=root)


def wcc_ref(g: CSRGraph) -> np.ndarray:
    """Weakly connected components: label = min original vertex id in the
    component.  Assumes ``g`` is already symmetrized."""
    n = g.num_vertices
    _, comp = connected_components(_matrix(g, np.ones(g.num_edges)),
                                   directed=False)
    low = np.full(comp.max() + 1 if n else 0, n, np.int64)
    np.minimum.at(low, comp, np.arange(n))
    return low[comp]


def pagerank_ref(g: CSRGraph, damping: float = 0.85, iters: int = 20
                 ) -> np.ndarray:
    """Power iteration with dangling-mass redistribution (float64)."""
    n = g.num_vertices
    deg = (g.ptr[1:] - g.ptr[:-1]).astype(np.float64)
    rank = np.full(n, 1.0 / n)
    src = _src(g)
    for _ in range(iters):
        contrib = np.where(deg > 0, rank / np.maximum(deg, 1), 0.0)
        acc = np.zeros(n)
        np.add.at(acc, g.dst, contrib[src])
        dangling = rank[deg == 0].sum()
        rank = (1 - damping) / n + damping * (acc + dangling / n)
    return rank


def kcore_ref(g: CSRGraph, k: int) -> np.ndarray:
    """k-core membership by peeling (g symmetric, deduped): repeatedly
    delete the vertices whose remaining degree is < k, decrementing each
    neighbor once per deleted edge.  Returns (V,) int64 in {0, 1}."""
    deg = (g.ptr[1:] - g.ptr[:-1]).astype(np.int64)
    alive = np.ones(g.num_vertices, bool)
    while True:
        newly = np.flatnonzero(alive & (deg < k))
        if not newly.size:
            break
        alive[newly] = False
        np.add.at(deg, g.dst[_out_edges(g, newly)], -1)
    return alive.astype(np.int64)


def triangles_ref(g: CSRGraph, key: np.ndarray | None = None) -> np.ndarray:
    """Per-vertex triangle counts, each triangle attributed to its
    ``key``-minimum vertex (default: original id order; the engine uses
    placed order, so pass ``pg.place``).  g must be symmetric and
    deduped."""
    n = g.num_vertices
    key = np.arange(n) if key is None else np.asarray(key)
    adj = [set(g.dst[g.ptr[v]:g.ptr[v + 1]].tolist()) for v in range(n)]
    cnt = np.zeros(n, np.int64)
    for v in range(n):
        for u in adj[v]:
            if key[u] > key[v]:
                for w in adj[u]:
                    if key[w] > key[u] and w in adj[v]:
                        cnt[v] += 1
    return cnt


def spmv_ref(g: CSRGraph, x: np.ndarray) -> np.ndarray:
    """Push-mode SpMV: y[dst] += val * x[src]  (y = A^T x for a CSR by
    source)."""
    y = np.zeros(g.num_vertices, np.float64)
    np.add.at(y, g.dst, g.val.astype(np.float64) * x[_src(g)])
    return y


# Multiple of the error scale that spmv_f32_bound allows, set from the
# largest reading of error / scale on the R-MAT-22 main path
# (chip_smoke.py, x normal): 3.20 for the engine and 2.84 for numpy's
# float32 sum in edge order, so 8 leaves a margin of 2.5 (PERF.md).
SPMV_F32_C = 8.0


def spmv_f32_bound(g: CSRGraph, x: np.ndarray) -> np.ndarray:
    """Per-vertex limit on the error of a float32 evaluation of
    :func:`spmv_ref` in any order, for ``x`` of zero mean:
    ``SPMV_F32_C * u * sqrt(n * sum t^2)`` over the n terms t of a vertex,
    u = 2^-24.  With terms of random sign the partial sums of a vertex
    walk like sqrt(k) * rms(t), so the n roundings of its sum err by about
    u * n * rms(t), this scale.  That is sqrt(n) below the probabilistic
    bound lambda * sqrt(n) * u * sum |t| (Higham and Mary, SIAM J. Sci.
    Comput. 41(5), 2019), which holds for terms of any sign, and n below
    the worst case gamma_n * sum |t|, so one lost or doubled term of
    typical size shows even at the largest hub."""
    n = np.bincount(g.dst, minlength=g.num_vertices).astype(np.float64)
    t = g.val.astype(np.float64) * x[_src(g)]
    sq = np.bincount(g.dst, t * t, minlength=g.num_vertices)
    return SPMV_F32_C * 2.0 ** -24 * np.sqrt(n * sq)
