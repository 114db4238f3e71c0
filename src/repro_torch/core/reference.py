"""Numpy oracles for the port (``repro.core.reference`` semantics).

:func:`bfs_ref` is level-synchronous over CSR segments instead of the
reference's per-edge Python loop, so it answers in seconds on an R-MAT-22
graph (41 M edges) where the loop would take minutes.  BFS hop counts do
not depend on visiting order, so both give the same array.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import CSRGraph


def bfs_ref(g: CSRGraph, root: int) -> np.ndarray:
    """Hop counts from root; unreachable = +inf."""
    dist = np.full(g.num_vertices, np.inf, np.float64)
    dist[root] = 0
    frontier = np.array([root], np.int64)
    d = 0
    while frontier.size:
        start = g.ptr[frontier]
        deg = g.ptr[frontier + 1] - start
        # every out-edge of the level, as one flat gather
        within = np.arange(int(deg.sum()), dtype=np.int64) \
            - np.repeat(np.cumsum(deg) - deg, deg)
        nbr = g.dst[np.repeat(start, deg) + within]
        nbr = np.unique(nbr[dist[nbr] == np.inf])
        dist[nbr] = d + 1
        frontier, d = nbr, d + 1
    return dist
