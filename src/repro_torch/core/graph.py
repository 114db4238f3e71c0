"""Graph representation and partitioning (port of ``repro.core.graph``).

The host side is the reference's numpy code, unchanged: a CSR graph, the
R-MAT generator, the placement permutation and the segment-gather rebuild
of the placed CSR.  Only the outputs differ: the four dataset arrays of a
:class:`PartitionedGraph` are torch tensors on ``device`` (``"cuda"``
unless the caller asks for the CPU), with the reference's dtypes (int32
indices, float32 weights).

Edge modes: ``equal_edges`` (Dalorex: E/T adjacent edges per tile),
``vertex_aligned`` (Tesseract-like: a tile owns its own vertices' edges)
and ``die_aligned`` (the multi-die NoC's: each run of same-die tiles owns
its vertices' edges, so range messages never leave the die).  A
``*_dielocal`` placement switches ``equal_edges`` to ``die_aligned``.

:func:`partition_from_numpy` carries a partition across from the JAX
package (as numpy arrays), so both packages compute on identical shards.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.distribution import (DIELOCAL_SUFFIX, DistSpec,
                                           padded_len, placement)
from repro_torch.noc.topology import tile_die_map


@dataclasses.dataclass
class CSRGraph:
    """Host-side CSR; vertices 0..V-1; ptr has V+1 entries."""

    ptr: np.ndarray  # (V+1,) int64
    dst: np.ndarray  # (E,) int64
    val: np.ndarray  # (E,) float32

    @property
    def num_vertices(self) -> int:
        return len(self.ptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.dst)

    @staticmethod
    def from_edges(n: int, src: np.ndarray, dst: np.ndarray,
                   val: np.ndarray | None = None,
                   dedup: bool = True) -> "CSRGraph":
        if val is None:
            val = np.ones(len(src), np.float32)
        if dedup and len(src):
            key = src.astype(np.int64) * n + dst.astype(np.int64)
            _, idx = np.unique(key, return_index=True)
            src, dst, val = src[idx], dst[idx], val[idx]
        order = np.lexsort((dst, src))
        src, dst, val = src[order], dst[order], val[order]
        counts = np.bincount(src, minlength=n)
        ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return CSRGraph(ptr, dst.astype(np.int64), val.astype(np.float32))


@dataclasses.dataclass
class PartitionedGraph:
    """Device-resident shards; every tensor has a leading T axis.

    ``ptr_start[t, v]`` is the *global* placed edge index of local vertex
    v's first out-edge; ``deg`` its out-degree.  ``edge_dst`` holds
    *placed* dst vertex ids (-1 padding); ``edge_val`` the weights.
    ``place``/``inv`` stay numpy (host-side relabeling only).
    """

    T: int
    vdist: DistSpec  # placed-vertex space
    edist: DistSpec  # placed-edge space
    ptr_start: torch.Tensor  # (T, v_chunk) int32
    deg: torch.Tensor  # (T, v_chunk) int32
    edge_dst: torch.Tensor  # (T, e_chunk) int32
    edge_val: torch.Tensor  # (T, e_chunk) float32
    place: np.ndarray  # (V_orig,) original -> placed
    inv: np.ndarray  # (V_pad,) placed -> original (-1 pad)
    num_vertices: int  # original V
    num_edges: int  # original E
    edge_mode: str = "equal_edges"
    sorted_adj: bool = False  # per-vertex segments sorted by placed dst

    @property
    def v_chunk(self) -> int:
        return self.vdist.chunk

    @property
    def e_chunk(self) -> int:
        return self.edist.chunk

    @property
    def device(self) -> torch.device:
        return self.edge_dst.device


def partition_graph(g: CSRGraph, T: int, scheme: str = "low_order",
                    edge_mode: str = "equal_edges",
                    dies: tuple[int, int] | None = None,
                    tile_die: np.ndarray | None = None,
                    device="cuda") -> PartitionedGraph:
    """Place ``g``'s vertices with ``scheme`` and deal the shards over T
    tiles, as tensors on ``device``.  ``dies=(ndies_y, ndies_x)`` builds
    the tile -> die map of the ``*_dielocal`` schemes on the near-square
    grid the NoC uses by default; an explicit ``tile_die`` serves custom
    grids."""
    deg = (g.ptr[1:] - g.ptr[:-1]
           if scheme.startswith("degree_interleave") else None)
    if tile_die is None and dies is not None:
        tile_die = tile_die_map(T, 0, *dies)
    if scheme.endswith(DIELOCAL_SUFFIX) and edge_mode == "equal_edges":
        # die-resident partitions need die-resident edges, or range
        # messages chase drifted edge chunks across dies
        edge_mode = "die_aligned"
    place, inv = placement(g.num_vertices, T, scheme, deg=deg,
                           tile_die=tile_die)
    return build_partition(g, T, place, inv, edge_mode, tile_die=tile_die,
                           device=device)


def build_partition(g: CSRGraph, T: int, place: np.ndarray, inv: np.ndarray,
                    edge_mode: str = "equal_edges",
                    tile_die: np.ndarray | None = None,
                    device="cuda") -> PartitionedGraph:
    """Materialize the shards for an explicit ``(place, inv)`` pair: the
    reference's numpy segment gather (repeat + cumsum, no per-vertex
    loop), then one copy of each array to ``device``."""
    V, E = g.num_vertices, g.num_edges
    v_pad = len(inv)
    vdist = DistSpec(v_pad, T)

    deg_placed = np.zeros(v_pad, np.int64)
    orig_ok = inv >= 0
    deg_placed[orig_ok] = (g.ptr[1:] - g.ptr[:-1])[inv[orig_ok]]

    ok_p = np.nonzero(orig_ok)[0]          # placed slots with a real vertex
    o = inv[ok_p]                          # their original ids
    d = deg_placed[ok_p]
    within = np.arange(int(d.sum()), dtype=np.int64) \
        - np.repeat(np.cumsum(d) - d, d)   # 0..deg-1 inside each segment
    src_idx = np.repeat(g.ptr[o], d) + within

    if edge_mode == "equal_edges":
        new_ptr = np.concatenate([[0], np.cumsum(deg_placed)])
        e_pad = padded_len(max(E, 1), T)
        edist = DistSpec(e_pad, T)
        ptr_start = new_ptr[:-1]
    elif edge_mode == "vertex_aligned":
        # Each tile owns its vertices' edges; pad every tile to the max count.
        v_chunk = v_pad // T
        degs2 = deg_placed.reshape(T, v_chunk)
        e_chunk = int(padded_len(max(int(degs2.sum(1).max()), 1), 1))
        e_pad = e_chunk * T
        edist = DistSpec(e_pad, T)
        excl = np.cumsum(degs2, axis=1) - degs2  # per-tile exclusive prefix
        ptr_start = (np.arange(T, dtype=np.int64)[:, None] * e_chunk
                     + excl).reshape(-1)
    elif edge_mode == "die_aligned":
        # Equal-chunk scatter per run of consecutive same-die tiles: run r
        # (tiles t0..t1) owns edge chunks t0..t1, its vertices' edges laid
        # contiguously from chunk t0 with the padding at the run's tail,
        # so chunk t always belongs to tile t's die.
        if tile_die is None:
            raise ValueError("die_aligned edge mode needs dies=/tile_die=")
        v_chunk = v_pad // T
        td = np.asarray(tile_die, np.int64)
        deg_t = deg_placed.reshape(T, v_chunk).sum(1)
        run_id = np.concatenate([[0], np.cumsum(td[1:] != td[:-1])])
        run_len = np.bincount(run_id)
        run_edges = np.bincount(run_id, weights=deg_t).astype(np.int64)
        e_chunk = int(max(np.ceil(run_edges / run_len).max(), 1))
        e_pad = e_chunk * T
        edist = DistSpec(e_pad, T)
        # exclusive edge prefix per placed vertex, restarted at run starts
        cum = np.cumsum(deg_placed) - deg_placed
        _, run_first_tile = np.unique(run_id, return_index=True)
        base = run_first_tile[run_id[np.arange(v_pad) // v_chunk]]
        ptr_start = base * e_chunk + (cum - cum[base * v_chunk])
    else:
        raise ValueError(f"unknown edge_mode: {edge_mode}")
    edge_dst = np.full(e_pad, -1, np.int64)
    edge_val = np.zeros(e_pad, np.float32)
    dst_idx = np.repeat(ptr_start[ok_p], d) + within
    edge_dst[dst_idx] = place[g.dst[src_idx]]
    edge_val[dst_idx] = g.val[src_idx]

    v_chunk = v_pad // T
    e_chunk = edist.chunk
    return PartitionedGraph(
        T=T, vdist=vdist, edist=edist,
        ptr_start=_to(ptr_start.reshape(T, v_chunk), torch.int32, device),
        deg=_to(deg_placed.reshape(T, v_chunk), torch.int32, device),
        edge_dst=_to(edge_dst.reshape(T, e_chunk), torch.int32, device),
        edge_val=_to(edge_val.reshape(T, e_chunk), torch.float32, device),
        place=place, inv=inv, num_vertices=V, num_edges=E,
        edge_mode=edge_mode,
    )


def partition_from_numpy(ptr_start, deg, edge_dst, edge_val, place, inv,
                         num_vertices: int, num_edges: int,
                         edge_mode: str = "equal_edges",
                         sorted_adj: bool = False,
                         device="cuda") -> PartitionedGraph:
    """A port partition over given shard arrays — e.g. the JAX
    ``PartitionedGraph``'s, passed as numpy — so both packages run on the
    very same shards.  Shapes: (T, v_chunk) ``ptr_start``/``deg``,
    (T, e_chunk) ``edge_dst``/``edge_val``."""
    ptr_start = np.asarray(ptr_start)
    edge_dst = np.asarray(edge_dst)
    T, v_chunk = ptr_start.shape
    e_chunk = edge_dst.shape[1]
    return PartitionedGraph(
        T=T, vdist=DistSpec(T * v_chunk, T), edist=DistSpec(T * e_chunk, T),
        ptr_start=_to(ptr_start, torch.int32, device),
        deg=_to(np.asarray(deg), torch.int32, device),
        edge_dst=_to(edge_dst, torch.int32, device),
        edge_val=_to(np.asarray(edge_val), torch.float32, device),
        place=np.asarray(place, np.int64), inv=np.asarray(inv, np.int64),
        num_vertices=int(num_vertices), num_edges=int(num_edges),
        edge_mode=edge_mode, sorted_adj=sorted_adj)


def _to(a: np.ndarray, dtype, device) -> torch.Tensor:
    """numpy -> tensor of ``dtype`` on ``device``.  The narrowing happens
    on the host (as ``jnp.asarray(.., int32)`` does in the reference), so
    int64/float64 numpy never reaches the card."""
    np_dtype = np.int32 if dtype == torch.int32 else np.float32
    return torch.from_numpy(np.array(a, dtype=np_dtype, order="C")) \
        .to(device)


def rmat_edges(scale: int, edge_factor: int = 10, a: float = 0.57,
               b: float = 0.19, c: float = 0.19, seed: int = 0,
               weights: str = "uniform",
               ) -> tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """R-MAT generator (Kronecker) as used for the paper's synthetic
    datasets (Graph500 parameters a=.57 b=.19 c=.19 d=.05,
    ~edge_factor edges/vertex)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for bit in range(scale):
        r1 = rng.random(m)
        r2 = rng.random(m)
        src_bit = (r1 > a + b).astype(np.int64)
        # conditional probabilities per quadrant
        p_dst = np.where(src_bit == 0, b / (a + b),
                         (1 - (a + b + c)) / (1 - (a + b)))
        dst_bit = (r2 < p_dst).astype(np.int64)
        src |= src_bit << bit
        dst |= dst_bit << bit
    if weights == "uniform":
        val = rng.uniform(1.0, 10.0, m).astype(np.float32)
    else:
        val = np.ones(m, np.float32)
    return n, src, dst, val
