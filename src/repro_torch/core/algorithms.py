"""Host drivers for the paper workloads (port of ``repro.core.algorithms``).

Each driver initializes per-shard state in *placed* space on the
partition's device, runs its Program on the engine over
:class:`LocalComm` (T emulated tiles on one device), and maps the result
back to original vertex ids.  The five paper workloads (BFS, SSSP,
PageRank, WCC, SpMV) run the classic 3-task program; :func:`kcore` runs
the peel program and :func:`triangles` the 4-channel 2-hop chain over a
:func:`prepare_triangles` partition.  The SPMD path is a later slice
(ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.comm import LocalComm
from repro_torch.core.engine import (BFS, EngineConfig, GraphShard, Stats,
                                     init_state, run_engine, zero_stats)
from repro_torch.core.graph import CSRGraph, PartitionedGraph, \
    partition_graph
from repro_torch.core.program import (INF, PAGERANK, SPMV, SSSP, TRIANGLES,
                                      WCC, as_program, kcore_program,
                                      sized_cfg)


# --------------------------------------------------------------------------
# State initialization in placed space (numpy on the host, then one copy to
# the partition's device).
# --------------------------------------------------------------------------

def real_mask(pg: PartitionedGraph) -> np.ndarray:
    """(T, v_chunk) bool — slots that hold a real (non-padding) vertex."""
    return (pg.inv >= 0).reshape(pg.T, pg.v_chunk)


def _dev(pg: PartitionedGraph, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(pg.device)
                 for a in arrays)


def _host_deg(pg: PartitionedGraph) -> np.ndarray:
    return pg.deg.cpu().numpy()


def init_min_state(pg: PartitionedGraph, roots: list[int]):
    """value = float32 max ("unreached") except roots (= 0); frontier =
    roots.  Tensors on the partition's device."""
    value = np.full((pg.T, pg.v_chunk), np.float32(INF))
    frontier = np.zeros((pg.T, pg.v_chunk), bool)
    for r in roots:
        p = int(pg.place[r])
        t, l = p // pg.v_chunk, p % pg.v_chunk
        value[t, l] = 0.0
        frontier[t, l] = True
    return _dev(pg, value, frontier)


def init_wcc_state(pg: PartitionedGraph):
    """Label = original vertex id; every real vertex starts in the
    frontier."""
    inv = pg.inv.reshape(pg.T, pg.v_chunk)
    value = np.where(inv >= 0, inv, np.float32(INF)).astype(np.float32)
    return _dev(pg, value, inv >= 0)


def init_add_state(pg: PartitionedGraph, x: np.ndarray):
    """value = x scattered to placed slots; frontier = real vertices with
    out-edges (vertices with deg 0 emit nothing)."""
    flat = np.zeros(pg.T * pg.v_chunk, np.float32)
    flat[pg.place] = x.astype(np.float32)
    frontier = real_mask(pg) & (_host_deg(pg) > 0)
    return _dev(pg, flat.reshape(pg.T, pg.v_chunk), frontier)


def init_kcore_state(pg: PartitionedGraph, k: int):
    """value = remaining degree; acc = removed flag (1 = out of the core);
    the initially dead vertices (deg < k, and padding) seed the frontier
    so their decrements propagate."""
    real = real_mask(pg)
    deg = _host_deg(pg)
    value = np.where(real, deg, 0).astype(np.float32)
    dead0 = real & (deg < k)
    acc = np.where(real & ~dead0, 0.0, 1.0).astype(np.float32)
    return _dev(pg, value, dead0, acc)


def init_triangles_state(pg: PartitionedGraph):
    """value = 0 (unused); every real vertex with edges seeds the
    frontier."""
    value = np.zeros((pg.T, pg.v_chunk), np.float32)
    return _dev(pg, value, real_mask(pg) & (_host_deg(pg) > 0))


def to_original(pg: PartitionedGraph, arr) -> np.ndarray:
    """(T, v_chunk) placed-space tensor -> (V,) numpy in original order."""
    flat = arr.detach().cpu().numpy().reshape(-1) \
        if isinstance(arr, torch.Tensor) else np.asarray(arr).reshape(-1)
    return flat[pg.place]


# --------------------------------------------------------------------------
# Engine invocation.
# --------------------------------------------------------------------------

def local_engine_call(pg: PartitionedGraph, alg, cfg: EngineConfig,
                      value, frontier, acc=None):
    """Run ``alg`` over T emulated tiles on ``pg``'s device.  Returns
    ``(value, acc, stats, trace)``; ``trace`` is the flight recorder's
    ring when ``cfg.trace``, else None."""
    prog = as_program(alg)
    comm = LocalComm(pg.T, pg.device)
    shard = GraphShard(pg.ptr_start, pg.deg, pg.edge_dst, pg.edge_val)
    st = init_state(comm, cfg, pg.v_chunk, value, frontier, prog, acc)
    st, stats, trace = run_engine(comm, cfg, prog, shard, st, pg.e_chunk,
                                  pg.v_chunk)
    return st.value, st.acc, stats, trace


# --------------------------------------------------------------------------
# Workload drivers.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Result:
    values: np.ndarray  # (V,) in original vertex order
    stats: Stats
    epochs: int = 1
    trace: object = None  # TraceBuf when cfg.trace, else None


def _distances(pg, v) -> np.ndarray:
    out = to_original(pg, v).astype(np.float64)
    out[out >= np.float32(INF)] = np.inf
    return out


def bfs(pg: PartitionedGraph, root: int,
        cfg: EngineConfig = EngineConfig()) -> Result:
    """Hop counts from ``root`` (unreachable = inf), on ``pg``'s device."""
    value, frontier = init_min_state(pg, [root])
    v, _, stats, trace = local_engine_call(pg, BFS, cfg, value, frontier)
    return Result(_distances(pg, v), stats, trace=trace)


def sssp(pg: PartitionedGraph, root: int,
         cfg: EngineConfig = EngineConfig()) -> Result:
    """Float32 path lengths from ``root`` (unreachable = inf)."""
    value, frontier = init_min_state(pg, [root])
    v, _, stats, trace = local_engine_call(pg, SSSP, cfg, value, frontier)
    return Result(_distances(pg, v), stats, trace=trace)


def wcc(pg: PartitionedGraph, cfg: EngineConfig = EngineConfig()) -> Result:
    """Label propagation to the min original id (graph must be
    symmetric)."""
    value, frontier = init_wcc_state(pg)
    v, _, stats, trace = local_engine_call(pg, WCC, cfg, value, frontier)
    return Result(to_original(pg, v).astype(np.int64), stats, trace=trace)


def spmv(pg: PartitionedGraph, x: np.ndarray,
         cfg: EngineConfig = EngineConfig()) -> Result:
    """Push-mode y[dst] += val * x[src] — one engine epoch."""
    value, frontier = init_add_state(pg, x)
    _, acc, stats, trace = local_engine_call(pg, SPMV, cfg, value,
                                             frontier)
    return Result(to_original(pg, acc).astype(np.float64), stats,
                  trace=trace)


def pagerank(pg: PartitionedGraph, damping: float = 0.85, iters: int = 20,
             tol: float = 0.0, cfg: EngineConfig = EngineConfig()
             ) -> Result:
    """Epoch-synchronized PageRank (the paper keeps the barrier for PR).

    Each epoch is one engine run (push contributions, accumulate).  The
    rank update and the dangling redistribution between epochs stay numpy
    on the host, the reference's very expression, so the sums keep its
    order; ``acc`` is read back once per epoch.
    """
    V = pg.num_vertices
    real = real_mask(pg)
    deg = _host_deg(pg)
    rank = np.where(real, np.float32(1.0 / V), 0.0).astype(np.float32)
    total = zero_stats(cfg, pg.T, PAGERANK, pg.device)
    epochs = 0
    trace = None  # the LAST epoch's ring (each epoch restarts the engine)
    for _ in range(iters):
        value, frontier = _dev(pg, rank, real & (deg > 0))
        _, acc, stats, trace = local_engine_call(pg, PAGERANK, cfg, value,
                                                 frontier)
        acc = acc.cpu().numpy()
        dangling = rank[real & (deg == 0)].sum()
        new_rank = np.where(
            real, (1 - damping) / V + damping * (acc + dangling / V),
            0.0).astype(np.float32)
        diff = np.abs(new_rank - rank).sum()
        rank = new_rank
        total = _acc_stats(total, stats)
        epochs += 1
        if tol and diff < tol:
            break
    return Result(to_original(pg, rank).astype(np.float64), total, epochs,
                  trace=trace)


def kcore(pg: PartitionedGraph, k: int,
          cfg: EngineConfig = EngineConfig()) -> Result:
    """k-core membership by peeling (graph must be symmetric, deduped):
    values[v] = 1 if v survives in the k-core, else 0."""
    value, frontier, acc = init_kcore_state(pg, k)
    _, a, stats, trace = local_engine_call(pg, kcore_program(int(k)), cfg,
                                           value, frontier, acc)
    return Result((to_original(pg, a) == 0.0).astype(np.int64), stats,
                  trace=trace)


def sort_adjacency(pg: PartitionedGraph) -> PartitionedGraph:
    """Sort every per-vertex edge segment by placed destination id (the
    reference's per-tile ``lexsort``, as one sort keyed by tile first)."""
    T, e_chunk, v_chunk = pg.T, pg.e_chunk, pg.v_chunk
    dst = pg.edge_dst.cpu().numpy()
    val = pg.edge_val.cpu().numpy()
    degs = _host_deg(pg).astype(np.int64)
    totals = degs.sum(axis=1)
    # each tile's first `total` slots hold its vertices' segments in order;
    # the rest sort last
    seg = np.full((T, e_chunk), np.iinfo(np.int64).max, np.int64)
    owner = np.repeat(np.tile(np.arange(v_chunk), T), degs.reshape(-1))
    within = np.arange(int(totals.sum())) - np.repeat(
        np.cumsum(totals) - totals, totals)
    seg[np.repeat(np.arange(T), totals), within] = owner
    tile = np.repeat(np.arange(T), e_chunk)
    order = np.lexsort((dst.reshape(-1), seg.reshape(-1), tile))
    dst_t, val_t = _dev(pg, dst.reshape(-1)[order].reshape(T, e_chunk),
                        val.reshape(-1)[order].reshape(T, e_chunk))
    return dataclasses.replace(pg, edge_dst=dst_t, edge_val=val_t,
                               sorted_adj=True)


def prepare_triangles(g: CSRGraph, T: int, scheme: str = "low_order",
                      device="cuda") -> PartitionedGraph:
    """Partition for triangle counting: vertex-aligned edges (each tile
    owns its vertices' full adjacency) with every per-vertex segment
    sorted by placed destination, so the closing-edge check is a local
    binary search.  ``g`` must be symmetric and deduplicated (use
    :func:`symmetrize`)."""
    return sort_adjacency(partition_graph(g, T, scheme,
                                          edge_mode="vertex_aligned",
                                          device=device))


def triangles(pg: PartitionedGraph,
              cfg: EngineConfig = EngineConfig()) -> Result:
    """2-hop triangle counting on a :func:`prepare_triangles` partition:
    values[v] = number of triangles whose placed-minimum vertex is v."""
    if not (pg.edge_mode == "vertex_aligned" and pg.sorted_adj):
        raise ValueError(
            "triangles() needs a prepare_triangles partition (vertex-aligned "
            f"edges, sorted segments); got edge_mode={pg.edge_mode!r}, "
            f"sorted_adj={pg.sorted_adj}")
    cfg = sized_cfg(cfg, TRIANGLES, pg.T)
    value, frontier = init_triangles_state(pg)
    _, a, stats, trace = local_engine_call(pg, TRIANGLES, cfg, value,
                                           frontier)
    return Result(to_original(pg, a).astype(np.int64), stats, trace=trace)


def _acc_stats(a: Stats, b: Stats) -> Stats:
    """Combine per-epoch Stats: counters add, peaks take the max.  Raises
    on mismatched shapes (Stats of another NoC backend or program)."""
    for name, x, y in zip(Stats._fields, a, b):
        if x.shape != y.shape:
            raise ValueError(
                f"Stats.{name} shape mismatch {tuple(x.shape)} vs "
                f"{tuple(y.shape)}: accumulating stats from different NoC "
                f"backends/programs? Use zero_stats(cfg, T, alg, device).")
    merged = Stats(*(x + y for x, y in zip(a, b)))
    return merged._replace(max_link_occupancy=torch.maximum(
        a.max_link_occupancy, b.max_link_occupancy))


# --------------------------------------------------------------------------
# Convenience: partition, symmetrize.
# --------------------------------------------------------------------------

def symmetrize(g: CSRGraph) -> CSRGraph:
    src = np.repeat(np.arange(g.num_vertices), g.ptr[1:] - g.ptr[:-1])
    s2 = np.concatenate([src, g.dst])
    d2 = np.concatenate([g.dst, src])
    v2 = np.concatenate([g.val, g.val])
    return CSRGraph.from_edges(g.num_vertices, s2, d2, v2, dedup=True)


def prepare(g: CSRGraph, T: int, scheme: str = "low_order",
            edge_mode: str = "equal_edges",
            dies: tuple[int, int] | None = None, device="cuda"
            ) -> PartitionedGraph:
    """Partition ``g`` over T tiles, with its shards on ``device``.
    ``dies=(ndies_y, ndies_x)`` is required by the ``*_dielocal`` schemes
    and must match the hier NoC's ``EngineConfig.ndies_y/ndies_x`` for the
    partitions to be die-resident on the fabric that runs them."""
    return partition_graph(g, T, scheme, edge_mode, dies=dies,
                           device=device)
