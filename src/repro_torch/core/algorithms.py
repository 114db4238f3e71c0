"""Host drivers for the paper workloads (port of ``repro.core.algorithms``).

Each driver initializes per-shard state in *placed* space on the
partition's device, runs its Program on the engine over
:class:`LocalComm` (T emulated tiles on one device), and maps the result
back to original vertex ids.  This slice ports :func:`bfs`; the other
workloads and the SPMD path follow (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.comm import LocalComm
from repro_torch.core.engine import (BFS, EngineConfig, GraphShard, Stats,
                                     init_state, run_engine)
from repro_torch.core.graph import CSRGraph, PartitionedGraph, \
    partition_graph
from repro_torch.core.program import INF, as_program


def real_mask(pg: PartitionedGraph) -> np.ndarray:
    """(T, v_chunk) bool — slots that hold a real (non-padding) vertex."""
    return (pg.inv >= 0).reshape(pg.T, pg.v_chunk)


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
    return (torch.from_numpy(value).to(pg.device),
            torch.from_numpy(frontier).to(pg.device))


def to_original(pg: PartitionedGraph, arr) -> np.ndarray:
    """(T, v_chunk) placed-space tensor -> (V,) numpy in original order."""
    flat = arr.detach().cpu().numpy().reshape(-1) \
        if isinstance(arr, torch.Tensor) else np.asarray(arr).reshape(-1)
    return flat[pg.place]


def local_engine_call(pg: PartitionedGraph, alg, cfg: EngineConfig,
                      value, frontier, acc=None):
    """Run ``alg`` over T emulated tiles on ``pg``'s device.  Returns
    ``(value, acc, stats)``."""
    prog = as_program(alg)
    comm = LocalComm(pg.T, pg.device)
    shard = GraphShard(pg.ptr_start, pg.deg, pg.edge_dst, pg.edge_val)
    st = init_state(comm, cfg, pg.v_chunk, value, frontier, prog, acc)
    st, stats = run_engine(comm, cfg, prog, shard, st, pg.e_chunk,
                           pg.v_chunk)
    return st.value, st.acc, stats


@dataclasses.dataclass
class Result:
    values: np.ndarray  # (V,) in original vertex order
    stats: Stats
    epochs: int = 1


def bfs(pg: PartitionedGraph, root: int,
        cfg: EngineConfig = EngineConfig()) -> Result:
    """Hop counts from ``root`` (unreachable = inf), on ``pg``'s device."""
    value, frontier = init_min_state(pg, [root])
    v, _, stats = local_engine_call(pg, BFS, cfg, value, frontier)
    out = to_original(pg, v).astype(np.float64)
    out[out >= np.float32(INF)] = np.inf
    return Result(out, stats)


def prepare(g: CSRGraph, T: int, scheme: str = "low_order",
            edge_mode: str = "equal_edges", device="cuda"
            ) -> PartitionedGraph:
    """Partition ``g`` over T tiles, with its shards on ``device``."""
    return partition_graph(g, T, scheme, edge_mode, device=device)
