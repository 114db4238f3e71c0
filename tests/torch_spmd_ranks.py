"""The runs of ``tests/test_torch_spmd.py``, and the program of one rank.

    python tests/torch_spmd_ranks.py CASE DIR RANK WORLD

joins a gloo process group of WORLD processes through a file store in DIR
(no port is opened), runs CASE's runs on a CPU mesh, and writes what
they return, as numpy, to ``DIR/CASE.rankRANK.pkl``.  The test runs the
same functions with ``mesh=None`` (the emulated tiles) in its own
process.  Imports no JAX: only the port.
"""
from __future__ import annotations

import dataclasses
import functools
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import place as tp
from repro_torch.core import algorithms as ta
from repro_torch.core.comm import (AxisComm, LaneAxisComm, LaneComm,
                                   LocalComm, mesh_axis)
from repro_torch.core.embedding import (ids_block, place_table,
                                        routed_embed, table_shard)
from repro_torch.core.engine import EngineConfig
from repro_torch.core.graph import CSRGraph, rmat_edges
from repro_torch.launch.mesh import auto_mesh, make_host_mesh
from repro_torch.place.plan import MigrationPlan
from repro_torch.serve import Frontend, multi_source

WORLD = 4  # T: one tile a rank
# tests/test_spmd.py's knobs; the task-graph programs' deeper queues
SMALL = dict(f_pop=8, r_pop=8, u_pop=16, max_t2=8, cap_route_range=8,
             cap_route_update=32, cap_rangeq=128, cap_updq=4096,
             max_rounds=5000)
PROGRAMS = dict(SMALL, cap_rangeq=1024, cap_updq=8192)
PATHS = {"torch": dict(backend="torch", fuse=False),
         "unfused": dict(backend="kernels", fuse=False),
         "fused": dict(backend="kernels", fuse=True)}
EMBED = dict(V=64, d=16, B=4, S=32, M=2, seed=0)


# --------------------------------------------------------------------------
# Inputs, made from seeds with numpy.
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def graph(name: str) -> CSRGraph:
    """"g": R-MAT-7 (tests/test_spmd.py's graph, unit weights so that the
    PageRank sums stay representable); "sym": symmetrized R-MAT-6
    (tests/test_programs.py's); "dyadic": "g" with each vertex's
    out-edges cut to the largest power of two (tests/test_place.py's
    exact PageRank instance)."""
    if name == "sym":
        n, src, dst, val = rmat_edges(6, edge_factor=5, seed=4)
        return ta.symmetrize(CSRGraph.from_edges(n, src, dst, val))
    n, src, dst, _ = rmat_edges(7, edge_factor=5, seed=3)
    g = CSRGraph.from_edges(n, src, dst, None)
    if name == "dyadic":
        deg = g.ptr[1:] - g.ptr[:-1]
        keep = np.zeros(g.num_edges, bool)
        for v in np.flatnonzero(deg):
            keep[g.ptr[v]:g.ptr[v] + (1 << (int(deg[v]).bit_length() - 1))] \
                = True
        src = np.repeat(np.arange(n), deg)[keep]
        g = CSRGraph.from_edges(n, src, g.dst[keep], None, dedup=False)
    return g


def root(g: CSRGraph) -> int:
    return int(np.argmax(g.ptr[1:] - g.ptr[:-1]))


def spmv_x(g: CSRGraph) -> np.ndarray:
    return np.random.default_rng(0).normal(size=g.num_vertices) \
        .astype(np.float32)


def sources(g: CSRGraph) -> np.ndarray:
    """tests/test_serve.py's batch: 5 drawn sources and a padding lane."""
    deg = g.ptr[1:] - g.ptr[:-1]
    srcs = np.random.default_rng(0).choice(np.flatnonzero(deg > 0), size=5)
    return np.concatenate([srcs, [-1]])


def plan(pg) -> MigrationPlan:
    """tests/test_place.py's drawn plan: 8 disjoint slot swaps."""
    slots = np.random.default_rng(11).choice(len(pg.inv), 16, replace=False)
    return MigrationPlan(pairs=slots.reshape(8, 2).astype(np.int64))


@functools.lru_cache(maxsize=None)
def partition(name: str, kind: str = "plain"):
    g = graph(name)
    if kind == "triangles":
        return ta.prepare_triangles(g, WORLD, device="cpu")
    pg = ta.prepare(g, WORLD, device="cpu")
    if kind == "migrated":
        pg = tp.apply_plan(g, pg, plan(pg))
    return pg


def embed_inputs():
    """The placed table, the table and the ids of the routed lookup."""
    rng = np.random.default_rng(EMBED["seed"])
    table = rng.normal(size=(EMBED["V"], EMBED["d"])).astype(np.float32)
    ids = rng.integers(0, EMBED["V"], (EMBED["B"], EMBED["S"]))
    return place_table(table, EMBED["M"]), table, ids


def overflow_inputs():
    """tests/test_integration_extra.py's overflow case: an (8, 4) table and
    6 ids, all row 0, as one (1, 6) block."""
    table = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    return table, np.zeros((1, 6), np.int64)


def comm_inputs(dtype: str, rows: int):
    """A (rows, T * 3, 2) tensor of ``dtype`` from a seed (row r is tile r
    % T's); among the floats signed zeros, NaN of either sign, a column
    whose sum over the tiles depends on their order (1e8, 1, -1e8, 1: 1
    in tile order) and one of -0.0 on every tile."""
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(rows, WORLD * 3, 2)).astype(np.float32) * 5
    if dtype == "float32":
        x[0, :3] = np.float32(-0.0)
        x[1, :3] = np.float32(0.0)
        x[2, 3] = np.float32("nan")
        x[3, 4] = -np.float32("nan")
        x[:, 5, 0] = np.tile(np.float32([1e8, 1, -1e8, 1]), rows // WORLD)
        x[:, 6, 0] = np.float32(-0.0)
        return torch.from_numpy(x)
    if dtype == "bool":
        return torch.from_numpy(x > 0)
    return torch.from_numpy(x).to(torch.int32)


COLLECTIVES = ("a2a", "psum", "pmax", "all_gather", "to_global")
DTYPES = ("int32", "bool", "float32")
LANES = 3


def collectives(comm, x):
    """Each collective of ``comm`` on ``x`` (a global reduction too)."""
    out = {f: getattr(comm, f)(x) for f in COLLECTIVES[:4]}
    out["to_global"] = comm.to_global(comm.psum(x))
    return out


def my_rows(rank: int, lanes: int = 0):
    """This rank's rows of a LocalComm tensor (lanes = 0) or of a LaneComm
    one of ``lanes`` lanes."""
    if not lanes:
        return [rank]
    return [b * WORLD + rank for b in range(lanes)]


# --------------------------------------------------------------------------
# The runs: each takes the mesh (None: the emulated tiles) and returns
# numpy.
# --------------------------------------------------------------------------

def host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: host(v) for f, v in zip(x._fields, x)}
    return x


def result(res) -> dict:
    """A Result or BatchResult as numpy."""
    out = {f.name: host(getattr(res, f.name))
           for f in dataclasses.fields(res)}
    return out


def report(rep) -> dict:
    """A ServeReport: its row and each record's fields but the port's ring
    (the reference's records have none; the trace is off here)."""
    return {"row": rep.row(),
            "records": [{k: v for k, v in dataclasses.asdict(r).items()
                         if k != "trace"} for r in rep.records]}


def cfg_of(knobs, path, **kw):
    return EngineConfig(**knobs, **PATHS[path], **kw)


def app_runs(path):
    g = graph("g")

    def runs(mesh):
        pg = partition("g")
        cfg = cfg_of(SMALL, path)
        return {
            "bfs": result(ta.bfs(pg, root(g), cfg, mesh=mesh)),
            "sssp": result(ta.sssp(pg, root(g), cfg, mesh=mesh)),
            "spmv": result(ta.spmv(pg, spmv_x(g), cfg, mesh=mesh)),
            "pagerank": result(ta.pagerank(pg, iters=2, cfg=cfg,
                                           mesh=mesh)),
            "bfs-bsp": result(ta.bfs(pg, root(g), cfg_of(
                SMALL, path, mode="bsp"), mesh=mesh)),
        }
    return runs


def noc_runs(mesh):
    """BFS on the mesh (fused) and the torus (torch) at ``link_cap=2``,
    the flight recorder on: the claims' all-gather, the pressure of each
    tile's own lines, the spills at the waypoints and the link classes."""
    g, pg = graph("g"), partition("g")
    return {f"{noc} {path}": result(ta.bfs(pg, root(g), cfg_of(
        SMALL, path, noc=noc, link_cap=2, trace=True, trace_rounds=64),
        mesh=mesh)) for noc, path in (("mesh", "fused"), ("torus", "torch"))}


def program_runs(mesh):
    g = graph("sym")
    out = {"wcc": result(ta.wcc(partition("sym"), cfg_of(SMALL, "fused"),
                                mesh=mesh))}
    for path in ("torch", "unfused", "fused"):
        cfg = cfg_of(PROGRAMS, path)
        out[f"kcore {path}"] = result(ta.kcore(partition("sym"), 3, cfg,
                                               mesh=mesh))
        out[f"triangles {path}"] = result(ta.triangles(
            partition("sym", "triangles"), cfg, mesh=mesh))
    assert g.num_vertices > 0
    return out


def memspace_trace_runs(mesh):
    g, pg = graph("g"), partition("g")
    out = {}
    for path in ("torch", "unfused", "fused"):
        out[f"hbm {path}"] = result(ta.bfs(pg, root(g), cfg_of(
            SMALL, path, edge_space="hbm"), mesh=mesh))
    for mode, path in (("async", "fused"), ("bsp", "unfused")):
        out[f"trace {mode} {path}"] = result(ta.bfs(pg, root(g), cfg_of(
            SMALL, path, mode=mode, trace=True, trace_rounds=64),
            mesh=mesh))
    return out


def serve_runs(mesh):
    g, pg = graph("g"), partition("g")
    srcs = sources(g)
    out = {}
    for path in ("torch", "fused"):
        out[f"lanes {path}"] = result(multi_source(
            pg, "bfs", srcs, cfg_of(SMALL, path, trace=True,
                                    trace_rounds=64), mesh=mesh))
    out["lanes sssp unfused"] = result(multi_source(
        pg, "sssp", srcs[:3], cfg_of(SMALL, "unfused"), mesh=mesh))
    out["frontend"] = report(Frontend(
        pg, app="bfs", cfg=cfg_of(SMALL, "fused"), width=4,
        mesh=mesh).serve(srcs[:-1]))
    return out


def place_runs(mesh):
    g, pg1 = graph("g"), partition("g", "migrated")
    out = {f"migrated {path}": result(ta.bfs(pg1, root(g),
                                             cfg_of(SMALL, path), mesh=mesh))
           for path in ("torch", "fused")}
    gd = graph("dyadic")
    kw = dict(SMALL, adapt=True, adapt_every=1, adapt_budget=16,
              trace=True, trace_rounds=256)
    res, final, plans = tp.adaptive_pagerank(
        gd, ta.prepare(gd, WORLD, device="cpu"), damping=0.5, iters=3,
        cfg=cfg_of(kw, "fused"), mesh=mesh)
    out["adaptive pagerank"] = dict(
        result(res), plans=[p.pairs for p in plans],
        place=np.asarray(final.place))
    return out


def comm_runs(mesh):
    """Each collective of the SPMD comms on every dtype, this rank's rows
    (the test holds them against LocalComm / LaneComm on the whole
    tensor); and the routed lookup on a (2, 2) mesh."""
    if mesh is None:
        return {}
    group, size, rank, dev = mesh_axis(mesh, "x")
    out = {}
    for dt in DTYPES:
        x = comm_inputs(dt, WORLD)
        out[f"axis {dt}"] = {k: host(v) for k, v in collectives(
            AxisComm(group, size, rank, dev), x[my_rows(rank)]).items()}
        x = comm_inputs(dt, LANES * WORLD)
        out[f"lanes {dt}"] = {k: host(v) for k, v in collectives(
            LaneAxisComm(group, size, LANES, rank, dev),
            x[my_rows(rank, LANES)]).items()}
    placed, _, ids = embed_inputs()
    mesh2 = make_host_mesh(2, 2)
    emb, ovf = routed_embed(table_shard(torch.from_numpy(placed), mesh2),
                            ids_block(torch.from_numpy(ids), mesh2),
                            mesh=mesh2, capacity_factor=4.0)
    out["embed"] = {"emb": host(emb), "overflow": int(ovf),
                    "data": mesh2.get_local_rank("data"),
                    "model": mesh2.get_local_rank("model")}
    # overflow: 6 ids of row 0 into one shard (a (4, 1) mesh: M = 1) at
    # capacity int(6 * 0.34) = 2
    table, ids = overflow_inputs()
    emb, ovf = routed_embed(torch.from_numpy(table), torch.from_numpy(ids),
                            mesh=make_host_mesh(WORLD, 1),
                            capacity_factor=0.34)
    out["overflow"] = {"emb": host(emb), "overflow": int(ovf)}
    return out


def local_collectives(dt: str, lanes: int = 0):
    """The emulated comms' collectives on the whole tensor."""
    x = comm_inputs(dt, (lanes or 1) * WORLD)
    comm = LaneComm(WORLD, lanes) if lanes else LocalComm(WORLD)
    return {k: host(v) for k, v in collectives(comm, x).items()}


CASES = {
    "apps torch": app_runs("torch"),
    "apps unfused": app_runs("unfused"),
    "apps fused": app_runs("fused"),
    "noc": noc_runs,
    "programs": program_runs,
    "memspace trace": memspace_trace_runs,
    "serve": serve_runs,
    "place": place_runs,
    "comm": comm_runs,
}


def main():
    case, out_dir = sys.argv[1], Path(sys.argv[2])
    rank, world = int(sys.argv[3]), int(sys.argv[4])
    torch.set_num_threads(1)
    store = out_dir / f"store-{case.replace(' ', '-')}"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        out = CASES[case](auto_mesh((world,), ("x",), device_type="cpu"))
    finally:
        dist.destroy_process_group()
    name = f"{case.replace(' ', '-')}.rank{rank}.pkl"
    (out_dir / name).write_bytes(pickle.dumps(out))


if __name__ == "__main__":
    main()
