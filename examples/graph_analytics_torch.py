"""Graph analytics end to end on the PyTorch/CUDA port (``repro_torch``):
the five paper workloads under both sync modes, a NoC-topology table
(ideal crossbar, mesh, torus, ruche, hier) with per-link telemetry, the
task-graph workloads (k-core peeling, 2-hop triangle counting) and,
optionally, the flight recorder and query serving.  It is the port's
counterpart of ``examples/graph_analytics.py`` and asserts the same
checks against the host oracles, so a clean exit is a pass.

  PYTHONPATH=src python examples/graph_analytics_torch.py [--scale 11]
      [--preset rmat-hier] [--backend torch|kernels] [--noc hier]
      [--ndies-y 2 --ndies-x 2] [--placement low_order_dielocal]
      [--queries 32] [--trace run.json] [--device cpu]

The run is on the card unless ``--device cpu``.  ``--backend kernels``
(the port's default engine) launches the hand-written CUDA kernels, which
need the card; ``--backend torch`` runs the same rounds in plain PyTorch
ops, bitwise the same values.  ``--preset`` takes scale, tiles, edge
factor, backend, NoC, dies and placement from
``repro_torch.configs.dalorex_graph.PRESETS``; explicit flags override
it.
"""
import argparse
import dataclasses
import functools

import numpy as np

from repro_torch.configs.dalorex_graph import PRESETS
from repro_torch.core import algorithms as alg
from repro_torch.core import reference as ref
from repro_torch.core.engine import EngineConfig as _EngineConfig
from repro_torch.core.graph import CSRGraph, rmat_edges


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None)
    ap.add_argument("--scale", type=int, default=None)
    ap.add_argument("--tiles", type=int, default=None)
    ap.add_argument("--backend", choices=("torch", "kernels"), default=None)
    ap.add_argument("--noc", default=None,
                    choices=("ideal", "mesh", "torus", "ruche", "hier"))
    ap.add_argument("--ndies-y", type=int, default=None)
    ap.add_argument("--ndies-x", type=int, default=None)
    ap.add_argument("--placement", default=None,
                    choices=("low_order", "high_order",
                             "low_order_dielocal", "high_order_dielocal"))
    ap.add_argument("--edge-space", choices=("vmem", "hbm"), default=None,
                    help="memory space of the per-tile edge shard: hbm "
                         "streams it in windows, bitwise the same values "
                         "(triangles keeps its pinned vmem shard)")
    ap.add_argument("--queries", type=int, default=0,
                    help="also serve N batched BFS/SSSP queries as query "
                         "lanes and print a queries/s line")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="run the BFS row again with the flight recorder "
                         "on, write its Chrome/Perfetto JSON to PATH and "
                         "print the utilization summary")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    return ap.parse_args(argv)


def run_workloads(g, gs, root, tiles, placement, dies, device,
                  EngineConfig):
    """The five paper workloads under async and BSP, against the oracles."""
    print(f"{'app':10s} {'mode':6s} {'rounds':>7s} {'msgs':>9s} "
          f"{'spills':>7s} {'edges':>9s}  check")
    for mode in ("async", "bsp"):
        c = EngineConfig(mode=mode)
        pg = alg.prepare(g, tiles, scheme=placement, dies=dies,
                         device=device)
        pgs = alg.prepare(gs, tiles, scheme=placement, dies=dies,
                          device=device)
        for app in ("bfs", "sssp", "wcc", "pagerank", "spmv"):
            if app == "bfs":
                res = alg.bfs(pg, root, c)
                ok = (res.values == ref.bfs_ref(g, root)).all()
            elif app == "sssp":
                res = alg.sssp(pg, root, c)
                e = ref.sssp_ref(g, root)
                f = np.isfinite(e)
                ok = np.allclose(res.values[f], e[f], rtol=1e-5)
            elif app == "wcc":
                res = alg.wcc(pgs, c)
                ok = (res.values == ref.wcc_ref(gs)).all()
            elif app == "pagerank":  # keeps its barrier, as in the paper
                prc = EngineConfig(mode="bsp")
                if prc.adapt:
                    # adaptive preset: migrate at epoch boundaries from the
                    # recorder's busy cycles (repro_torch.place)
                    from repro_torch.place import adaptive_pagerank
                    prc = dataclasses.replace(prc, trace=True,
                                              trace_rounds=4096)
                    res, _, plans = adaptive_pagerank(g, pg, iters=8,
                                                      cfg=prc)
                    assert plans, "adapt preset applied no migration plan"
                else:
                    res = alg.pagerank(pg, iters=8, cfg=prc)
                ok = np.allclose(res.values, ref.pagerank_ref(g, iters=8),
                                 rtol=2e-3, atol=1e-7)
            else:
                x = np.random.default_rng(0).normal(
                    size=g.num_vertices).astype(np.float32)
                res = alg.spmv(pg, x, c)
                ok = np.allclose(res.values, ref.spmv_ref(g, x), rtol=2e-4,
                                 atol=1e-4)
            s = res.stats
            print(f"{app:10s} {mode:6s} {int(s.rounds):7d} "
                  f"{int(s.msgs.sum()):9d} {int(s.spills.sum()):7d} "
                  f"{int(s.edges_scanned):9d}  "
                  f"{'OK' if ok else 'FAIL'}")
            assert ok, app
            assert int(s.drops) == 0


def run_trace(g, root, tiles, placement, dies, device, EngineConfig, path,
              meta):
    """The async BFS again with the flight recorder on: bitwise the same
    values and cycles, its timeline written as Chrome/Perfetto JSON."""
    from repro_torch.trace import (format_summary, reconcile_cycles,
                                   summarize, write_perfetto)
    pg = alg.prepare(g, tiles, scheme=placement, dies=dies, device=device)
    cfg0 = EngineConfig(mode="async")
    base = alg.bfs(pg, root, cfg0)
    res = alg.bfs(pg, root, dataclasses.replace(cfg0, trace=True,
                                                trace_rounds=4096))
    assert (res.values == base.values).all() \
        and float(res.stats.cycles) == float(base.stats.cycles), \
        "the flight recorder must not perturb the run"
    rec = reconcile_cycles(res.trace, float(res.stats.cycles))
    doc = write_perfetto(res.trace, path, meta={"app": "bfs", **meta})
    print(f"\nflight recorder: bfs traced {int(res.stats.rounds)} rounds "
          f"-> {path} ({len(doc['traceEvents'])} events), cycle reconcile "
          f"exact={rec['exact']}")
    print(format_summary(summarize(res.trace)))


def run_fabrics(g, root, tiles, ndies, device, EngineConfig):
    """The same BFS on five fabrics (the hier rows with and without a
    die-local placement); uncapped links, so no message drops."""
    from repro_torch.noc import grid_shape
    from repro_torch.perf.model import die_crossing_frac
    rows_, cols_ = grid_shape(tiles)
    hnd = ndies if ndies != (1, 1) else (2, 2)
    print(f"\n{'noc':22s} {'rounds':>7s} {'spills':>7s} "
          f"{'max_link_occ':>13s} {'avg_hops':>9s} {'die_frac':>9s}")
    pg = alg.prepare(g, tiles, device=device)
    expect = ref.bfs_ref(g, root)
    fabrics = [("ideal", pg), ("mesh", pg), ("torus", pg), ("ruche", pg)]
    if rows_ % hnd[0] or cols_ % hnd[1]:
        print(f"(hier rows skipped: {rows_}x{cols_} grid not divisible "
              f"into {hnd[0]}x{hnd[1]} dies)")
    else:
        pg_dl = alg.prepare(g, tiles, scheme="low_order_dielocal", dies=hnd,
                            device=device)
        fabrics += [("hier", pg), ("hier+dielocal", pg_dl)]
    for name, pgx in fabrics:
        kind = name.split("+")[0]
        res = alg.bfs(pgx, root, EngineConfig(
            noc=kind, ndies_y=hnd[0] if kind == "hier" else 1,
            ndies_x=hnd[1] if kind == "hier" else 1))
        s = res.stats
        hist = np.asarray(s.hop_histogram.cpu())
        avg = (hist * np.arange(len(hist))).sum() / max(hist.sum(), 1)
        assert (res.values == expect).all() and int(s.drops) == 0
        print(f"{name:22s} {int(s.rounds):7d} "
              f"{int(s.spills.sum()):7d} "
              f"{int(s.max_link_occupancy):13d} {avg:9.2f} "
              f"{die_crossing_frac(s):9.2f}")


def run_serving(g, tiles, device, queries, EngineConfig):
    """``queries`` BFS and SSSP sources batched as query lanes: each
    record equal to its oracle, batching cheaper in rounds than solo."""
    from repro_torch.serve import Frontend
    pg = alg.prepare(g, tiles, device=device)
    deg = np.asarray(g.ptr[1:] - g.ptr[:-1])
    srcs = np.random.default_rng(0).choice(np.flatnonzero(deg > 0),
                                           size=queries)
    width = min(queries, 16)
    print(f"\nserving {queries} queries, {width} lanes (static batches, "
          f"burst arrivals)")
    print(f"{'app':10s} {'rounds':>7s} {'seq_rounds':>10s} {'qps':>12s} "
          f"{'pJ/query':>10s} {'lat_p95':>8s}  check")
    for app, rf in (("bfs", ref.bfs_ref), ("sssp", ref.sssp_ref)):
        rep = Frontend(pg, app=app, cfg=EngineConfig(), width=width) \
            .serve(srcs)
        ok = rep.drops == 0
        for rec in rep.records:
            e = rf(g, rec.source)
            f = np.isfinite(e)
            ok = ok and bool(np.allclose(rec.values[f], e[f], rtol=1e-5)) \
                and bool(np.isinf(rec.values[~f]).all())
        if queries > 1:  # batching must amortize rounds
            ok = ok and rep.total_rounds < rep.seq_rounds
        print(f"{app:10s} {rep.total_rounds:7d} {rep.seq_rounds:10d} "
              f"{rep.qps:12.1f} {rep.j_per_query * 1e12:10.1f} "
              f"{rep.latency_cycles(95):8.0f}  {'OK' if ok else 'FAIL'}")
        assert ok, app


def run_taskgraphs(gs, tiles, device, EngineConfig):
    """k-core peeling (another T3 fold) and 2-hop triangle counting (a
    4-channel chain) on the generic executor."""
    print(f"\n{'app':10s} {'rounds':>7s} {'msgs':>9s} {'result':>10s}  check")
    pgs = alg.prepare(gs, tiles, device=device)
    for k in (2, 3):
        res = alg.kcore(pgs, k, EngineConfig())
        ok = (res.values == ref.kcore_ref(gs, k)).all()
        s = res.stats
        print(f"{'kcore' + str(k):10s} {int(s.rounds):7d} "
              f"{int(s.msgs.sum()):9d} {int(res.values.sum()):10d}  "
              f"{'OK' if ok else 'FAIL'}")
        assert ok and int(s.drops) == 0
    pgt = alg.prepare_triangles(gs, tiles, device=device)
    # triangles pins its edge shard to vmem (the closing fold searches
    # the resident adjacency)
    res = alg.triangles(pgt, EngineConfig(edge_space="vmem"))
    ok = (res.values == ref.triangles_ref(gs, key=pgt.place)).all()
    s = res.stats
    print(f"{'triangles':10s} {int(s.rounds):7d} {int(s.msgs.sum()):9d} "
          f"{int(res.values.sum()):10d}  {'OK' if ok else 'FAIL'}")
    assert ok and int(s.drops) == 0
    print("per-channel msgs (range/wedge/range2/close):",
          s.msgs.cpu().tolist())


def main(argv=None):
    args = parse(argv)
    wl = PRESETS[args.preset] if args.preset else None

    def pick(flag, field, default):
        if flag is not None:
            return flag
        return getattr(wl, field) if wl else default

    scale = pick(args.scale, "scale", 11)
    tiles = pick(args.tiles, "tiles", 16)
    backend = pick(args.backend, "backend", "kernels")
    noc = pick(args.noc, "noc", "ideal")
    ndies = (args.ndies_y if args.ndies_y is not None else
             (wl.ndies[0] if wl else 1),
             args.ndies_x if args.ndies_x is not None else
             (wl.ndies[1] if wl else 1))
    placement = pick(args.placement, "placement", "low_order")
    dies = ndies if placement.endswith("_dielocal") else None
    ef = wl.edge_factor if wl else 10
    cfg_kw = dict(backend=backend, noc=noc, ndies_y=ndies[0],
                  ndies_x=ndies[1],
                  edge_space=pick(args.edge_space, "edge_space", "vmem"),
                  hbm_window=wl.hbm_window if wl else 0,
                  adapt=wl.adapt if wl else False,
                  adapt_every=wl.adapt_every if wl else 4,
                  adapt_budget=wl.adapt_budget if wl else 64)
    # size the queues from the engine's worst-case inflow when the grid
    # outgrows the defaults (the T = 64 hier presets); smaller grids keep
    # the defaults
    rangeq, burst = _EngineConfig(**cfg_kw).min_caps(tiles)
    cfg_kw["cap_rangeq"] = max(_EngineConfig.cap_rangeq,
                               1 << (rangeq - 1).bit_length())
    cfg_kw["cap_updq"] = max(_EngineConfig.cap_updq,
                             1 << (burst - 1).bit_length())
    EngineConfig = functools.partial(_EngineConfig, **cfg_kw)

    n, src, dst, val = rmat_edges(scale, edge_factor=ef, seed=1)
    g = CSRGraph.from_edges(n, src, dst, val)
    gs = alg.symmetrize(g)
    root = int(np.argmax(g.ptr[1:] - g.ptr[:-1]))
    print(f"V={g.num_vertices} E={g.num_edges} tiles={tiles} "
          f"backend={backend} noc={noc} ndies={ndies[0]}x{ndies[1]} "
          f"placement={placement} device={args.device}")
    run_workloads(g, gs, root, tiles, placement, dies, args.device,
                  EngineConfig)
    if args.trace:
        run_trace(g, root, tiles, placement, dies, args.device,
                  EngineConfig, args.trace,
                  {"noc": noc, "placement": placement, "tiles": tiles,
                   "scale": scale})
    run_fabrics(g, root, tiles, ndies, args.device, EngineConfig)
    if args.queries > 0:
        run_serving(g, tiles, args.device, args.queries, EngineConfig)
    run_taskgraphs(gs, tiles, args.device, EngineConfig)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
