"""Flight-recorder CLI (port of ``python -m repro.trace``): run a preset
workload with the trace on, then summarize it or export it for
ui.perfetto.dev.

  python -m repro_torch.trace summarize [--preset rmat-small]
      [--app bfs] [--scale N --tiles T] [--noc mesh] [--placement ...]
      [--trace-every k --trace-rounds R] [--backend torch|kernels]
      [--device cuda|cpu]
  python -m repro_torch.trace export --out run.perfetto.json
      [--jsonl run.jsonl] [same run flags]

``summarize`` prints the utilization / work-imbalance / queue-depth table
(overall, per phase, per channel).  ``export`` writes the Chrome/Perfetto
trace JSON (and optionally the JSONL round stream) and reconciles the
trace's cycle timeline against the run's ``Stats.cycles``: exact (bitwise)
whenever the ring held every round.  The run's queue capacities are raised
to the program's worst-case inflow on the preset's grid
(:func:`~repro_torch.core.program.sized_cfg`), so the T = 64 presets on a
physical fabric run with the default knobs.  The run is on ``--device``
(the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.trace",
        description="capture + inspect a flight-recorder trace")
    ap.add_argument("cmd", choices=("summarize", "export"))
    ap.add_argument("--preset", default="rmat-small",
                    help="repro_torch.configs.dalorex_graph preset naming "
                         "the graph/tiles/noc shape (flags below override)")
    ap.add_argument("--app", default="bfs",
                    choices=("bfs", "sssp", "wcc", "pagerank", "spmv"))
    ap.add_argument("--scale", type=int, default=None)
    ap.add_argument("--tiles", type=int, default=None)
    ap.add_argument("--backend", choices=("torch", "kernels"), default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    ap.add_argument("--noc", default=None,
                    choices=("ideal", "mesh", "torus", "ruche", "hier"))
    ap.add_argument("--ndies-y", type=int, default=None)
    ap.add_argument("--ndies-x", type=int, default=None)
    ap.add_argument("--placement", default=None,
                    choices=("low_order", "high_order",
                             "low_order_dielocal", "high_order_dielocal"))
    ap.add_argument("--mode", choices=("async", "bsp"), default="async")
    ap.add_argument("--trace-every", type=int, default=1)
    ap.add_argument("--trace-rounds", type=int, default=4096)
    ap.add_argument("--out", default=None,
                    help="export: Perfetto JSON path "
                         "(default <app>.perfetto.json)")
    ap.add_argument("--jsonl", default=None,
                    help="export: also write the per-round JSONL stream")
    return ap


def traced_run(args):
    """One traced engine run per the CLI flags; returns
    ``(result, cfg, meta)`` where ``result.trace`` is the TraceBuf."""
    from repro_torch.configs.dalorex_graph import PRESETS
    from repro_torch.core import algorithms as alg
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.graph import CSRGraph, rmat_edges
    from repro_torch.core.program import BFS, as_program, sized_cfg

    wl = PRESETS[args.preset]
    scale = args.scale if args.scale is not None else wl.scale
    tiles = args.tiles if args.tiles is not None else wl.tiles
    backend = args.backend if args.backend is not None else wl.backend
    noc = args.noc if args.noc is not None else wl.noc
    ndies = (args.ndies_y if args.ndies_y is not None else wl.ndies[0],
             args.ndies_x if args.ndies_x is not None else wl.ndies[1])
    placement = args.placement if args.placement is not None \
        else wl.placement
    dies = ndies if placement.endswith("_dielocal") else None

    cfg = EngineConfig(mode=args.mode, backend=backend, noc=noc,
                       ndies_y=ndies[0], ndies_x=ndies[1],
                       edge_space=wl.edge_space, hbm_window=wl.hbm_window,
                       trace=True, trace_every=args.trace_every,
                       trace_rounds=args.trace_rounds, adapt=wl.adapt,
                       adapt_every=wl.adapt_every,
                       adapt_budget=wl.adapt_budget)
    cfg = sized_cfg(cfg, as_program(BFS), tiles)
    n, src, dst, val = rmat_edges(scale, edge_factor=wl.edge_factor, seed=1)
    g = CSRGraph.from_edges(n, src, dst, val)
    root = int(np.argmax(g.ptr[1:] - g.ptr[:-1]))
    meta = {"app": args.app, "preset": args.preset, "scale": scale,
            "tiles": tiles, "backend": backend, "noc": noc,
            "placement": placement, "mode": args.mode,
            "trace_every": args.trace_every, "V": g.num_vertices,
            "E": g.num_edges, "root": root, "device": args.device}
    if args.app == "wcc":
        gs = alg.symmetrize(g)
        pg = alg.prepare(gs, tiles, scheme=placement, dies=dies,
                         device=args.device)
        res = alg.wcc(pg, cfg)
    else:
        pg = alg.prepare(g, tiles, scheme=placement, dies=dies,
                         device=args.device)
        if args.app == "bfs":
            res = alg.bfs(pg, root, cfg)
        elif args.app == "sssp":
            res = alg.sssp(pg, root, cfg)
        elif args.app == "pagerank":
            res = alg.pagerank(pg, iters=4, cfg=cfg)
            meta["note"] = "trace covers the LAST PageRank epoch"
        else:
            x = np.random.default_rng(0).normal(
                size=g.num_vertices).astype(np.float32)
            res = alg.spmv(pg, x, cfg)
    return res, cfg, meta


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    from repro_torch.trace.export import (format_summary, reconcile_cycles,
                                          summarize, write_jsonl,
                                          write_perfetto)

    res, cfg, meta = traced_run(args)
    line = " ".join(f"{k}={v}" for k, v in meta.items())
    print(line)
    cycles = float(res.stats.cycles)
    print(f"rounds={int(res.stats.rounds)} "
          f"cycles={cycles:.0f} "
          f"energy_pj={float(res.stats.energy_pj):.0f}")

    if args.cmd == "summarize":
        print(format_summary(summarize(res.trace)))
        rec = reconcile_cycles(res.trace, cycles)
        print(f"cycle reconcile: exact={rec['exact']} "
              f"last_total={rec['last_total']:.0f} "
              f"stats={rec['stats_cycles']:.0f}")
        return 0

    out = args.out or f"{args.app}.perfetto.json"
    doc = write_perfetto(res.trace, out, meta=meta)
    print(f"wrote {out}: {len(doc['traceEvents'])} events")
    if args.jsonl:
        n = write_jsonl(res.trace, args.jsonl)
        print(f"wrote {args.jsonl}: {n} rounds")
    rec = reconcile_cycles(res.trace, cycles)
    print(f"cycle reconcile: exact={rec['exact']} "
          f"n={rec['n']} last_total={rec['last_total']:.0f} "
          f"stats={rec['stats_cycles']:.0f} "
          f"inc_rel_err={rec['increment_rel_err']:.2e}")
    # a full (unwrapped, every-round) trace's timeline must land bitwise
    # on the accumulated Stats.cycles
    if args.trace_every == 1 and not rec["exact"]:
        print("ERROR: trace timeline does not reconcile with Stats.cycles",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
