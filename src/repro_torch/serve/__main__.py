"""CLI: serve a stream of point queries against a resident preset graph
(port of ``python -m repro.serve``).

    python -m repro_torch.serve --preset rmat-small --queries 64 \\
        --batch 16 --app bfs --arrival poisson --gap 5e4 --policy static

Prints the aggregate throughput / latency report (modelled cycles) and,
with ``--per-query``, one line per served query.  ``--backend`` takes the
port's ``torch`` / ``kernels`` (the reference's ``xla`` / ``pallas``); the
run is on the card unless ``--device cpu``.  The channel queues are
sized from the engine's own worst-case inflow bounds
(``EngineConfig.min_caps``), as the reference's CLI sizes them.
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="Batched query serving over a resident graph")
    ap.add_argument("--preset", default="rmat-small",
                    help="repro_torch.configs.dalorex_graph preset")
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8, help="lane width B")
    ap.add_argument("--app", default="bfs", choices=("bfs", "sssp"))
    ap.add_argument("--arrival", default="burst",
                    choices=("burst", "uniform", "poisson"))
    ap.add_argument("--gap", type=float, default=0.0,
                    help="mean interarrival gap, modelled cycles")
    ap.add_argument("--policy", default="static",
                    choices=("static", "continuous"))
    ap.add_argument("--backend", default=None, choices=("torch", "kernels"),
                    help="engine backend override (default: preset's)")
    ap.add_argument("--noc", default=None,
                    help="NoC backend override (default: preset's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    ap.add_argument("--per-query", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs.dalorex_graph import get_workload
    from repro_torch.core import algorithms as alg
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.graph import CSRGraph, rmat_edges
    from repro_torch.serve import Frontend

    wl = get_workload(args.preset)
    n, src, dst, val = rmat_edges(wl.scale, edge_factor=wl.edge_factor,
                                  seed=0)
    g = CSRGraph.from_edges(n, src, dst, val)
    dies = wl.ndies if wl.placement.endswith("_dielocal") else None
    pg = alg.prepare(g, T=wl.tiles, scheme=wl.placement, dies=dies,
                     device=args.device)
    # size the channel queues from the engine's own worst-case inflow
    # bounds, as the reference's CLI does
    base = dict(f_pop=32, r_pop=32, u_pop=64, max_t2=16,
                cap_route_range=8, cap_route_update=32,
                max_rounds=200_000, backend=args.backend or wl.backend,
                noc=args.noc or wl.noc)
    if base["noc"] == "hier":
        base["ndies_y"], base["ndies_x"] = wl.ndies
    rangeq, burst = EngineConfig(**base).min_caps(wl.tiles)
    cfg = EngineConfig(
        cap_rangeq=max(512, 1 << (rangeq - 1).bit_length()),
        cap_updq=max(8192, 1 << (burst - 1).bit_length()), **base)

    rng = np.random.default_rng(args.seed)
    deg = np.asarray(g.ptr[1:] - g.ptr[:-1])
    sources = rng.choice(np.flatnonzero(deg > 0), size=args.queries)

    fe = Frontend(pg, app=args.app, cfg=cfg, width=args.batch,
                  policy=args.policy)
    rep = fe.serve(sources, arrival=args.arrival, gap=args.gap,
                   seed=args.seed)

    print(f"# preset={args.preset} V={g.num_vertices} T={wl.tiles} "
          f"backend={cfg.backend} noc={cfg.noc} device={args.device}")
    print(",".join(f"{k}={v}" for k, v in rep.row().items()))
    if args.per_query:
        for r in rep.records:
            print(f"q{r.qid} src={r.source} enq={r.enqueue_cycle:.0f} "
                  f"admit={r.admit_cycle:.0f} "
                  f"done={r.complete_cycle:.0f} lat={r.latency:.0f} "
                  f"rounds={r.rounds} edges={r.edges}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
