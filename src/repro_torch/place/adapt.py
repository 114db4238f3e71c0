"""Closing the loop: telemetry in, adapted partition out (port of
``repro.place.adapt``).

:func:`adapt_partition` is the one call the call sites make between
epochs or batches; :func:`adaptive_pagerank` is the epoch-boundary
driver: :func:`repro_torch.core.algorithms.pagerank`'s loop, but every
``cfg.adapt_every`` epochs it reads the last epoch's ring, migrates,
remaps the rank vector through original vertex ids on the host, and
prices the move into the accumulated Stats.  Migration happens only at
quiescent points (the engine has drained between epochs), so no message
in flight ever sees a stale owner.  The engine runs on the partition's
device, or as SPMD over a mesh: the plan comes from the ring, which holds
globals only and so is the same on every process, and ``apply_plan``
re-deals the host partition on every process alike before each process
takes its tile's row of it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.engine import EngineConfig, zero_stats
from repro_torch.core.graph import CSRGraph, PartitionedGraph
from repro_torch.core.program import PAGERANK
from repro_torch.place.migrate import apply_plan, price_migration, \
    remap_state
from repro_torch.place.plan import MigrationPlan, empty_plan, \
    migration_plan, score_tiles

def cfg_tile_die(cfg: EngineConfig, T: int) -> np.ndarray | None:
    """The tile -> die map of ``cfg``'s fabric (None off the hier NoC)."""
    if cfg.noc != "hier" or cfg.ndies_x * cfg.ndies_y <= 1:
        return None
    from repro_torch.noc.topology import tile_die_map
    return tile_die_map(T, cfg.noc_rows, cfg.ndies_y, cfg.ndies_x)


def plan_from_trace(pg: PartitionedGraph, cfg: EngineConfig,
                    trace) -> MigrationPlan:
    """Score the recorder's ring and plan within ``cfg.adapt_budget``."""
    busy = score_tiles(trace) if trace is not None else None
    return migration_plan(pg, busy, budget=cfg.adapt_budget,
                          tile_die=cfg_tile_die(cfg, pg.T))


def adapt_partition(g: CSRGraph, pg: PartitionedGraph, cfg: EngineConfig,
                    trace=None, busy=None
                    ) -> tuple[PartitionedGraph, MigrationPlan]:
    """One adaptation step: plan from telemetry, apply, return both.

    ``trace`` (a ring) wins over ``busy`` (a (T,) busy vector); with
    neither the planner falls back to static in-degree mass.  Returns
    ``(pg, empty_plan())`` when there is nothing to move.
    """
    if busy is None and trace is not None:
        busy = score_tiles(trace)
    tile_die = cfg_tile_die(cfg, pg.T)
    plan = migration_plan(pg, busy, budget=cfg.adapt_budget,
                          tile_die=tile_die)
    if not plan.num_pairs:
        return pg, empty_plan()
    return apply_plan(g, pg, plan, tile_die=tile_die), plan


def adaptive_pagerank(g: CSRGraph, pg: PartitionedGraph,
                      damping: float = 0.85, iters: int = 20,
                      cfg: EngineConfig = EngineConfig(), mesh=None,
                      params=None):
    """Epoch-synchronized PageRank with epoch-boundary migration.

    Plans from the last epoch's ring when ``cfg.trace``, else from the
    planner's static fallback.  Each epoch after a migration is bitwise
    the same epoch on a partition *built* with the composed placement;
    against the unmigrated run, values agree to float tolerance in
    general and bitwise where the epoch's sums are order-independent
    (the dyadic instances of ``tests/test_place.py``).

    Returns ``(result, pg_final, plans)``.
    """
    from repro_torch.core.algorithms import (Result, _acc_stats,
                                             initial_rank, pagerank_epoch,
                                             to_original)
    rank = initial_rank(pg)
    total = zero_stats(cfg, pg.T, PAGERANK, pg.device)
    plans: list[MigrationPlan] = []
    trace = None
    tile_die = cfg_tile_die(cfg, pg.T)
    for epoch in range(iters):
        if cfg.adapt and epoch and epoch % max(cfg.adapt_every, 1) == 0:
            pg2, plan = adapt_partition(g, pg, cfg, trace=trace)
            if plan.num_pairs:
                rank = remap_state(pg, pg2, rank, fill=np.float32(0.0))
                total = price_migration(total, pg, plan, pg.T,
                                        params=params, tile_die=tile_die)
                pg = pg2
                plans.append(plan)
        rank, stats, trace = pagerank_epoch(pg, rank, damping, cfg, mesh)
        total = _acc_stats(total, stats)
    res = Result(to_original(pg, rank).astype(np.float64), total, iters,
                 trace=trace)
    return res, pg, plans
