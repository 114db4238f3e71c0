"""Telemetry-driven adaptive placement (port of ``repro.place``).

The flight recorder (:mod:`repro_torch.trace`) observes per-tile busy
cycles and per-class link traffic; the planner (:mod:`.plan`) turns them
into a die-aware vertex-swap plan; the migrator (:mod:`.migrate`) applies
the plan as a pure relabeling of the owner map (converged values bitwise
the unmigrated run's) and prices the move into the perf model;
:mod:`.adapt` glues the three into the epoch-boundary
(:func:`adaptive_pagerank`) and between-batch
(:class:`repro_torch.serve.frontend.Frontend`) call sites.  The planner
and the migrator are host code over numpy; the engine runs on the
partition's device.
"""
from repro_torch.place.adapt import (adapt_partition, adaptive_pagerank,
                                     cfg_tile_die, plan_from_trace)
from repro_torch.place.migrate import (apply_plan, migration_words,
                                       price_migration, remap_state,
                                       swap_permutation)
from repro_torch.place.plan import (MigrationPlan, empty_plan,
                                    indegree_mass, migration_plan,
                                    placed_edges, score_tiles,
                                    validate_plan, vertex_die_affinity)

__all__ = [
    "MigrationPlan", "adapt_partition", "adaptive_pagerank", "apply_plan",
    "cfg_tile_die", "empty_plan", "indegree_mass", "migration_plan",
    "migration_words", "placed_edges", "plan_from_trace", "price_migration",
    "remap_state", "score_tiles", "swap_permutation", "validate_plan",
    "vertex_die_affinity",
]
