"""Applying a migration plan: relabel, re-deal, remap, price (port of
``repro.place.migrate``).

Applying a plan is a *pure relabeling* of the owner map:
:func:`apply_plan` composes the swap permutation with ``pg.place`` and
rebuilds the shards through the same
:func:`repro_torch.core.graph.build_partition` that built the original,
on the device the old partition lives on.  So the migrated partition is
bitwise one that *started* with the composed placement, and converged
values (mapped back to original ids) do not depend on whether, or when, a
migration happened.

Pricing: a migrated vertex moves its state words (value, acc, the
frontier word) and its edge segment (``deg`` words); cross-die words also
ride the die-to-die link.  :func:`price_migration` folds the modelled
cycles and energy into ``Stats`` with float32 adds on the Stats' own
tensors, the leakage of the added cycles included, so that
:func:`repro_torch.perf.model.energy_from_totals` stays an exact oracle.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import CSRGraph, PartitionedGraph, \
    build_partition
from repro_torch.place.plan import MigrationPlan, host_deg, validate_plan


def swap_permutation(n_pad: int, pairs: np.ndarray) -> np.ndarray:
    """(n_pad,) int64 involution exchanging each pair's slots."""
    perm = np.arange(n_pad, dtype=np.int64)
    p = np.asarray(pairs, np.int64)
    if len(p):
        perm[p[:, 0]] = p[:, 1]
        perm[p[:, 1]] = p[:, 0]
    return perm


def apply_plan(g: CSRGraph, pg: PartitionedGraph, plan: MigrationPlan,
               tile_die: np.ndarray | None = None) -> PartitionedGraph:
    """Rebuild ``pg`` with ``plan``'s swaps composed into the owner map,
    its shards on ``pg``'s device.

    Needs the host CSR ``g`` to re-deal the moved edge segments.  Keeps
    ``edge_mode`` and, through :func:`repro_torch.core.algorithms.
    sort_adjacency`, the ``sorted_adj`` layout triangle counting needs.
    ``e_chunk`` may change in the ``die_aligned`` / ``vertex_aligned``
    modes: callers re-validate queue sizing against the new shape.
    """
    validate_plan(pg, plan)
    perm = swap_permutation(len(pg.inv), plan.pairs)
    place_new = perm[pg.place]
    inv_new = np.empty_like(pg.inv)
    inv_new[perm] = pg.inv
    pg2 = build_partition(g, pg.T, place_new, inv_new, pg.edge_mode,
                          tile_die=tile_die, device=pg.device)
    if pg.sorted_adj:
        from repro_torch.core.algorithms import sort_adjacency
        pg2 = sort_adjacency(pg2)
    return pg2


# State words moved per vertex besides its edge segment: value, acc, and
# the packed frontier/metadata word.
STATE_WORDS = 3


def migration_words(pg: PartitionedGraph, plan: MigrationPlan,
                    tile_die: np.ndarray | None = None
                    ) -> tuple[int, int]:
    """64-bit words ``(intra_die, cross_die)`` the plan moves.

    Each *real* vertex in a pair moves ``STATE_WORDS + deg`` words (its
    state and its out-edge segment); padding holes move nothing.  A word
    is cross-die when its pair's two slots live on different dies.
    """
    if not len(plan.pairs):
        return 0, 0
    deg = host_deg(pg)
    real = pg.inv >= 0
    td = (np.asarray(tile_die, np.int64) if tile_die is not None
          else np.zeros(pg.T, np.int64))
    slots = np.asarray(plan.pairs, np.int64)
    die_of = td[slots // pg.v_chunk]  # (M, 2)
    cross = die_of[:, 0] != die_of[:, 1]
    words = np.where(real[slots], STATE_WORDS + deg[slots], 0)  # (M, 2)
    per_pair = words.sum(axis=1)
    return (int(per_pair[~cross].sum()), int(per_pair[cross].sum()))


def price_migration(stats, pg: PartitionedGraph, plan: MigrationPlan,
                    T: int, params=None,
                    tile_die: np.ndarray | None = None):
    """Fold the plan's modelled cost into ``stats``: ``migration_cost``
    cycles and energy plus the leakage of the added cycles, and the three
    migration counters.  The adds are float32 (int32 for the vertex
    count) on the Stats' tensors, where they live, as the reference adds
    ``np.float32`` scalars to its float32 Stats.  Returns the new Stats."""
    from repro_torch.perf.model import PerfParams, leak_pj, migration_cost
    params = params or PerfParams()
    wi, wc = migration_words(pg, plan, tile_die)
    cyc, pj = migration_cost(params, wi, wc)
    leak = float(leak_pj(params, T, torch.tensor(np.float32(cyc))))
    moved = plan.moved_vertices(pg)

    def f32(x):
        return torch.tensor(np.float32(x), device=stats.cycles.device)
    return stats._replace(
        cycles=stats.cycles + f32(cyc),
        energy_pj=stats.energy_pj + f32(pj + leak),
        migrated_vertices=stats.migrated_vertices + torch.tensor(
            moved, dtype=torch.int32, device=stats.cycles.device),
        migration_cycles=stats.migration_cycles + f32(cyc),
        migration_pj=stats.migration_pj + f32(pj),
    )


def remap_state(pg_old: PartitionedGraph, pg_new: PartitionedGraph,
                arr, fill=0.0) -> np.ndarray:
    """Carry a ``(T, v_chunk)`` placed-space array across a migration, on
    the host.  Routes through original vertex ids (``out[slot owning v] =
    in[slot that owned v]``), so it is exact for any two partitions of
    the same graph.  Padding slots get ``fill``.  ``arr`` may be a
    tensor on any device."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    flat = np.asarray(arr).reshape(-1)
    ok_old = pg_old.inv >= 0
    orig = np.full(pg_old.num_vertices, fill, flat.dtype)
    orig[pg_old.inv[ok_old]] = flat[ok_old]
    ok_new = pg_new.inv >= 0
    out = np.full(len(pg_new.inv), fill, flat.dtype)
    out[ok_new] = orig[pg_new.inv[ok_new]]
    return out.reshape(pg_new.T, pg_new.v_chunk)
