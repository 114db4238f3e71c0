"""Telemetry-driven migration planning (port of ``repro.place.plan``).

The planner turns observed telemetry (per-tile busy cycles from the
flight recorder, :mod:`repro_torch.trace`), or static structure when no
trace is given, into a :class:`MigrationPlan`: a set of disjoint
placed-slot *swap pairs*.  Swaps keep the owner map a permutation, so
applying a plan is a pure relabeling (:mod:`repro_torch.place.migrate`).

Two phases, as in the reference:

* **Die affinity** (cross-die traffic): each placed vertex gets a per-die
  histogram of its edge endpoints; a vertex whose edges mostly touch
  another die moves there, into a free padding slot of that die, else by
  exchange with a candidate that wants the opposite move.
* **Work balance** (intra-die busy share): the heaviest in-degree
  vertices of each die's hottest tile swap with the lightest slots
  (padding first) of its coldest tile.

The planner is host code over numpy arrays.  The partition's shards are
tensors on its device; :func:`placed_edges` reads one host copy of each
per call.  Every sort is the reference's ``kind="stable"`` argsort and
every tie falls as the reference's ``argmax`` / ``argmin`` lets it fall,
so a plan is the reference's plan pair for pair.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import PartitionedGraph


@dataclasses.dataclass(frozen=True)
class MigrationPlan:
    """Disjoint placed-slot swap pairs: slot ``pairs[i, 0]`` exchanges its
    vertex (or padding hole) with slot ``pairs[i, 1]``.  ``reason`` tags
    each pair ``'die'`` (phase A) or ``'bal'`` (phase B)."""

    pairs: np.ndarray           # (M, 2) int64 placed-slot ids
    reason: tuple[str, ...] = ()

    @property
    def num_pairs(self) -> int:
        return len(self.pairs)

    def moved_vertices(self, pg: PartitionedGraph) -> int:
        """Real (non-padding) vertices that change owner under this plan."""
        if not len(self.pairs):
            return 0
        return int((pg.inv[self.pairs.reshape(-1)] >= 0).sum())


def empty_plan() -> MigrationPlan:
    return MigrationPlan(pairs=np.zeros((0, 2), np.int64))


def validate_plan(pg: PartitionedGraph, plan: MigrationPlan) -> None:
    """Raise if ``plan`` is not a set of disjoint in-range swap pairs."""
    p = np.asarray(plan.pairs, np.int64)
    if p.size == 0:
        return
    if p.ndim != 2 or p.shape[1] != 2:
        raise ValueError(f"pairs must be (M, 2); got {p.shape}")
    flat = p.reshape(-1)
    if flat.min() < 0 or flat.max() >= len(pg.inv):
        raise ValueError("pair slot out of placed range")
    if np.any(p[:, 0] == p[:, 1]):
        raise ValueError("self-swap pair")
    if len(np.unique(flat)) != len(flat):
        raise ValueError("pairs must be disjoint (each slot in <= 1 pair)")


def host_deg(pg: PartitionedGraph) -> np.ndarray:
    """(v_pad,) int64 out-degree per placed slot, read from the device."""
    return pg.deg.cpu().numpy().astype(np.int64).reshape(-1)


def placed_edges(pg: PartitionedGraph) -> tuple[np.ndarray, np.ndarray]:
    """Every real edge as ``(src_placed, dst_placed)`` int64 arrays.

    ``ptr_start`` is a *global* placed-edge index into the flattened
    ``(T * e_chunk,)`` shard in every edge mode.  One host copy of each
    shard array is read.
    """
    deg = host_deg(pg)
    ptr = pg.ptr_start.cpu().numpy().astype(np.int64).reshape(-1)
    dst_flat = pg.edge_dst.cpu().numpy().reshape(-1)
    src = np.repeat(np.arange(len(deg), dtype=np.int64), deg)
    within = np.arange(int(deg.sum()), dtype=np.int64) \
        - np.repeat(np.cumsum(deg) - deg, deg)
    return src, dst_flat[np.repeat(ptr, deg) + within].astype(np.int64)


def score_tiles(trace) -> np.ndarray:
    """(T,) float64 observed busy cycles per tile, summed on the host over
    the valid slots of the flight recorder's ring."""
    from repro_torch.trace.export import trace_arrays
    arr = trace_arrays(trace)
    return np.asarray(arr["tile_busy"], np.float64).sum(axis=0)


def indegree_mass(pg: PartitionedGraph, edges=None) -> np.ndarray:
    """(v_pad,) int64 in-edge count per placed slot: the static stand-in
    for observed fold work when no trace is given.  ``edges`` is
    :func:`placed_edges` of ``pg``, where the caller has it."""
    _, dst = placed_edges(pg) if edges is None else edges
    return np.bincount(dst, minlength=len(pg.inv)).astype(np.int64)


def vertex_die_affinity(pg: PartitionedGraph, tile_die: np.ndarray,
                        edges=None) -> np.ndarray:
    """(v_pad, n_dies) int64: edge endpoints joining each placed slot to
    vertices owned by each die (both directions counted).  One
    ``np.bincount`` over the flat index ``slot * n_dies + die`` counts
    what the reference's two ``np.add.at`` calls count."""
    src, dst = placed_edges(pg) if edges is None else edges
    td = np.asarray(tile_die, np.int64)
    n_dies = int(td.max()) + 1
    die_of = td[np.arange(len(pg.inv)) // pg.v_chunk]
    flat = np.concatenate([src * n_dies + die_of[dst],
                           dst * n_dies + die_of[src]])
    aff = np.bincount(flat, minlength=len(pg.inv) * n_dies)
    return aff.astype(np.int64).reshape(len(pg.inv), n_dies)


def _die_pairs(pg: PartitionedGraph, tile_die: np.ndarray, budget: int,
               edges) -> tuple[list[tuple[int, int]], int]:
    """Phase A: cross-die-affinity swaps.  Returns (pairs, vertices_moved)."""
    v_chunk = pg.v_chunk
    td = np.asarray(tile_die, np.int64)
    if budget <= 0 or (td == td[0]).all():
        return [], 0
    aff = vertex_die_affinity(pg, td, edges)
    rows = np.arange(len(aff))
    die_of = td[np.arange(len(pg.inv)) // v_chunk]
    home_aff = aff[rows, die_of]
    # best foreign die per slot (the home column masked out of the argmax)
    masked = aff.copy()
    masked[rows, die_of] = -1
    want = masked.argmax(axis=1)
    gain = masked[rows, want] - home_aff
    real = pg.inv >= 0
    cand = np.nonzero(real & (gain > 0))[0]
    cand = cand[np.argsort(-gain[cand], kind="stable")]

    # padding slots per die, in slot order (popped from the end)
    pad_by_die: dict[int, list[int]] = {}
    for s in np.nonzero(~real)[0]:
        pad_by_die.setdefault(int(die_of[s]), []).append(int(s))

    used = np.zeros(len(pg.inv), bool)
    unmatched: dict[tuple[int, int], list[int]] = {}  # (home, want) -> slots
    pairs: list[tuple[int, int]] = []
    moved = 0
    for v in cand:
        if moved >= budget:
            break
        v = int(v)
        if used[v]:
            continue
        h, w = int(die_of[v]), int(want[v])
        free = pad_by_die.get(w, [])
        while free and used[free[-1]]:
            free.pop()
        if free:
            p = free.pop()
            pairs.append((v, p))
            used[v] = used[p] = True
            moved += 1
            continue
        # mutual exchange: a waiting candidate on die w that wants die h
        queue = unmatched.get((w, h), [])
        while queue and used[queue[-1]]:
            queue.pop()
        if queue and moved + 2 <= budget:
            u = queue.pop()
            pairs.append((v, u))
            used[v] = used[u] = True
            moved += 2
        else:
            unmatched.setdefault((h, w), []).append(v)
    return pairs, moved


def _balance_pairs(pg: PartitionedGraph, busy: np.ndarray | None,
                   tile_die: np.ndarray | None, budget: int,
                   used: np.ndarray, edges
                   ) -> tuple[list[tuple[int, int]], int]:
    """Phase B: intra-die hot/cold work-balance swaps."""
    if budget <= 0:
        return [], 0
    T, v_chunk = pg.T, pg.v_chunk
    mass = indegree_mass(pg, edges)
    tile_mass = mass.reshape(T, v_chunk).sum(axis=1).astype(np.float64)
    tile_busy = (np.asarray(busy, np.float64)
                 if busy is not None else tile_mass)
    td = (np.asarray(tile_die, np.int64) if tile_die is not None
          else np.zeros(T, np.int64))
    real = pg.inv >= 0

    pairs: list[tuple[int, int]] = []
    moved = 0
    for die in np.unique(td):
        tiles = np.nonzero(td == die)[0]
        if len(tiles) < 2 or moved >= budget:
            continue
        hot = int(tiles[tile_busy[tiles].argmax()])
        cold = int(tiles[tile_busy[tiles].argmin()])
        if hot == cold or tile_busy[hot] <= tile_busy[cold]:
            continue
        # heaviest free vertices of the hot tile, lightest slots (padding
        # first: mass 0 and nothing to move back) of the cold tile
        h_slots = hot * v_chunk + np.arange(v_chunk)
        c_slots = cold * v_chunk + np.arange(v_chunk)
        h_free = h_slots[real[h_slots] & ~used[h_slots]]
        c_free = c_slots[~used[c_slots]]
        h_order = h_free[np.argsort(-mass[h_free], kind="stable")]
        c_order = c_free[np.argsort(mass[c_free]
                                    + np.where(real[c_free], 0, -1),
                                    kind="stable")]
        gap = tile_mass[hot] - tile_mass[cold]
        for hs, cs in zip(h_order, c_order):
            delta = float(mass[hs] - mass[cs])
            if delta <= 0 or 2 * delta >= gap:
                break  # stop before overshooting the other way
            cost = 1 + int(real[cs])
            if moved + cost > budget:
                break
            pairs.append((int(hs), int(cs)))
            used[hs] = used[cs] = True
            moved += cost
            gap -= 2 * delta
    return pairs, moved


def migration_plan(pg: PartitionedGraph, busy: np.ndarray | None = None,
                   *, budget: int = 64,
                   tile_die: np.ndarray | None = None) -> MigrationPlan:
    """Score tiles and emit a die-aware swap plan.

    ``busy``: (T,) observed per-tile busy cycles (:func:`score_tiles` of a
    ring); ``None`` falls back to per-tile in-degree mass.  ``budget``
    caps the number of *real vertices* that change owner.  Phase A runs
    only when ``tile_die`` spans more than one die and has first claim on
    the budget; phase B spends the rest.  The shards are read from the
    device once.
    """
    edges = placed_edges(pg)
    pairs_a, moved_a = ([], 0)
    if tile_die is not None:
        pairs_a, moved_a = _die_pairs(pg, tile_die, budget, edges)
    used = np.zeros(len(pg.inv), bool)
    for a, b in pairs_a:
        used[a] = used[b] = True
    pairs_b, _ = _balance_pairs(pg, busy, tile_die, budget - moved_a, used,
                                 edges)
    pairs = pairs_a + pairs_b
    if not pairs:
        return empty_plan()
    plan = MigrationPlan(
        pairs=np.asarray(pairs, np.int64),
        reason=tuple(["die"] * len(pairs_a) + ["bal"] * len(pairs_b)))
    validate_plan(pg, plan)
    return plan
