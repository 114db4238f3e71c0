"""Data distribution: the paper's equal-chunk placement arithmetic.

The PyTorch port's own copy of ``repro.core.distribution`` (numpy only, so
the two packages place vertices identically without importing each other).

Dalorex distributes every dataset array in equal chunks across tiles and
routes task messages by the *global array index* alone (headerless NoC,
Section III-E): ``owner(i) = i // chunk`` and ``local(i) = i % chunk`` once
the placement permutation has been applied.

Three placement schemes are provided (the Fig. 5 ``Uniform-distr``
ablation plus the paper's degree-aware preprocessing rung):

* ``low_order``  — Dalorex: original element ``v`` goes to shard ``v % T``
  (scatter by low-order bits). Consecutive hot vertices land on different
  tiles, balancing work and traffic without preprocessing.
* ``high_order`` — Tesseract-like: contiguous chunks (``v // chunk``), which
  concentrates hub neighborhoods (and therefore traffic) on few tiles.
* ``degree_interleave`` — degree-aware: vertices sorted by descending
  degree are dealt round-robin across tiles, so the T highest-degree hubs
  land on T *different* tiles.  This is the preprocessing-heavy rung the
  paper contrasts with low-order bits: it equalizes per-tile *work*
  (``work_max``) even under adversarial (degree-sorted) vertex ids, at the
  cost of a host-side sort.  Requires per-vertex degrees (``deg=``).

Each scheme also has a **die-local** variant (``low_order_dielocal``,
``high_order_dielocal``, ``degree_interleave_dielocal``) for the
multi-die hierarchical NoC (``noc="hier"``, PIUMA-style die-of-dies):
the padded ID space is first cut into one contiguous *partition* per die
(so each graph partition stays die-resident), then the base scheme is
applied *within* the die across that die's tiles.  Die membership of the
tiles comes from ``tile_die=`` (built by ``repro.noc.tile_die_map`` so
placement and fabric agree on the geometry); die crossings — the scarce,
expensive resource of the hierarchy — then only happen on edges that
leave a partition, not on every consecutive-id hop the flat ``low_order``
scatter takes.

We realize a scheme as a *permutation into placed-ID space* followed by
contiguous chunking, which is exactly how the paper builds its global CSR
("we build the global CSR so that consecutive vertices fall into different
tiles").
"""
from __future__ import annotations

import dataclasses

import numpy as np


def padded_len(n: int, shards: int) -> int:
    return ((n + shards - 1) // shards) * shards


@dataclasses.dataclass(frozen=True)
class DistSpec:
    """Equal-chunk distribution of a (padded) global array over shards."""

    total: int  # padded global length; multiple of num_shards
    num_shards: int

    def __post_init__(self):
        assert self.total % self.num_shards == 0, (self.total, self.num_shards)

    @property
    def chunk(self) -> int:
        return self.total // self.num_shards

    def owner(self, idx):
        return idx // self.chunk

    def local(self, idx):
        return idx % self.chunk

    def global_(self, shard, local):
        return shard * self.chunk + local


DIELOCAL_SUFFIX = "_dielocal"


def _rank_by_degree(deg_padded: np.ndarray) -> np.ndarray:
    """rank[i] of every id by descending degree (stable: equal-degree ids
    keep id order, so the zero-degree padding ids rank last)."""
    order = np.argsort(-deg_padded, kind="stable")
    rank = np.empty(len(deg_padded), np.int64)
    rank[order] = np.arange(len(deg_padded), dtype=np.int64)
    return rank


def _dielocal_place(ids, n_orig: int, chunk: int, base: str,
                    deg: np.ndarray | None,
                    tile_die: np.ndarray) -> np.ndarray:
    """Die-local placement: contiguous ID partitions pinned to dies, the
    base scheme applied within each die over that die's tiles."""
    n_pad = len(ids)
    tile_die = np.asarray(tile_die, np.int64)
    n_dies = int(tile_die.max()) + 1
    counts = np.bincount(tile_die, minlength=n_dies)
    if not (counts == counts[0]).all():
        raise ValueError(f"dies must hold equal tile counts, got {counts}")
    t_die = int(counts[0])                       # tiles per die
    tiles_of = np.argsort(tile_die, kind="stable").reshape(n_dies, t_die)
    sc = n_pad // n_dies                         # ids per die partition
    d, o = ids // sc, ids % sc
    if base == "low_order":
        lt, slot = o % t_die, o // t_die
    elif base == "high_order":
        lt, slot = o // chunk, o % chunk
    elif base == "degree_interleave":
        if deg is None:
            raise ValueError("degree_interleave placement needs deg=")
        assert len(deg) == n_orig, (len(deg), n_orig)
        degp = np.zeros(n_pad, np.int64)
        degp[:n_orig] = np.asarray(deg, np.int64)
        rank = np.concatenate([_rank_by_degree(degp[i * sc:(i + 1) * sc])
                               for i in range(n_dies)])
        lt, slot = rank % t_die, rank // t_die
    else:
        raise ValueError(f"unknown placement scheme: {base}{DIELOCAL_SUFFIX}")
    return tiles_of[d, lt] * chunk + slot


def placement(n_orig: int, num_shards: int, scheme: str,
              deg: np.ndarray | None = None,
              tile_die: np.ndarray | None = None,
              ) -> tuple[np.ndarray, np.ndarray]:
    """Return (place, inv) arrays over the padded ID space.

    ``place[v]`` is the placed ID of original element ``v``;
    ``inv[p]`` is the original ID at placed slot ``p`` (or -1 for padding).
    ``deg`` (per-original-element weights) is required by the degree-aware
    ``degree_interleave`` scheme(s) and ignored otherwise; ``tile_die``
    (a (num_shards,) tile -> die map, see ``repro.noc.tile_die_map``) is
    required by the ``*_dielocal`` schemes and ignored otherwise.
    """
    n_pad = padded_len(n_orig, num_shards)
    ids = np.arange(n_pad, dtype=np.int64)
    chunk = n_pad // num_shards
    if scheme.endswith(DIELOCAL_SUFFIX):
        if tile_die is None:
            raise ValueError(f"{scheme} placement needs tile_die=")
        if len(tile_die) != num_shards:
            raise ValueError(f"tile_die maps {len(tile_die)} tiles, "
                             f"placement has {num_shards} shards")
        place = _dielocal_place(ids, n_orig, chunk,
                                scheme[: -len(DIELOCAL_SUFFIX)], deg,
                                tile_die)
    elif scheme == "low_order":
        place = (ids % num_shards) * chunk + ids // num_shards
    elif scheme == "high_order":
        place = ids.copy()
    elif scheme == "degree_interleave":
        if deg is None:
            raise ValueError("degree_interleave placement needs deg=")
        assert len(deg) == n_orig, (len(deg), n_orig)
        # rank 0 = highest degree; padding ids rank last.  Stable sort keeps
        # equal-degree vertices in id order (deterministic).
        order = np.argsort(-np.asarray(deg, np.int64), kind="stable")
        order = np.concatenate([order, np.arange(n_orig, n_pad)])
        rank = np.empty(n_pad, np.int64)
        rank[order] = ids
        # deal ranks round-robin: rank r -> tile r % T, slot r // T
        place = (rank % num_shards) * chunk + rank // num_shards
    else:
        raise ValueError(f"unknown placement scheme: {scheme}")
    inv = np.full(n_pad, -1, dtype=np.int64)
    inv[place] = ids
    # mark padding slots
    pad_mask = inv >= n_orig
    inv[pad_mask] = -1
    return place[:n_orig].astype(np.int64), inv
