"""Tile-grid geometry (port of the part of ``repro.noc.topology`` the
ideal crossbar needs: the link cost-class constants and the near-square
grid factorization).  ``line_usage``, ``admit``,
``line_link_classes`` and ``tile_die_map`` come with the physical NoCs
(ROADMAP.md, "Physical NoCs")."""
from __future__ import annotations

import math

# Cost classes of directed links, priced by repro_torch.perf.  PORT is the
# ideal crossbar's ingress ports (no wire latency, switch energy only).
CLASS_LOCAL, CLASS_RUCHE, CLASS_WRAP, CLASS_PORT, CLASS_DIE = range(5)
N_LINK_CLASSES = 5


def grid_shape(T: int, rows: int = 0) -> tuple[int, int]:
    """Factor ``T`` tiles into a (rows, cols) grid, near-square by default."""
    if rows <= 0:
        rows = max(int(math.isqrt(T)), 1)
        while T % rows:
            rows -= 1
    if T % rows:
        raise ValueError(f"rows={rows} does not divide T={T}")
    return rows, T // rows
