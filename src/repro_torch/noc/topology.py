"""Tile-grid geometry for the physical NoC backends (port of
``repro.noc.topology``).

A grid of ``T = rows * cols`` tiles; tile ``t`` sits at ``(t // cols,
t % cols)``.  Dimension-ordered (X-then-Y) routing decomposes every route
into two 1-D journeys, so all link math lives in :func:`line_usage`,
parametric over the wiring of one line of ``n`` tiles:

* mesh  — bidirectional neighbor links; travel is monotone to the goal.
* torus — neighbor links plus wraparound; travel takes the shorter way.
* ruche — mesh plus express "ruche" channels that skip ``R`` tiles;
  travel rides them while the remaining distance allows, then finishes
  on local links.
* hier  — the line is cut into ``n // die`` die segments of ``die``
  tiles: local links exist only within a segment, and adjacent segments
  are joined by inter-die express links between their gateway tiles.
  Cross-die travel rides local links to the source die's gateway, one
  express hop per die boundary, then local links from the destination
  die's gateway.  With ``wrap=True`` each segment closes its own ring
  (the wrap shortcut applies to die-local travel only).

Directed links on a line are indexed by their *source* position in four
channel classes: ``LOCAL_FWD`` i -> i+1, ``LOCAL_BWD`` i -> i-1,
``RUCHE_FWD`` i -> i+R and ``RUCHE_BWD`` i -> i-R.  The hier express links
reuse the ruche slots (``DIE_FWD`` at the forward gateways ``i % die ==
die-1``, ``DIE_BWD`` at the backward ones ``i % die == 0``).

:func:`admit` is the per-link backpressure: a message enters the fabric
this round only if every link on its path has seen fewer than ``cap``
flits from earlier messages in FIFO order.  Blocked messages keep their
claims (a pure prefix scan), and the head of the FIFO always passes, so
spill-and-replay progresses every round and nothing is dropped.

Tensors are tile-led: positions are ``(..., N)`` int32 (the leading axes,
e.g. the T tiles of :class:`~repro_torch.core.comm.LocalComm`, are
carried through), and every count is int32 as in the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

N_CHANNELS = 4
LOCAL_FWD, LOCAL_BWD, RUCHE_FWD, RUCHE_BWD = range(N_CHANNELS)
# the hier backend's inter-die express links live on the ruche slots
DIE_FWD, DIE_BWD = RUCHE_FWD, RUCHE_BWD

# Cost classes of directed links, priced by repro_torch.perf.  PORT is the
# ideal crossbar's ingress ports (no wire latency, switch energy only);
# DIE the hier backend's die-to-die express links (off-die wire + serdes).
CLASS_LOCAL, CLASS_RUCHE, CLASS_WRAP, CLASS_PORT, CLASS_DIE = range(5)
N_LINK_CLASSES = 5

I32 = torch.int32


def grid_shape(T: int, rows: int = 0) -> tuple[int, int]:
    """Factor ``T`` tiles into a (rows, cols) grid, near-square by default."""
    if rows <= 0:
        rows = max(int(math.isqrt(T)), 1)
        while T % rows:
            rows -= 1
    if T % rows:
        raise ValueError(f"rows={rows} does not divide T={T}")
    return rows, T // rows


def line_hops(a, b, n: int, wrap: bool = False, ruche: int = 0,
              die: int = 0) -> torch.Tensor:
    """Hop count of travel ``a -> b`` on one line: the ``hops`` of
    :func:`line_usage` without building the link usage."""
    a, b = a.to(I32), b.to(I32)
    if 0 < die < n:
        m = die
        same = (a // m) == (b // m)
        if wrap:
            dmod = (b - a) % m
            hops_s = torch.where(dmod <= m // 2, dmod, m - dmod)
        else:
            hops_s = (b - a).abs()
        cf = (b // m) > (a // m)
        hops_cf = (m - 1 - a % m) + (b // m - a // m) + (m - 1 - b % m)
        hops_cb = (a % m) + (a // m - b // m) + (b % m)
        return torch.where(same, hops_s, torch.where(cf, hops_cf, hops_cb))
    if wrap:
        d = (b - a) % n
        return torch.where(d <= n // 2, d, n - d)
    if ruche > 1:
        ad = (b - a).abs()
        return ad // ruche + ad % ruche
    return (b - a).abs()


def line_usage(a, b, n: int, wrap: bool = False, ruche: int = 0,
               die: int = 0):
    """Per-link usage of travel ``a -> b`` along one axis of the grid.

    a, b: ``(..., N)`` int positions in [0, n).  Returns ``(hops, use)``:
    ``hops`` (..., N) int32 and ``use`` (..., N, N_CHANNELS, n) bool
    marking every directed link each message traverses.  ``die`` > 0
    segments the line into dies of ``die`` tiles (module docstring);
    ``die`` outside ``(0, n)`` is the unsegmented wiring, so a one-die
    hierarchy is exactly a mesh/torus line.
    """
    a, b = a.to(I32), b.to(I32)
    hops = line_hops(a, b, n, wrap, ruche, die)
    ln = torch.arange(n, dtype=I32, device=a.device)
    a_, b_ = a[..., None], b[..., None]
    if 0 < die < n:
        assert n % die == 0, (n, die)
        m = die
        da_, db_ = a_ // m, b_ // m
        oa_ = a_ % m
        ln_d, ln_o = ln // m, ln % m
        same = (a // m) == (b // m)
        if wrap:
            dmod = (b - a) % m
            fwd_s = dmod <= m // 2
            seg = ln_d == da_
            use_f_s = ((same & fwd_s)[..., None] & seg
                       & (((ln_o - oa_) % m) < dmod[..., None]))
            use_b_s = ((same & ~fwd_s)[..., None] & seg
                       & (((oa_ - ln_o) % m) < (m - dmod)[..., None]))
        else:
            fwd_s = (b - a) >= 0
            use_f_s = (same & fwd_s)[..., None] & (ln >= a_) & (ln < b_)
            use_b_s = (same & ~fwd_s)[..., None] & (ln <= a_) & (ln > b_)
        cf = (b // m) > (a // m)
        cb = ~same & ~cf
        cf_, cb_ = cf[..., None], cb[..., None]
        use_f = (use_f_s
                 | (cf_ & (ln_d == da_) & (ln >= a_) & (ln_o < m - 1))
                 | (cb_ & (ln_d == db_) & (ln < b_)))
        use_b = (use_b_s
                 | (cf_ & (ln_d == db_) & (ln > b_))
                 | (cb_ & (ln_d == da_) & (ln <= a_) & (ln_o > 0)))
        use_df = cf_ & (ln_o == m - 1) & (ln_d >= da_) & (ln_d < db_)
        use_db = cb_ & (ln_o == 0) & (ln_d <= da_) & (ln_d > db_)
        return hops, torch.stack([use_f, use_b, use_df, use_db], dim=-2)
    zero = torch.zeros(a.shape + (n,), dtype=torch.bool, device=a.device)
    if wrap:
        d = (b - a) % n
        fwd = d <= n // 2
        use_f = fwd[..., None] & (((ln - a_) % n) < d[..., None])
        use_b = (~fwd)[..., None] & (((a_ - ln) % n) < (n - d)[..., None])
        use_rf = use_rb = zero
    elif ruche > 1:
        dist = b - a
        fwd = (dist >= 0)[..., None]
        kr = ((dist.abs() // ruche) * ruche)[..., None]
        use_rf = (fwd & (ln >= a_) & (ln < a_ + kr)
                  & ((ln - a_) % ruche == 0))
        use_f = fwd & (ln >= a_ + kr) & (ln < b_)
        use_rb = (~fwd & (ln <= a_) & (ln > a_ - kr)
                  & ((a_ - ln) % ruche == 0))
        use_b = ~fwd & (ln <= a_ - kr) & (ln > b_)
    else:
        fwd = ((b - a) >= 0)[..., None]
        use_f = fwd & (ln >= a_) & (ln < b_)
        use_b = ~fwd & (ln <= a_) & (ln > b_)
        use_rf = use_rb = zero
    return hops, torch.stack([use_f, use_b, use_rf, use_rb], dim=-2)


def line_link_classes(n: int, wrap: bool = False, die: int = 0) -> np.ndarray:
    """(N_CHANNELS, n) int32 cost class of every directed link on a line
    of ``n`` tiles: the RUCHE channels are CLASS_RUCHE, or CLASS_DIE when
    the line is segmented (``0 < die < n``); on a torus line the two links
    that close each ring (source ``m-1`` forward and ``0`` backward per
    segment of ``m``) are CLASS_WRAP; every other link is CLASS_LOCAL."""
    cls = np.full((N_CHANNELS, n), CLASS_LOCAL, np.int32)
    express = CLASS_DIE if 0 < die < n else CLASS_RUCHE
    cls[RUCHE_FWD] = express
    cls[RUCHE_BWD] = express
    if wrap:
        m = die if 0 < die < n else n
        cls[LOCAL_FWD, m - 1::m] = CLASS_WRAP
        cls[LOCAL_BWD, 0::m] = CLASS_WRAP
    return cls


def tile_die_map(T: int, rows: int = 0, ndies_y: int = 1,
                 ndies_x: int = 1) -> np.ndarray:
    """(T,) int64 die id of every tile of a (rows, cols) grid cut into an
    ``ndies_y x ndies_x`` array of equal dies (row-major die numbering).
    ``rows=0`` uses :func:`grid_shape`'s factorization, so placement and
    fabric agree by default."""
    rows, cols = grid_shape(T, rows)
    if rows % ndies_y or cols % ndies_x:
        raise ValueError(
            f"{rows}x{cols} grid not divisible into {ndies_y}x{ndies_x} dies")
    t = np.arange(T, dtype=np.int64)
    r, c = t // cols, t % cols
    return (r // (rows // ndies_y)) * ndies_x + c // (cols // ndies_x)


def admit(use, valid, cap: int, base=None):
    """FIFO per-link admission under a per-round link capacity.

    use: (..., N, C, L) bool link usage per message; valid: (..., N) bool.
    Message i is admitted iff every link it uses has < ``cap`` flits
    claimed by earlier valid messages (claims count whether or not those
    messages were admitted).  ``base`` (..., C, L) int32 adds the claims
    already standing against each link (the grid backends pass the summed
    claims of the tiles earlier on the line).  ``cap <= 0`` disables the
    limit and returns ``valid`` itself.
    """
    if cap <= 0:
        return valid
    u = (use & valid[..., None, None]).to(I32)
    # exclusive prefix per link over the message axis, built in place: it
    # is the largest temporary of a route (4 bytes a message and link)
    prior = torch.cumsum(u, dim=-3, dtype=I32).sub_(u)
    del u
    if base is not None:
        prior.add_(base[..., None, :, :])
    # claims are >= 0, so zeroing the unused links is where(use, prior, 0)
    worst = prior.mul_(use).amax(dim=(-2, -1))
    return valid & (worst < cap)
