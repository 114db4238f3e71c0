"""NoC backends (port of ``repro.noc.network``).

A Network turns "route these messages to their owners" into a fabric
model with the contract ``route(comm, msgs, valid, capacity, dest_fn) ->
NetRouted``, where ``dest_fn`` decodes the destination tile from the head
flit (the paper's headerless routing).  The returned spill holds the
messages that could not progress this round; since routes are re-derived
from the head flit, a message stranded at a waypoint replays from that
tile's queue exactly as one stranded at its source.

* :class:`IdealAllToAll` — one perfect crossbar round: contention only at
  the endpoint slots, and its "links" are the T ingress ports.
* :class:`Mesh2D` / :class:`Torus2D` / :class:`Ruche` — a (rows, cols)
  grid with dimension-ordered (X-then-Y) routing over two per-axis
  exchanges, each leg charged against ``link_cap`` flits per directed
  link (0 = unlimited) with spill-and-replay backpressure.
* :class:`Hier2D` — an ``ndies_y x ndies_x`` array of intra-die meshes
  (or tori) joined by DIE-class express links.  At ``ndies = 1x1`` with a
  mesh base it is :class:`Mesh2D`, link for link.

Link index space of the grid backends (``num_links = 8 * T``): an X block
``(rows, N_CHANNELS, cols)`` (the links of each row line), then a Y block
``(cols, N_CHANNELS, rows)`` (the links of each column line), flattened.
``link_classes`` attributes each link to a cost class of
:mod:`repro_torch.noc.topology` (LOCAL, RUCHE, WRAP, PORT, DIE), priced by
:mod:`repro_torch.perf`.

Every stage is batched over the T tiles (``LocalComm.run`` calls it once
with ``me = arange(T)``), so a route is two rounds of tile-led tensor
ops: the geometry, the line's claims through ``comm.all_gather``, then
``admit`` and ``bin_by_owner``, and the all-to-all.  All counts are int32.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.queues import histogram
from repro_torch.core.routing import bin_by_owner, route_tasks
from repro_torch.noc.topology import (CLASS_PORT, N_CHANNELS, admit,
                                      grid_shape, line_link_classes,
                                      line_usage)

I32 = torch.int32


class NetRouted(NamedTuple):
    """One network round plus each tile's telemetry (tile-led tensors).

    recv / recv_valid / spill / spill_valid match ``core.routing.Routed``
    (a grid route's spill is the X leg's ``N`` rows then the Y leg's
    ``T * capacity`` rows at the waypoint); ``sent`` (T,) messages
    delivered to their owner this round (a grid route counts the Y leg's
    completions); ``link_flits`` (T, num_links) flits each tile pushed
    onto each link; ``hop_hist`` (T, max_hops+1) and ``die_hist``
    (T, max_die_crossings+1) histograms of the remaining hops and die
    crossings of every fabric injection.
    """

    recv: torch.Tensor
    recv_valid: torch.Tensor
    spill: torch.Tensor
    spill_valid: torch.Tensor
    sent: torch.Tensor
    link_flits: torch.Tensor
    hop_hist: torch.Tensor
    die_hist: torch.Tensor


@dataclasses.dataclass(frozen=True)
class IdealAllToAll:
    """The single-round perfect fabric (endpoint contention only)."""

    T: int
    name = "ideal"

    @property
    def num_links(self) -> int:
        return self.T  # ingress port of each tile

    @property
    def max_hops(self) -> int:
        return 1

    @property
    def max_die_crossings(self) -> int:
        return 0

    @property
    def link_classes(self) -> np.ndarray:
        """Crossbar ingress ports: switch energy per flit, no wire."""
        return np.full(self.num_links, CLASS_PORT, np.int32)

    def route(self, comm, msgs, valid, capacity: int, dest_fn) -> NetRouted:
        T = self.T
        dest = comm.run(lambda _me, m: dest_fn(m).clamp(0, T - 1), msgs)
        r = route_tasks(comm, msgs, valid, dest, capacity)

        def telemetry(_me, d, v, spill_v, n_sent):
            link = histogram(d, v & ~spill_v, T)  # per-ingress-port flits
            hop = torch.stack([torch.zeros_like(n_sent), n_sent], dim=1)
            return link, hop, n_sent[:, None]  # die_hist: all in bin 0

        link, hop, die = comm.run(telemetry, dest, valid, r.spill_valid,
                                  r.sent)
        return NetRouted(r.recv, r.recv_valid, r.spill, r.spill_valid,
                         r.sent, link, hop, die)

    def pressure(self, me, link_flits):
        """Occupancy of each tile's own ingress port last round:
        ``link_flits[t, me[t]]`` for (T, num_links) ``link_flits``."""
        return link_flits.gather(1, me.to(torch.int64)[:, None])[:, 0]

    def pressure_limit(self, cfg, route_caps=None) -> int:
        """TSU "fabric hot" threshold: ingress near the combined
        per-destination slot bound of the program's routing legs."""
        if route_caps is None:
            route_caps = (cfg.cap_route_range, cfg.cap_route_update)
        return (3 * self.T * sum(route_caps)) // 4


def _die_coord(pos, seg: int):
    """Die index of a line position under segment length ``seg`` (0: the
    axis is not segmented, every position is die 0)."""
    return pos // seg if seg > 0 else torch.zeros_like(pos)


class LineTables(NamedTuple):
    """One line's geometry for every (source, destination) pair, indexed
    by ``a * n + b``: the hop count (n*n,) int32, the die boundaries
    crossed (n*n,) int32 and the links used (n*n, N_CHANNELS, n) bool."""

    hops: torch.Tensor
    cross: torch.Tensor
    use: torch.Tensor

    def use_of(self, pair):
        """(..., N_CHANNELS, n) bool links of the messages at ``pair``:
        the table's rows gathered as n int32 words each (the same bytes)."""
        k, c, n = self.use.shape
        words = self.use.reshape(k, c * n).view(torch.int32)[pair]
        return words.view(torch.bool).view(pair.shape + (c, n))


@functools.lru_cache(maxsize=64)
def line_tables(n: int, wrap: bool, ruche: int, die: int,
                device: str) -> LineTables:
    """:class:`LineTables` of one line, from :func:`line_usage` on all n*n
    pairs (a route then reads its messages' rows: one gather instead of
    the elementwise masks, the same values)."""
    pos = torch.arange(n, dtype=I32)
    a = pos.repeat_interleave(n)
    b = pos.repeat(n)
    hops, use = line_usage(a, b, n, wrap, ruche, die)
    cross = (_die_coord(b, die) - _die_coord(a, die)).abs()
    return LineTables(hops.to(device), cross.to(device), use.to(device))


@functools.lru_cache(maxsize=64)
def _earlier_on_line(T: int, cols: int, device: str):
    """(T, T) bool masks of the tiles ahead of each tile in the tile-major
    admission order of its row line (X) and of its column line (Y)."""
    t = torch.arange(T)
    r, c = t // cols, t % cols
    x = (r[None] == r[:, None]) & (c[None] < c[:, None])
    y = (c[None] == c[:, None]) & (r[None] < r[:, None])
    return x.to(device), y.to(device)


def _line_base(all_claims, earlier):
    """Standing claims of the tiles earlier on each tile's line: the
    (T, T, C, L) all-gathered claims summed over the tiles of each row of
    the (T, T) ``earlier`` mask, in int32."""
    return torch.where(earlier[:, :, None, None], all_claims, 0) \
        .sum(dim=1, dtype=I32)


def _leg_links(tab: LineTables, src, dst, sent_mask, line, n_lines):
    """(T, n_lines * C * L) flits each tile pushed onto each link of its
    ``line`` (the tile's row for the X leg, its column for the Y leg): the
    sent messages counted by destination position ``dst`` (T, N), times
    the links of each (``src`` (T,), destination) pair, which is the sum
    of the sent messages' link masks."""
    T = dst.shape[0]
    k, c, n = tab.use.shape
    counts = _count_values(dst, sent_mask, n)
    links = tab.use.view(n, n, c * n)[src.to(torch.int64)].to(I32)
    mine = (counts[:, :, None] * links).sum(dim=1, dtype=I32)
    out = torch.zeros((T, n_lines, c * n), dtype=I32, device=dst.device)
    out[torch.arange(T, device=dst.device), line.to(torch.int64)] = mine
    return out.reshape(T, -1)


def _count_values(x, mask, n: int):
    """(T, n) int32 counts of the values 0..n-1 of (T, N) ``x`` where
    ``mask`` holds: ``histogram`` for a few bins, as one comparison a bin
    and a sum (no atomics on a few hot bins)."""
    bins = torch.arange(n, dtype=x.dtype, device=x.device)
    return ((x[..., None] == bins) & mask[..., None]).sum(dim=1, dtype=I32)


@dataclasses.dataclass(frozen=True)
class _Grid2D:
    """Shared machinery of the physical (rows, cols) backends."""

    T: int
    rows: int
    cols: int
    link_cap: int = 0  # flits per directed link per leg; 0 = unlimited
    name = "grid"
    wrap = False

    def __post_init__(self):
        if self.rows * self.cols != self.T:
            raise ValueError(f"{self.rows}x{self.cols} grid != {self.T} tiles")

    @property
    def ruche(self) -> int:
        return 0

    @property
    def die_x(self) -> int:
        """Die segment length of the X (row) lines; 0 = unsegmented."""
        return 0

    @property
    def die_y(self) -> int:
        """Die segment length of the Y (column) lines; 0 = unsegmented."""
        return 0

    @property
    def num_links(self) -> int:
        return 2 * N_CHANNELS * self.T  # X block + Y block

    @property
    def max_hops(self) -> int:
        if self.wrap:
            return max(self.cols // 2 + self.rows // 2, 1)
        return max(self.cols - 1 + self.rows - 1, 1)

    @property
    def max_die_crossings(self) -> int:
        return 0  # single-die grids: die_hist is one bin

    @property
    def link_classes(self) -> np.ndarray:
        """Per-link cost class in the link index space (X block then Y
        block)."""
        x = np.broadcast_to(line_link_classes(self.cols, self.wrap,
                                              self.die_x),
                            (self.rows, N_CHANNELS, self.cols))
        y = np.broadcast_to(line_link_classes(self.rows, self.wrap,
                                              self.die_y),
                            (self.cols, N_CHANNELS, self.rows))
        return np.concatenate([x.reshape(-1), y.reshape(-1)])

    def route(self, comm, msgs, valid, capacity: int, dest_fn) -> NetRouted:
        T, rows, cols = self.T, self.rows, self.cols
        wrap, ruche, cap = self.wrap, self.ruche, self.link_cap
        die_x, die_y = self.die_x, self.die_y
        n_hop = self.max_hops + 1
        n_die = self.max_die_crossings + 1
        dev = str(msgs.device)
        earlier_x, earlier_y = _earlier_on_line(T, cols, dev)
        tab_x = line_tables(cols, wrap, ruche, die_x, dev)
        tab_y = line_tables(rows, wrap, ruche, die_y, dev)

        # Link capacity is global: tiles sharing a line admit in tile-major
        # FIFO order, each counting the (conservative) claims of every
        # earlier tile on that line, shared by one all_gather per leg.
        # Uncapped links admit everything, so no claims are gathered.

        def x_geom(me, m, v):
            r_me, c_me = (me // cols)[:, None], (me % cols)[:, None]
            d = dest_fn(m).clamp(0, T - 1)
            dr, dc = d // cols, d % cols
            px = (c_me * cols + dc).to(torch.int64)  # X line pair
            py = (r_me * rows + dr).to(torch.int64)  # Y line pair
            # the link masks only where the links are capped (admission)
            use_x = tab_x.use_of(px) if cap > 0 else None
            claims = (use_x & v[..., None, None]).sum(dim=1, dtype=I32) \
                if cap > 0 else None
            return (dc, tab_x.hops[px] + tab_y.hops[py],
                    tab_x.cross[px] + tab_y.cross[py], use_x, claims)

        def phase_x(me, m, v, dc, hops, cross, use_x, base):
            # X leg: ride the own row line to the destination column, and
            # histogram the full X+Y hop distance and the die crossings of
            # every admitted injection
            r_me, c_me = me // cols, me % cols
            ok = admit(use_x, v, cap, base)
            buf, _, ep_spill, _ = bin_by_owner(
                m, v & ok, r_me[:, None] * cols + dc, T, capacity)
            sent_mask = (v & ok) & ~ep_spill
            spill_v = v & ~sent_mask
            lx = _leg_links(tab_x, c_me, dc, sent_mask, r_me, rows)
            hop = _count_values(hops, sent_mask, n_hop)
            die = _count_values(cross, sent_mask, n_die)
            return buf, m, spill_v, lx, hop, die

        def x_base(me, all_claims):
            return _line_base(all_claims, earlier_x[me.to(torch.int64)])

        dc, hops, cross, use_x, claims_x = comm.run(x_geom, msgs, valid)
        base_x = comm.run(x_base, comm.all_gather(claims_x)) \
            if cap > 0 else None
        bufx, spill1, spill1_v, lx, hop, die = comm.run(
            phase_x, msgs, valid, dc, hops, cross, use_x, base_x)
        del use_x
        mid = comm.a2a(bufx)

        def y_geom(me, rec):
            r_me = (me // cols)[:, None]
            v = rec[..., 0] >= 0
            dr = dest_fn(rec).clamp(0, T - 1) // cols
            use_y = tab_y.use_of((r_me * rows + dr).to(torch.int64)) \
                if cap > 0 else None
            claims = (use_y & v[..., None, None]).sum(dim=1, dtype=I32) \
                if cap > 0 else None
            return dr, use_y, claims

        def phase_y(me, rec, dr, use_y, base):
            # Y leg from the waypoint (src_row, dst_col), which is this
            # tile for every message that arrived through the X leg
            r_me, c_me = me // cols, me % cols
            v = rec[..., 0] >= 0
            ok = admit(use_y, v, cap, base)
            buf, _, ep_spill, _ = bin_by_owner(
                rec, v & ok, dr * cols + c_me[:, None], T, capacity)
            sent_mask = (v & ok) & ~ep_spill
            spill_v = v & ~sent_mask
            ly = _leg_links(tab_y, r_me, dr, sent_mask, c_me, cols)
            return buf, rec, spill_v, sent_mask.sum(dim=1, dtype=I32), ly

        def y_base(me, all_claims):
            return _line_base(all_claims, earlier_y[me.to(torch.int64)])

        dr, use_y, claims_y = comm.run(y_geom, mid)
        base_y = comm.run(y_base, comm.all_gather(claims_y)) \
            if cap > 0 else None
        # `sent` counts Y-leg completions (messages delivered to their
        # owner this round), so a replay of a mid-route spill is counted
        # once and grid totals reconcile with the ideal backend's
        bufy, spill2, spill2_v, sent, ly = comm.run(
            phase_y, mid, dr, use_y, base_y)
        del use_y
        recv = comm.a2a(bufy)

        spill = torch.cat([spill1, spill2], dim=1)
        spill_v = torch.cat([spill1_v, spill2_v], dim=1)
        link = torch.cat([lx, ly], dim=1)
        return NetRouted(recv, recv[..., 0] >= 0, spill, spill_v, sent,
                         link, hop, die)

    def pressure_limit(self, cfg, route_caps=None) -> int:
        """TSU "fabric hot" threshold: a link sees up to ``link_cap``
        flits a leg and pressure sums every leg of the program's round, so
        hot = 3/4 of n_legs * link_cap; uncapped links fall back to the
        endpoint-saturation bound."""
        if route_caps is None:
            route_caps = (cfg.cap_route_range, cfg.cap_route_update)
        if self.link_cap > 0:
            return (3 * len(route_caps) * self.link_cap) // 4
        return (3 * self.T * sum(route_caps)) // 4

    def pressure(self, me, link_flits):
        """(T,) max occupancy over the links each tile's traffic rides:
        its own row line (X block) and its own column line (Y block), for
        (T, num_links) ``link_flits``."""
        T, rows, cols = self.T, self.rows, self.cols
        t = torch.arange(link_flits.shape[0], device=link_flits.device)
        me = me.to(torch.int64)
        x = link_flits[:, :N_CHANNELS * T].reshape(-1, rows,
                                                   N_CHANNELS * cols)
        y = link_flits[:, N_CHANNELS * T:].reshape(-1, cols,
                                                   N_CHANNELS * rows)
        return torch.maximum(x[t, me // cols].amax(dim=1),
                             y[t, me % cols].amax(dim=1))


@dataclasses.dataclass(frozen=True)
class Mesh2D(_Grid2D):
    name = "mesh"
    wrap = False


@dataclasses.dataclass(frozen=True)
class Torus2D(_Grid2D):
    name = "torus"
    wrap = True


@dataclasses.dataclass(frozen=True)
class Ruche(_Grid2D):
    """Mesh plus express channels skipping ``ruche_factor`` tiles."""

    ruche_factor: int = 2
    name = "ruche"
    wrap = False

    @property
    def ruche(self) -> int:
        return max(self.ruche_factor, 2)


@dataclasses.dataclass(frozen=True)
class Hier2D(_Grid2D):
    """Multi-die NoC: an ``ndies_y x ndies_x`` array of intra-die grids
    joined by DIE-class express links.  ``base`` is the intra-die wiring,
    ``"mesh"`` or ``"torus"`` (each die closes its own rings).  The link
    index space is the flat backends', so one die on a mesh base is
    :class:`Mesh2D` bit for bit.  ``max_hops`` keeps the flat-mesh bound
    on either base (it fixes the hop histogram's shape)."""

    ndies_x: int = 1
    ndies_y: int = 1
    base: str = "mesh"
    name = "hier"

    def __post_init__(self):
        super().__post_init__()
        if self.base not in ("mesh", "torus"):
            raise ValueError(f"hier base must be mesh|torus, got "
                             f"{self.base!r}")
        if (self.ndies_x <= 0 or self.ndies_y <= 0
                or self.cols % self.ndies_x or self.rows % self.ndies_y):
            raise ValueError(
                f"{self.rows}x{self.cols} grid not divisible into "
                f"{self.ndies_y}x{self.ndies_x} dies")

    @property
    def wrap(self) -> bool:
        return self.base == "torus"

    @property
    def die_x(self) -> int:
        return self.cols // self.ndies_x

    @property
    def die_y(self) -> int:
        return self.rows // self.ndies_y

    @property
    def max_hops(self) -> int:
        return max(self.cols - 1 + self.rows - 1, 1)

    @property
    def max_die_crossings(self) -> int:
        return self.ndies_x - 1 + self.ndies_y - 1


def make_network(cfg, T: int):
    """Build the backend selected by ``EngineConfig.noc`` for T tiles."""
    if cfg.noc == "ideal":
        return IdealAllToAll(T)
    rows, cols = grid_shape(T, cfg.noc_rows)
    if cfg.noc == "mesh":
        return Mesh2D(T, rows, cols, cfg.link_cap)
    if cfg.noc == "torus":
        return Torus2D(T, rows, cols, cfg.link_cap)
    if cfg.noc == "ruche":
        return Ruche(T, rows, cols, cfg.link_cap, cfg.ruche_factor)
    if cfg.noc == "hier":
        return Hier2D(T, rows, cols, cfg.link_cap,
                      ndies_x=cfg.ndies_x, ndies_y=cfg.ndies_y,
                      base=cfg.hier_base)
    raise ValueError(f"unknown noc backend {cfg.noc!r}")
