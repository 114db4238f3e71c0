"""NoC backends (port of ``repro.noc.network``, ideal crossbar only).

A Network turns "route these messages to their owners" into a fabric
model with the contract ``route(comm, msgs, valid, capacity, dest_fn) ->
NetRouted``, where ``dest_fn`` decodes the destination tile from the head
flit.  :class:`IdealAllToAll` is one perfect crossbar round: contention
only at the endpoint slots, and its "links" are the T ingress ports.  The
mesh / torus / ruche / hier backends are still to port.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.queues import histogram
from repro_torch.core.routing import route_tasks
from repro_torch.noc.topology import CLASS_PORT


class NetRouted(NamedTuple):
    """One network round plus each tile's telemetry (tile-led tensors).

    recv / recv_valid / spill / spill_valid match ``core.routing.Routed``;
    ``sent`` (T,) messages delivered; ``link_flits`` (T, num_links) flits
    each tile pushed onto each link; ``hop_hist`` (T, max_hops+1) and
    ``die_hist`` (T, max_die_crossings+1) injection histograms.
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


def make_network(cfg, T: int):
    """Build the backend selected by ``EngineConfig.noc``."""
    if cfg.noc == "ideal":
        return IdealAllToAll(T)
    raise NotImplementedError(
        f"noc={cfg.noc!r} is still to port (ROADMAP.md, 'Physical NoCs'); "
        f"the port runs noc='ideal'")
