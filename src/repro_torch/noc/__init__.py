"""NoC subsystem of the port: topology-aware routing for the engine (the
ideal crossbar and the physical mesh / torus / ruche / hier grids).

See :mod:`repro_torch.noc.network` for the backend contract and
:mod:`repro_torch.noc.topology` for the grid and link model.
"""
from repro_torch.noc.network import (Hier2D, IdealAllToAll, Mesh2D,
                                     NetRouted, Ruche, Torus2D, make_network)
from repro_torch.noc.topology import (DIE_BWD, DIE_FWD, LOCAL_BWD, LOCAL_FWD,
                                      N_CHANNELS, RUCHE_BWD, RUCHE_FWD, admit,
                                      grid_shape, line_usage, tile_die_map)

__all__ = [
    "IdealAllToAll", "Mesh2D", "Torus2D", "Ruche", "Hier2D", "NetRouted",
    "make_network", "grid_shape", "line_usage", "admit", "tile_die_map",
    "N_CHANNELS", "LOCAL_FWD", "LOCAL_BWD", "RUCHE_FWD", "RUCHE_BWD",
    "DIE_FWD", "DIE_BWD",
]
