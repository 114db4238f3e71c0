"""NoC subsystem of the port: the ideal crossbar (``noc="ideal"``)."""
from repro_torch.noc.network import (IdealAllToAll, NetRouted,  # noqa: F401
                                     make_network)
