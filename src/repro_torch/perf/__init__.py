"""Cycle/energy cost model of the modelled Dalorex tile (port)."""
from repro_torch.perf.model import (PerfParams, leak_pj,  # noqa: F401
                                    link_cost_vectors, round_energy_pj,
                                    tile_compute_cycles)
