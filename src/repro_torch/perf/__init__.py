"""Cycle/energy cost model of the modelled Dalorex tile (port)."""
from repro_torch.perf.model import (PerfParams, derived_metrics,  # noqa
                                    leak_pj, link_cost_vectors,
                                    round_energy_pj, serving_metrics,
                                    tile_compute_cycles)
