"""Multi-tenant query serving over the resident graph (port of
``repro.serve``).

* :mod:`repro_torch.serve.lanes`: the machine side, a batch of B point
  queries through one round loop as *query lanes*, each lane bitwise its
  solo run, priced on a shared batch clock.
* :mod:`repro_torch.serve.frontend`: the service side, request queue,
  batch formation (static or continuous lane recycling), latency
  accounting on the modelled cycle clock.
* ``python -m repro_torch.serve``: the CLI (:mod:`repro_torch.serve.
  __main__`).
"""
from repro_torch.serve.frontend import (Frontend, QueryRecord, ServeReport,
                                        arrival_cycles)
from repro_torch.serve.lanes import (BatchResult, LaneCarry, batch_min_state,
                                     lane_carry, lane_loop, lane_state,
                                     lane_values, local_lanes_call,
                                     local_lanes_segment, multi_source,
                                     spmd_lanes_call)

__all__ = [
    "BatchResult", "Frontend", "LaneCarry", "QueryRecord", "ServeReport",
    "arrival_cycles", "batch_min_state", "lane_carry", "lane_loop",
    "lane_state", "lane_values", "local_lanes_call", "local_lanes_segment",
    "multi_source", "spmd_lanes_call",
]
