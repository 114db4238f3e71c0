"""The engine round's Hopper kernels (``frontier_pop``, ``queue_push_pop``,
``edge_scan_gather``, ``fold_scatter``), their plain PyTorch versions and
launch accounting.  See :mod:`repro_torch.kernels.engine.kernel`."""
from repro_torch.kernels.engine.kernel import (  # noqa: F401
    KERNELS, LIBRARY, edge_scan_gather, fifo_turn, fold_scatter,
    frontier_pop, frontier_take, queue_push_pop, scatter_body, segment_gather)
from repro_torch.kernels.engine.launches import record, tally  # noqa: F401
