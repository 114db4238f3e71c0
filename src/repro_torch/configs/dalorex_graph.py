"""The paper's own workload presets: graph/sparse datasets x tile grids
(port of ``repro.configs.dalorex_graph``).

They name the graph, the tile grid, the fabric and the placement of a
run; ``python -m repro_torch.trace`` reads them.  The R-MAT scales mirror
the paper's synthetic datasets (Section IV-A), clipped to sizes a host
builds in seconds.  ``backend`` takes the port's values: the reference's
``"xla"`` presets are ``"torch"`` here and its ``"pallas"`` preset is
``"kernels"``.  The ``adapt`` fields are read by the adaptive call sites
(:mod:`repro_torch.place`); the trace CLI, as the reference's, runs a
preset's workload without them.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GraphWorkload:
    name: str
    scale: int            # RMAT scale (V = 2^scale)
    edge_factor: int = 10
    tiles: int = 16       # emulated Dalorex grid size
    apps: tuple = ("bfs", "sssp", "pagerank", "wcc", "spmv")
    # engine execution backend ("torch" | "kernels"): the kernels are
    # bit-identical, so presets differ only in what the run exercises
    backend: str = "torch"
    # NoC fabric + placement: "hier" presets cut the grid into
    # ndies (= (ndies_y, ndies_x)) dies and pair the fabric with a
    # die-local placement so partitions stay die-resident
    noc: str = "ideal"
    ndies: tuple = (1, 1)
    placement: str = "low_order"
    # memory space of the tile's edge shard (repro_torch.mem): "vmem" keeps
    # the shard word-random resident; "hbm" streams it through double-buffered
    # segment-DMA windows of ``hbm_window`` elements (0 = auto-size to the
    # next pow2 >= max_t2) — bit-identical values, per-space pricing
    edge_space: str = "vmem"
    hbm_window: int = 0
    # telemetry-driven adaptive placement (repro_torch.place): relabel hot
    # vertices at epoch/query boundaries, at most ``adapt_budget`` moved
    # vertices per plan, every ``adapt_every`` epochs/batches
    adapt: bool = False
    adapt_every: int = 4
    adapt_budget: int = 64


PRESETS = {
    # laptop-scale stand-ins for the paper's datasets
    "rmat-small": GraphWorkload("rmat-small", scale=10),
    "rmat-medium": GraphWorkload("rmat-medium", scale=14),
    "rmat-large": GraphWorkload("rmat-large", scale=16, tiles=64),
    # amazon-like: V=262k, E~1.2M -> scale 18 ef 5 approximates the shape
    "amazon-like": GraphWorkload("amazon-like", scale=18, edge_factor=5,
                                 tiles=64),
    # the tile-grid kernel path end to end (kernels/engine)
    "rmat-small-pallas": GraphWorkload("rmat-small-pallas", scale=10,
                                       backend="kernels"),
    # the multi-die composition: an 8x8 grid as 2x2 dies of 4x4 meshes,
    # die-local placement (the shape the paper's >16k-tile scaling story
    # implies; DESIGN.md "Hierarchical NoC")
    "rmat-hier": GraphWorkload("rmat-hier", scale=12, tiles=64,
                               noc="hier", ndies=(2, 2),
                               placement="low_order_dielocal"),
    # rmat-hier with the trace -> placement loop closed: epoch/query
    # boundaries migrate hot vertices die-aware within the budget
    # (DESIGN.md "Adaptive placement")
    "rmat-hier-adapt": GraphWorkload("rmat-hier-adapt", scale=12, tiles=64,
                                     noc="hier", ndies=(2, 2),
                                     placement="low_order_dielocal",
                                     adapt=True, adapt_every=2,
                                     adapt_budget=128),
    # HBM-resident edge shards (DESIGN.md "Memory spaces"): the per-tile
    # edge segments stream through double-buffered segment DMA instead of
    # assuming the shard fits the tile's VMEM — the beyond-VMEM scaling
    # path (triangles pins its shard to VMEM, so the apps here are the
    # streaming-compatible five + kcore)
    "rmat-small-hbm": GraphWorkload("rmat-small-hbm", scale=10,
                                    edge_space="hbm"),
    # the strong-scaling shape: a shard too big for a paper-era tile SRAM,
    # end to end out of HBM
    "rmat-large-hbm": GraphWorkload("rmat-large-hbm", scale=16, tiles=64,
                                    edge_space="hbm", hbm_window=128),
}


def get_workload(name: str) -> GraphWorkload:
    return PRESETS[name]
