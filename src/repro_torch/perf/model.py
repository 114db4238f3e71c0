"""First-order cycle and energy cost model (port of ``repro.perf.model``).

Every constant here is a parameter of the *modelled* Dalorex tile (22nm-era
estimates in tile cycles and picojoules), not a measurement of any device.
The arithmetic is float32 and eager, in the reference's operation order,
with Python-number constants where the reference has them, so the port's
``Stats.cycles`` / ``Stats.energy_pj`` match the reference bit for bit:

  cycles_round = t_round + max over tiles of (pops*t_pop + pushes*t_push
                 + spill_replays*t_spill + edges*t_scan + updates*t_fold)
                 + max over links of (flits * t_hop(link_class))
  energy_round = edges*e_scan + updates*e_fold + msgs*(e_push + e_pop)
                 + spills*e_spill + sum over links of (flits*e_hop(class))
                 + T * cycles_round * e_leak_tile_cycle
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.noc.topology import (CLASS_DIE, CLASS_LOCAL, CLASS_PORT,
                                      CLASS_RUCHE, CLASS_WRAP,
                                      N_LINK_CLASSES)
from repro_torch.trace.export import LINK_CLASS_NAMES, trace_metrics
from repro_torch.trace.export import host as _host


@dataclasses.dataclass(frozen=True)
class PerfParams:
    """Per-op cycle/energy constants of the modelled tile (~1 GHz,
    22nm-era estimates; cycles in tile cycles, energies in pJ).  Same
    fields and defaults as the reference; every field is overridable."""

    f_ghz: float = 1.0
    # --- cycle costs ---
    t_alu: int = 1
    t_sram: int = 2
    t_pop: int = 1
    t_push: int = 1
    t_spill: int = 2
    t_hop_local: int = 1
    t_hop_ruche: int = 1
    t_hop_wrap: int = 2
    t_hop_port: int = 0
    t_hop_die: int = 4
    t_hbm: int = 4
    t_round: int = 1
    t_migrate: int = 2
    # --- energy costs (pJ) ---
    e_alu: float = 0.5
    e_sram: float = 5.0
    e_pop: float = 1.0
    e_push: float = 1.0
    e_spill: float = 2.0
    e_hop_local: float = 2.0
    e_hop_ruche: float = 4.0
    e_hop_wrap: float = 5.0
    e_hop_port: float = 2.0
    e_hop_die: float = 12.0
    e_hbm: float = 250.0
    e_migrate: float = 10.0
    e_leak_tile_cycle: float = 0.05

    @property
    def t_scan(self) -> int:
        return self.t_sram + self.t_alu

    @property
    def t_fold(self) -> int:
        return 2 * self.t_sram + self.t_alu

    @property
    def e_scan(self) -> float:
        return self.e_sram + self.e_alu

    @property
    def e_fold(self) -> float:
        return 2 * self.e_sram + self.e_alu

    def hop_cycle_table(self) -> np.ndarray:
        t = np.zeros(N_LINK_CLASSES, np.float32)
        t[CLASS_LOCAL] = self.t_hop_local
        t[CLASS_RUCHE] = self.t_hop_ruche
        t[CLASS_WRAP] = self.t_hop_wrap
        t[CLASS_PORT] = self.t_hop_port
        t[CLASS_DIE] = self.t_hop_die
        return t

    def hop_energy_table(self) -> np.ndarray:
        e = np.zeros(N_LINK_CLASSES, np.float32)
        e[CLASS_LOCAL] = self.e_hop_local
        e[CLASS_RUCHE] = self.e_hop_ruche
        e[CLASS_WRAP] = self.e_hop_wrap
        e[CLASS_PORT] = self.e_hop_port
        e[CLASS_DIE] = self.e_hop_die
        return e


def link_cost_vectors(params: PerfParams, net, device="cuda"):
    """``(t_hop, e_hop)``: two (num_links,) float32 tensors pricing each
    directed link by its class.  The tables are cast to float32 on the
    host, as the reference's 32-bit arrays are."""
    cls = np.asarray(net.link_classes)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)
    return f32(params.hop_cycle_table()[cls]), \
        f32(params.hop_energy_table()[cls])


def tile_compute_cycles(params: PerfParams, pops, pushes, spill_replays,
                        edges, updates, hbm_edges=None):
    """Per-tile compute cycles of one round (float32, tile-shaped)."""
    f = torch.float32
    out = (pops.to(f) * params.t_pop
           + pushes.to(f) * params.t_push
           + spill_replays.to(f) * params.t_spill
           + edges.to(f) * params.t_scan
           + updates.to(f) * params.t_fold)
    if hbm_edges is not None:
        out = out + hbm_edges.to(f) * params.t_hbm
    return out


def leak_pj(params: PerfParams, T: int, cycles: torch.Tensor):
    """Static leakage over ``cycles`` on a T-tile grid."""
    return _leak_rate(T * params.e_leak_tile_cycle, cycles.device) * cycles


@functools.lru_cache(maxsize=32)
def _leak_rate(rate: float, device: torch.device) -> torch.Tensor:
    """The float32 leakage rate on ``device``, made once: a tensor made
    from a host number each round is a host-to-device copy, which waits
    for the round's kernels."""
    return torch.tensor(rate, dtype=torch.float32, device=device)


def round_energy_pj(params: PerfParams, T: int, edges_g, updates_g,
                    msgs_total, spills_total, link_flits_g, e_hop,
                    cycles_round, hbm_edges_g=None):
    """Global energy of one round, linear in the round's Stats
    increments (globals of one run, or lane-led ``(B, ...)`` ones: the
    links are the last axis)."""
    f = torch.float32
    out = (edges_g.to(f) * params.e_scan
           + updates_g.to(f) * params.e_fold
           + msgs_total.to(f) * (params.e_push + params.e_pop)
           + spills_total.to(f) * params.e_spill
           + (link_flits_g.to(f) * e_hop).sum(dim=-1)
           + leak_pj(params, T, cycles_round))
    if hbm_edges_g is not None:
        out = out + hbm_edges_g.to(f) * params.e_hbm
    return out


def flits_by_class(stats, net) -> dict:
    """Cumulative flit traversals per link class of an accumulated Stats:
    ``{class_name: flits}`` over the classes that exist on ``net``.  On
    the hier fabric ``out["die"]`` is the die-to-die traffic the die-local
    placements and the planner's die phase (:mod:`repro_torch.place`)
    work to cut."""
    cls = np.asarray(net.link_classes)
    flits = _host(stats.flits_per_link).astype(np.int64)
    return {LINK_CLASS_NAMES[c]: int(flits[cls == c].sum())
            for c in sorted(set(cls.tolist()))}


def die_crossing_frac(stats) -> float:
    """Fraction of fabric injections that crossed at least one die
    boundary (0.0 on single-die fabrics and on runs with no traffic)."""
    hist = _host(stats.die_crossings).astype(np.int64)
    return float(hist[1:].sum()) / max(int(hist.sum()), 1)


def migration_cost(params: PerfParams, words_intra: int,
                   words_cross: int) -> tuple[float, float]:
    """Price a migration plan (:mod:`repro_torch.place`): modelled
    ``(cycles, pJ)`` as Python floats.  Every 64-bit word moved pays the
    paired SRAM read and write (``t_migrate`` / ``e_migrate``); a word
    that crosses a die boundary also pays one die-class hop."""
    words = float(words_intra) + float(words_cross)
    cycles = params.t_migrate * words + params.t_hop_die * float(words_cross)
    pj = params.e_migrate * words + params.e_hop_die * float(words_cross)
    return cycles, pj


def energy_from_totals(stats, params: PerfParams, net, T: int) -> float:
    """Total energy recomputed from the final Stats counters, on the host:
    the oracle of the accumulated ``Stats.energy_pj`` (and of
    ``price_migration``, which must keep it true)."""
    _, e_hop = link_cost_vectors(params, net, device="cpu")
    edges = float(_host(stats.edges_scanned))
    updates = float(_host(stats.updates_applied))
    msgs = float(_host(stats.msgs).sum())
    spills = float(_host(stats.spills).sum())
    flits = _host(stats.flits_per_link).astype(np.float64)
    cycles = float(_host(stats.cycles))
    hbm_edges = float(_host(getattr(stats, "hbm_edges", 0)))
    migration_pj = float(_host(getattr(stats, "migration_pj", 0)))
    leak = leak_pj(params, T, torch.tensor(np.float32(cycles)))
    return (edges * params.e_scan + updates * params.e_fold
            + msgs * (params.e_push + params.e_pop)
            + spills * params.e_spill
            + float((flits * e_hop.numpy().astype(np.float64)).sum())
            + float(leak)
            + hbm_edges * params.e_hbm
            + migration_pj)


def serving_metrics(queries: int, cycles: float, energy_pj: float,
                    edges: int, params: PerfParams = None) -> dict:
    """Throughput columns of a serving run (:mod:`repro_torch.serve`):
    many queries sharing one makespan.  ``cycles`` and ``energy_pj`` are
    the shared run's batch clock and batch energy (not sums over lanes:
    lanes share the tiles, so per-lane cycles count the round overhead
    again), ``edges`` the edges scanned over all lanes.  Returns
    queries/s (``qps``), modelled joules a query (``j_per_query``) and
    the aggregate ``gteps`` on the same clock."""
    params = params or PerfParams()
    time_s = cycles / (params.f_ghz * 1e9)
    return {
        "cycles": int(round(cycles)),
        "time_model_s": round(time_s, 9),
        "qps": round(queries / time_s, 1) if time_s > 0 else 0.0,
        "gteps": round(edges / time_s / 1e9, 6) if time_s > 0 else 0.0,
        "energy_pj": round(energy_pj, 1),
        "j_per_query": round(energy_pj * 1e-12 / queries, 15)
        if queries else 0.0,
    }


def derived_metrics(stats, params: PerfParams = None, T: int = None,
                    trace=None) -> dict:
    """Time, throughput and energy columns of an accumulated Stats.

    ``params`` must be the run's ``cfg.perf`` where it was overridden (the
    clock and leak constants live here, not in Stats).  ``time_model_s``
    is modelled cycles over the tile clock, ``gteps`` giga traversed edges
    a modelled second (``edges_scanned``, the paper's TEPS), ``pj_per_edge``
    the energy ladder's metric.  With ``T``, the leakage share
    (``leak_pj``, ``leak_frac``) by the :func:`leak_pj` the accumulator
    priced it with.  A run whose edge shard streamed from HBM adds the
    split of its energy by space; a ``trace`` (a captured ring) adds
    :func:`repro_torch.trace.export.trace_metrics`'s two columns."""
    params = params or PerfParams()
    cycles = float(_host(stats.cycles))
    edges = float(_host(stats.edges_scanned))
    energy = float(_host(stats.energy_pj))
    time_s = cycles / (params.f_ghz * 1e9)
    out = {
        "cycles": int(round(cycles)),
        "time_model_s": round(time_s, 9),
        "gteps": round(edges / time_s / 1e9, 6) if time_s > 0 else 0.0,
        "energy_pj": round(energy, 1),
        "pj_per_edge": round(energy / edges, 3) if edges > 0 else 0.0,
    }
    if T is not None:
        lk = float(leak_pj(params, T, torch.tensor(np.float32(cycles))))
        out["leak_pj"] = round(lk, 1)
        out["leak_frac"] = round(lk / energy, 3) if energy > 0 else 0.0
    hbm_edges = float(_host(getattr(stats, "hbm_edges", 0)))
    if hbm_edges > 0:
        hbm_pj = hbm_edges * params.e_hbm
        out["hbm_pj"] = round(hbm_pj, 1)
        out["hbm_frac"] = round(hbm_pj / energy, 3) if energy > 0 else 0.0
        if edges > 0:
            out["pj_per_edge_hbm"] = round(hbm_pj / edges, 3)
            out["pj_per_edge_sram"] = round((energy - hbm_pj) / edges, 3)
    if trace is not None:
        out.update(trace_metrics(trace))
    return out
