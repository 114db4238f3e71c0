"""Query lanes: a batch of B point queries through one round loop (port of
``repro.serve.lanes``).

The engine of :mod:`repro_torch.core.engine` runs one program over one
resident graph.  A serving deployment answers many point queries (BFS /
SSSP sources) against that graph; the answer to small-message
underuse of the tiles is a *query-lane axis*: B independent traversals
share the resident shard, the round loop, the NoC and the TSU.  The
reference ``jax.vmap``s its round over the lanes; here the round itself
takes them (:class:`~repro_torch.core.comm.LaneComm`): the state holds B *
T lane-major rows over the one ``(T, ...)`` shard, which is never copied a
lane, every collective acts within a lane, and each leg of the round is
one kernel launch for the whole batch (the kernels that read the shard
read row ``row % T``).

Bit-identity contract.  Each lane's trajectory is exactly its solo run's:
a lane whose own pending work (:func:`~repro_torch.core.engine.
pending_work`) reaches zero is *frozen*: its Stats and Kahan compensation
are kept by :func:`~repro_torch.core.engine.lane_select`, its vertex
slices and queue counts by :func:`~repro_torch.core.engine.keep_frozen`,
and its trace ring records only while it runs.  So each lane's values and
every Stats field, ``launches`` included, equal a solo
:func:`repro_torch.core.algorithms.bfs` / ``sssp`` run at the same config
and backend.  The batch finishes in ``max_i rounds_i`` shared rounds
instead of ``sum_i rounds_i``.

Batch clock.  Lanes time-multiplex the tiles, so the batch makespan pays
the fixed round overhead once and every active lane's marginal work::

    cyc_round = t_round + sum over active lanes of (d_cyc_lane - t_round)
    en_round  = sum(d_en_lane - leak_pj(T, d_cyc_lane)) + leak_pj(T, cyc_round)

Both are Kahan sums in float32 eager torch ops on the host, each lane sum
folded in lane order; at B = 1 they are the solo accumulators bit for
bit.  The host reads each lane's pending work and its two increments
back once a round, in one copy (the round loop's one sync, as
:func:`~repro_torch.core.engine.run_engine` has).

``done_round`` / ``done_cycle`` record, per lane, the shared round and the
batch clock at which the lane finished: the completion side of the front
end's latency accounting (:mod:`repro_torch.serve.frontend`).

On a mesh (``spmd_lanes_call``, ``multi_source(..., mesh=)``) the tiles
are processes (:class:`~repro_torch.core.comm.LaneAxisComm`): each runs
all B lanes of its own tile, B rows over its one-row shard, and every
process holds the same lane-led globals, so the host loops take the same
rounds everywhere.  The result is every process's, bitwise the
emulated run's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.algorithms import spmd_rows, to_device
from repro_torch.core.comm import LaneAxisComm, LaneComm
from repro_torch.core.engine import (EngineConfig, EngineState, GraphShard,
                                     Stats, init_state, keep_frozen,
                                     lane_select, make_round, pending_work)
from repro_torch.core.graph import PartitionedGraph
from repro_torch.core.program import BFS, INF, SSSP, as_program
from repro_torch.noc import make_network
from repro_torch.perf import leak_pj
from repro_torch.trace.buffer import zero_lane_trace

F32, I32 = torch.float32, torch.int32
POINT_QUERIES = {"bfs": BFS, "sssp": SSSP}


class LaneCarry(NamedTuple):
    """The batched round loop's carry.  The state, Stats and compensation
    live on the device, lane-led; the per-lane pending work and the batch
    counters live on the host, where the loop decides."""

    st: EngineState        # B * T lane-major rows
    stats: Stats           # lane-led (B, ...) per-query Stats
    kcomp: tuple           # ((B,) f32, (B,) f32) per-lane compensation
    pending: torch.Tensor  # (B,) i32, host: each lane's pending work
    rounds: int            # shared batch rounds so far
    clock: torch.Tensor    # () f32, host: batch makespan, modelled cycles
    clock_c: torch.Tensor  # () f32, host: Kahan compensation of `clock`
    energy: torch.Tensor   # () f32, host: batch energy, pJ
    energy_c: torch.Tensor  # () f32, host: Kahan compensation of `energy`
    done_round: torch.Tensor  # (B,) i32, host: round a lane finished at
                              # (-1 = still running)
    done_cycle: torch.Tensor  # (B,) f32, host: batch clock at completion
    halt: bool             # segment stop flag (continuous mode)
    trace: object = None   # lane-led TraceBuf when cfg.trace


def lane_state(comm: LaneComm, cfg: EngineConfig, v_chunk: int, value,
               frontier, alg, acc=None) -> EngineState:
    """:func:`~repro_torch.core.engine.init_state` of ``comm.lanes`` lanes:
    ``value`` / ``frontier`` / ``acc`` are ``(B, T, v_chunk)`` on the
    comm's device, laid out as B * T lane-major rows (``(B, 1, v_chunk)``
    of this process's tile under :class:`LaneAxisComm`: B rows)."""
    def rows(x):
        return None if x is None else x.reshape(comm.rows, v_chunk)
    return init_state(comm, cfg, v_chunk, rows(value), rows(frontier), alg,
                      rows(acc))


def _zero_host(*shape, dtype=F32):
    return torch.zeros(shape, dtype=dtype)


def lane_carry(comm: LaneComm, net, cfg: EngineConfig, prog,
               st: EngineState) -> LaneCarry:
    """A fresh carry for a lane-led state: each lane's pending work by the
    engine's own :func:`pending_work`, zero Stats a lane, batch clocks at
    zero.  A lane with no pending work (a padding lane) is born finished:
    ``done_round = 0``."""
    prog = as_program(prog)
    pend0 = comm.to_global(comm.psum(comm.run(pending_work, st))).cpu()
    B = comm.lanes
    z = Stats.zero(net.num_links, net.max_hops, len(prog.channels),
                   net.max_die_crossings, comm.device)
    stats = Stats(*(x[None].expand((B,) + tuple(x.shape)).clone()
                    for x in z))
    zf = torch.zeros((B,), dtype=F32, device=comm.device)
    trace = (zero_lane_trace(cfg, comm.size, prog, B, comm.device)
             if cfg.trace else None)
    return LaneCarry(
        st=st, stats=stats, kcomp=(zf, zf.clone()), pending=pend0,
        rounds=0, clock=_zero_host(), clock_c=_zero_host(),
        energy=_zero_host(), energy_c=_zero_host(),
        done_round=torch.where(pend0 > 0, -1, 0).to(I32),
        done_cycle=_zero_host(B), halt=False, trace=trace)


def _kahan(total, comp, inc):
    """Compensated float32 accumulation: (new_total, new_comp)."""
    y = inc - comp
    t = total + y
    return t, (t - total) - y


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """The float32 sum of a host (B,) vector, folded in lane order from 0
    (one order on every device and at every B)."""
    total = torch.zeros((), dtype=x.dtype)
    for v in x:
        total = total + v
    return total


def lane_loop(comm: LaneComm, net, cfg: EngineConfig, prog, e_chunk: int,
              v_chunk: int, shard: GraphShard, carry: LaneCarry,
              stop_on_finish: bool = False) -> LaneCarry:
    """Run shared rounds until every lane is idle (or ``max_rounds``).

    A host loop, as :func:`~repro_torch.core.engine.run_engine`: each round
    runs every lane, frozen ones included (their round moves nothing),
    then keeps the frozen lanes' Stats, compensation and vertex slices,
    and reads each lane's pending work and clock increments back in one
    copy.  With ``stop_on_finish=True`` the loop also stops the round any
    active lane completes: the continuous-batching segment; the host then
    recycles the freed lanes and resumes from the carry (``halt``
    cleared)."""
    prog = as_program(prog)
    rnd = make_round(comm, net, cfg, prog, e_chunk, v_chunk, shard)
    pp, T, B = cfg.perf, comm.size, comm.lanes
    per = comm.rows // B  # a lane's rows: T, or one under SPMD
    t_round = torch.tensor(pp.t_round, dtype=F32)
    c = carry
    act = None
    while (bool((c.pending > 0).any()) and c.rounds < cfg.max_rounds
           and not c.halt):
        if act is None or not torch.equal(act, c.pending > 0):
            # the lanes that run changed: their mask and the frozen lanes'
            # rows go to the device once, not every round
            act = c.pending > 0
            active = act.to(comm.device)
            frozen = (torch.nonzero(~act)[:, 0, None] * per
                      + torch.arange(per)[None]).flatten().to(comm.device)
        st, stats, kcomp, trace, pend = rnd(c.st, c.stats, c.kcomp, c.trace,
                                            c.rounds, active)
        if frozen.numel():
            st = keep_frozen(frozen, c.st, st)
            stats = lane_select(active, c.stats, stats)
            kcomp = lane_select(active, c.kcomp, kcomp)
        # each lane's realized increments (0 for a frozen lane), read back
        # with the pending work in one copy (the round's one sync), each
        # lane's leakage over its own d_cyc then taken off
        d_cyc = stats.cycles - c.stats.cycles
        d_en = stats.energy_pj - c.stats.energy_pj
        back = torch.cat([pend.to(I32), d_cyc.view(I32),
                          d_en.view(I32)]).cpu()
        pend_h = back[:B]
        d_cyc_h, d_en_h = back[B:2 * B].view(F32), back[2 * B:].view(F32)
        d_en_h = d_en_h - leak_pj(pp, T, d_cyc_h)
        pending = torch.where(act, pend_h, c.pending)
        # the shared round pays t_round once, then each active lane's
        # marginal cost; the batch pays leakage once over that makespan
        cyc_round = t_round + _lane_sum(
            d_cyc_h - torch.where(act, t_round, 0.0))
        en_round = _lane_sum(d_en_h) + leak_pj(pp, T, cyc_round)
        clock, clock_c = _kahan(c.clock, c.clock_c, cyc_round)
        energy, energy_c = _kahan(c.energy, c.energy_c, en_round)
        rounds = c.rounds + 1
        newly = act & (pending == 0)
        c = LaneCarry(
            st=st, stats=stats, kcomp=kcomp, pending=pending, rounds=rounds,
            clock=clock, clock_c=clock_c, energy=energy, energy_c=energy_c,
            done_round=torch.where(newly, rounds, c.done_round).to(I32),
            done_cycle=torch.where(newly, clock, c.done_cycle),
            halt=bool(newly.any()) if stop_on_finish else c.halt,
            trace=trace)
    return c


# --------------------------------------------------------------------------
# Entry points: B lanes on one device.
# --------------------------------------------------------------------------

def local_lanes_call(prog, cfg: EngineConfig, T: int, e_chunk: int,
                     v_chunk: int, shard: GraphShard, value, frontier,
                     acc=None) -> LaneCarry:
    """A full batched run: ``(B, T, v_chunk)`` value / frontier / acc on
    the shard's device in, the final :class:`LaneCarry` out."""
    comm = LaneComm(T, value.shape[0], value.device)
    net = make_network(cfg, T)
    st = lane_state(comm, cfg, v_chunk, value, frontier, prog, acc)
    carry = lane_carry(comm, net, cfg, prog, st)
    return lane_loop(comm, net, cfg, prog, e_chunk, v_chunk, shard, carry)


def local_lanes_segment(prog, cfg: EngineConfig, T: int, e_chunk: int,
                        v_chunk: int, shard: GraphShard, carry: LaneCarry,
                        stop_on_finish: bool = True) -> LaneCarry:
    """Resume a batched run from ``carry``, stopping at the first round
    any active lane finishes: the continuous-batching segment."""
    comm = LaneComm(T, carry.pending.shape[0], carry.st.value.device)
    net = make_network(cfg, T)
    return lane_loop(comm, net, cfg, prog, e_chunk, v_chunk, shard, carry,
                     stop_on_finish=stop_on_finish)


def spmd_lanes_call(pg: PartitionedGraph, prog, cfg: EngineConfig, value,
                    frontier, mesh, axis: str = "x", acc=None):
    """The batched run as SPMD over ``axis`` of ``mesh`` (its size must be
    ``pg.T``): each process takes its tile's row of the partition and of
    the ``(B, T, v_chunk)`` ``value`` / ``frontier`` / ``acc`` onto its
    device and runs all B lanes of that tile (:class:`LaneAxisComm`).
    Returns, on every process and on ``pg.device``, ``(values (B, T,
    v_chunk), stats lane-led, rounds, clock, energy, done_round,
    done_cycle, trace)``: ``trace`` is the lane-led ring when
    ``cfg.trace``, else None; ``Stats.launches`` counts this process's
    launches."""
    prog = as_program(prog)
    prog.validate(cfg, pg.T, pg.e_chunk, pg.v_chunk)
    group, size, rank, dev, row, shard = spmd_rows(pg, mesh, axis)
    comm = LaneAxisComm(group, size, value.shape[0], rank, dev)
    net = make_network(cfg, pg.T)
    st = lane_state(comm, cfg, pg.v_chunk, row(value, True),
                    row(frontier, True), prog, row(acc, True))
    out = lane_loop(comm, net, cfg, prog, pg.e_chunk, pg.v_chunk, shard,
                    lane_carry(comm, net, cfg, prog, st))
    home = pg.device
    return lane_outputs(out, comm.all_gather(out.st.value).to(home), home)


def lane_outputs(out: LaneCarry, values, home=None):
    """A finished batched run as ``spmd_lanes_call`` returns it: ``values``
    (B lanes' every tile), then ``out``'s Stats, rounds, clock, energy,
    done rounds and cycles, and ring, the device tensors on ``home`` (by
    default where they are)."""
    def at(tree):
        return tree if home is None or tree is None else to_device(tree,
                                                                   home)
    return (values, at(out.stats), out.rounds, out.clock, out.energy,
            out.done_round, out.done_cycle, at(out.trace))


# --------------------------------------------------------------------------
# Host-side batch construction and the one-shot multi-source entry point.
# --------------------------------------------------------------------------

def batch_min_state(pg: PartitionedGraph, sources):
    """``(B, T, v_chunk)`` value / frontier for a batch of min-app
    sources, on the partition's device.  ``sources[i] < 0`` makes lane i
    a *padding lane*: every value "unreached" and an empty frontier, so it
    is born idle and adds nothing to the batch clock."""
    B = len(sources)
    value = np.full((B, pg.T, pg.v_chunk), np.float32(INF), np.float32)
    frontier = np.zeros((B, pg.T, pg.v_chunk), bool)
    for i, s in enumerate(sources):
        if s < 0:
            continue
        t, l = divmod(int(pg.place[int(s)]), pg.v_chunk)
        value[i, t, l] = 0.0
        frontier[i, t, l] = True
    return (torch.from_numpy(value).to(pg.device),
            torch.from_numpy(frontier).to(pg.device))


def lane_values(pg: PartitionedGraph, value) -> np.ndarray:
    """One lane's ``(T, v_chunk)`` placed-space values -> ``(V,)`` float64
    in original vertex order, unreached slots as +inf (the min apps'
    convention of :func:`repro_torch.core.algorithms.bfs`)."""
    flat = value.detach().cpu().numpy().reshape(-1)
    out = flat[np.asarray(pg.place)].astype(np.float64)
    out[out >= np.float32(INF)] = np.inf
    return out


@dataclasses.dataclass
class BatchResult:
    """One batched multi-source run, host-side (Stats on the device)."""

    values: np.ndarray       # (B, V) f64 in original vertex order
    stats: Stats             # lane-led (B, ...) per-query Stats
    total_rounds: int        # shared batch rounds (== max lane rounds)
    batch_cycles: float      # batch-clock makespan, modelled cycles
    batch_energy_pj: float   # batch energy on the shared makespan
    done_round: np.ndarray   # (B,) i32
    done_cycle: np.ndarray   # (B,) f32
    sources: np.ndarray      # (B,) the admitted sources (-1 = padding)
    trace: Optional[object] = None  # lane-led TraceBuf when cfg.trace

    @property
    def seq_rounds(self) -> int:
        """What B sequential solo runs would take in rounds (each lane's
        Stats are its solo run's)."""
        return int(self.stats.rounds.sum())


def multi_source(pg: PartitionedGraph, app: str, sources,
                 cfg: EngineConfig = EngineConfig(), mesh=None
                 ) -> BatchResult:
    """Answer a batch of point queries (``app`` "bfs" or "sssp") over the
    resident partition in one shared batched run on its device (or as
    SPMD over ``mesh``, one tile a process: :func:`spmd_lanes_call`).
    Each lane's result equals the solo :func:`repro_torch.core.algorithms.
    bfs` / ``sssp`` run at ``cfg`` and ``mesh``, bit for bit.

    A padding lane (``source < 0``) runs frozen from its birth: its values
    stay "unreached", its Stats, stamps and ring zero (``round_id`` -1),
    and it adds nothing to the batch clock (its terms in the lane sums are
    0)."""
    if app not in POINT_QUERIES:
        raise ValueError(f"multi_source serves point queries (bfs/sssp), "
                         f"got {app!r}")
    sources = np.asarray(sources, np.int64)
    prog = as_program(POINT_QUERIES[app])
    value, frontier = batch_min_state(pg, sources)
    if mesh is None:
        shard = GraphShard(pg.ptr_start, pg.deg, pg.edge_dst, pg.edge_val)
        prog.validate(cfg, pg.T, pg.e_chunk, pg.v_chunk)
        out = local_lanes_call(prog, cfg, pg.T, pg.e_chunk, pg.v_chunk,
                               shard, value, frontier)
        out = lane_outputs(out, out.st.value)
    else:
        out = spmd_lanes_call(pg, prog, cfg, value, frontier, mesh)
    (vals, stats, rounds, clock, energy, done_round, done_cycle,
     trace) = out
    vals = vals.reshape(len(sources), pg.T * pg.v_chunk)
    values = np.stack([lane_values(pg, v) for v in vals])
    return BatchResult(
        values=values, stats=stats, total_rounds=rounds,
        batch_cycles=float(clock), batch_energy_pj=float(energy),
        done_round=done_round.numpy(), done_cycle=done_cycle.numpy(),
        sources=sources, trace=trace)
