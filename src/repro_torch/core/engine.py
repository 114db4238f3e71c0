"""The Dalorex execution engine (port of ``repro.core.engine``).

Per round, every tile runs the program's source and then one generic
``queue -> TSU budget -> transform -> route -> handler -> spill`` leg per
task channel; for the classic program that is

  leg 0  frontier pop -> range-queue turn -> T1 range split
         --- route to the edge owner (the NoC backend) ---
  leg 1  spill re-queue -> T2 edge scan -> update-queue turn (replay)
         --- route to the vertex owner ---
  leg 2  spill re-queue -> T3 fold (a min fold re-arms the frontier)

then the TSU, the NoC telemetry and the cycle/energy model.  The fabric
between the legs is the :mod:`repro_torch.noc` backend of
``EngineConfig.noc``: the ideal crossbar, a mesh / torus / ruche grid or
the multi-die ``hier`` composition, with per-link capacities and
telemetry.  Stages are batched over the T emulated tiles
(:class:`LocalComm`).  On
``backend="kernels"`` (the default) with ``fuse=True`` (the default, the
counterpart of the reference's ``pallas_fuse``) each leg is ONE fused-leg
kernel launch (:mod:`repro_torch.kernels.engine.fused`): three launches
per round for the classic and k-core programs, five for the 4-channel
triangles chain, as the reference's fused ``"pallas"`` round.  With
``fuse=False`` the building blocks launch the standalone Hopper kernels of
:mod:`repro_torch.kernels.engine` — five launches per classic round and
eight per triangles round, as the reference's unfused ``"pallas"``
backend.  ``"torch"`` runs the same round in inline PyTorch ops and fuses
nothing, like the reference's ``"xla"``.

The reference runs the whole traversal inside one ``lax.while_loop``.
Here the host drives the rounds and reads the global pending-work count
back once per round (:func:`run_engine`; in BSP mode the count includes
the next epoch's frontier); capturing rounds in a CUDA graph is later
work.  Values and every Stats field except ``launches`` equal the
reference's bit for bit.

Under ``fuse`` the routes, the pending count, the BSP swap and the perf
sums stay PyTorch ops between and after the legs, as they sit outside
``fused_leg_call`` there; ``Program.fused`` names the program's leg
kernels.  ``edge_space="hbm"`` streams T2 through the
``edge_scan_stream`` kernel (inside leg 1 when fused) and prices the
streamed windows (``Stats.hbm_windows`` / ``hbm_edges``, ``t_hbm`` /
``e_hbm``).

With ``cfg.trace`` each round (every ``trace_every``-th) also writes a
slot of the flight recorder's ring (:mod:`repro_torch.trace`), which
:func:`run_engine` returns; recording reads what the round computed and
adds no host sync.

Over a :class:`~repro_torch.core.comm.LaneComm` the same round runs B
query lanes at once (:mod:`repro_torch.serve`): the state has B * T
lane-major rows over one shared ``(T, ...)`` shard, each leg is still
one launch for the whole batch, and the Stats are lane-led ``(B, ...)``.
:func:`lane_select` and :func:`keep_frozen` freeze the lanes that have
finished.

Over an :class:`~repro_torch.core.comm.AxisComm` (SPMD, one tile a
process over a ``torch.distributed`` group) or its lane form
:class:`~repro_torch.core.comm.LaneAxisComm` the same round runs with
``comm.rows`` = 1 (or B) rows a process over a one-row shard; every
value the host loop reads (the pending work) is a reduced global, the
same on every process, so all of them run the same rounds and meet in
every collective.

``adapt`` (adaptive placement, :mod:`repro_torch.place`) is read by the
host drivers between epochs and batches; the round loop never migrates.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from repro_torch.core.comm import LocalComm
from repro_torch.core.program import (BFS, Ctx, Program, as_program,
                                      resolve_edge_space)
from repro_torch.core.queues import (Queue, queue_make, queue_push,
                                     queue_take_front)
from repro_torch.kernels.engine import fifo_turn, queue_push_pop, tally
from repro_torch.kernels.engine import fused as fused_legs
from repro_torch.kernels.engine.fused import LegTemplate
from repro_torch.mem import resolve_window
from repro_torch.noc import make_network
from repro_torch.noc.topology import N_LINK_CLASSES
from repro_torch.perf import (PerfParams, link_cost_vectors,
                              round_energy_pj, tile_compute_cycles)
from repro_torch.trace.buffer import (on_cadence, record_lanes,
                                      record_round, zero_trace)

I32, F32 = torch.int32, torch.float32


# --------------------------------------------------------------------------
# Engine configuration and state.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static knobs, per tile; the reference's fields and defaults.

    The backend group differs: ``backend`` is "kernels" (the Hopper
    kernels; the counterpart of the reference's ``"pallas"`` backend) or
    "torch" (inline ops; the counterpart of ``"xla"``).  ``fuse`` is the
    counterpart of ``pallas_fuse`` and, like it, defaults to True: on
    "kernels" it runs each leg as one fused-leg kernel (3 launches per
    classic or k-core round against 5 unfused, 5 per triangles round
    against 8).  The Pallas-only knobs ``pallas_interpret`` and
    ``pallas_pad_lanes`` have no counterpart.
    """

    f_pop: int = 32          # frontier bits popped per round (T4 drain)
    r_pop: int = 32          # "range"-knob queue entries popped per round
    u_pop: int = 64          # "update"-knob spilled entries replayed
    max_t2: int = 32         # edge-scan bound per range message (MAX_T2)
    cap_route_range: int = 16    # CQ slots per destination, "range"
    cap_route_update: int = 64   # CQ slots per destination, "update"
    cap_rangeq: int = 2048   # local task-queue capacity, "range" channels
    cap_updq: int = 16384    # local spill-queue capacity, "update" channels
    policy: str = "traffic"  # "traffic" | "static"
    mode: str = "async"      # "async" | "bsp"
    max_rounds: int = 100_000
    backend: str = "kernels"  # "kernels" | "torch"
    fuse: bool = True        # one fused-leg kernel per leg ("kernels")
    edge_space: str = "vmem"  # "vmem" (resident) | "hbm" (streamed)
    hbm_window: int = 0
    vmem_limit_bytes: int = 0
    noc: str = "ideal"       # "ideal" | "mesh" | "torus" | "ruche" | "hier"
    noc_rows: int = 0
    link_cap: int = 0
    ruche_factor: int = 2
    ndies_x: int = 1
    ndies_y: int = 1
    hier_base: str = "mesh"
    perf: PerfParams = PerfParams()
    trace: bool = False      # flight recorder (repro_torch.trace)
    trace_every: int = 1
    trace_rounds: int = 512
    # adaptive placement (repro_torch.place): plans apply only at quiescent
    # boundaries (between PageRank epochs, between serving batches), every
    # ``adapt_every`` of them, at most ``adapt_budget`` vertices moved
    adapt: bool = False
    adapt_every: int = 1
    adapt_budget: int = 64

    def min_caps(self, T: int) -> tuple[int, int]:
        """Worst-case per-round queue inflow of the classic program:
        (rangeq_need, updq_need)."""
        burst = T * self.cap_route_range * self.max_t2 + self.u_pop
        rangeq_need = 2 * self.f_pop
        if self.noc != "ideal":
            burst += T * self.cap_route_update
            rangeq_need += 2 * self.r_pop + T * self.cap_route_range
        return rangeq_need, burst

    def validate(self, T: int):
        rangeq_need, burst = self.min_caps(T)
        if self.cap_updq < burst:
            raise ValueError(
                f"cap_updq={self.cap_updq} < worst-case T2 burst {burst}")
        if self.cap_rangeq < rangeq_need:
            raise ValueError(f"cap_rangeq={self.cap_rangeq} < worst-case "
                             f"inflow {rangeq_need}")


class EngineState(NamedTuple):
    value: torch.Tensor      # (T, v_chunk) f32 — dist / label
    acc: torch.Tensor        # (T, v_chunk) f32 — accumulator
    frontier: torch.Tensor   # (T, v_chunk) bool — live bitmap frontier
    next_frontier: torch.Tensor  # (T, v_chunk) bool — BSP-deferred
    queues: tuple            # one Queue per program channel
    net_pressure: torch.Tensor  # (T,) i32 — last round's own-port load


class Stats(NamedTuple):
    """The reference's Stats, field for field (int32 counters, float32
    model totals); global values, one copy."""

    rounds: torch.Tensor
    epochs: torch.Tensor
    msgs: torch.Tensor             # (K,) per task channel
    spills: torch.Tensor           # (K,)
    edges_scanned: torch.Tensor
    updates_applied: torch.Tensor
    drops: torch.Tensor            # MUST be 0
    work_max: torch.Tensor
    flits_per_link: torch.Tensor   # (num_links,)
    max_link_occupancy: torch.Tensor
    hop_histogram: torch.Tensor    # (max_hops+1,)
    die_crossings: torch.Tensor    # (max_die_crossings+1,)
    cycles: torch.Tensor           # modelled cycles (Kahan-summed f32)
    energy_pj: torch.Tensor        # modelled energy (Kahan-summed f32)
    launches: torch.Tensor         # kernel calls, all rounds (not part of
                                   # the cross-backend equivalence)
    hbm_windows: torch.Tensor
    hbm_edges: torch.Tensor
    migrated_vertices: torch.Tensor
    migration_cycles: torch.Tensor
    migration_pj: torch.Tensor

    @staticmethod
    def zero(num_links: int = 1, max_hops: int = 1, num_channels: int = 2,
             max_die_crossings: int = 0, device="cpu"):
        def z(*shape, dtype=I32):
            return torch.zeros(shape, dtype=dtype, device=device)
        return Stats(z(), z(), z(num_channels), z(num_channels),
                     z(), z(), z(), z(), z(num_links), z(),
                     z(max_hops + 1), z(max_die_crossings + 1),
                     z(dtype=F32), z(dtype=F32), z(), z(), z(), z(),
                     z(dtype=F32), z(dtype=F32))


def zero_stats(cfg: EngineConfig, T: int, alg, device) -> Stats:
    """A Stats zero shaped for the NoC backend and program of ``cfg``, on
    ``device`` (the partition's, where the epochs' Stats accumulate)."""
    prog = as_program(alg)
    net = make_network(cfg, T)
    return Stats.zero(net.num_links, net.max_hops, len(prog.channels),
                      net.max_die_crossings, device)


class GraphShard(NamedTuple):
    """The tiles' chunks of the four dataset arrays (placed space)."""
    ptr_start: torch.Tensor  # (T, v_chunk) i32 global placed edge index
    deg: torch.Tensor        # (T, v_chunk) i32
    edge_dst: torch.Tensor   # (T, e_chunk) i32 placed dst (-1 pad)
    edge_val: torch.Tensor   # (T, e_chunk) f32


# --------------------------------------------------------------------------
# The TSU: a generic arbiter over N channel occupancies + fabric pressure.
# --------------------------------------------------------------------------

def _budgets(cfg: EngineConfig, prog: Program, qcaps, pops, st: EngineState,
             plimit: int):
    """Per-round budgets from the channel queue occupancies and last
    round's fabric pressure (Section III-E).  The deepest consumer always
    drains; a producer is throttled while anything downstream is
    congested (> 3/4 full) or the fabric is hot; the frontier source stops
    while channel 0 is half full or anything downstream is congested.
    Returns (source budget (T,), channel pops (T, K)), int32."""
    K = len(prog.channels)
    occ = [st.queues[i].count for i in range(K)]
    free0 = qcaps[0] - occ[0]

    def full(v):
        return torch.full_like(occ[0], v)

    if cfg.policy == "static":
        f_pop = torch.clamp(free0, min=0).clamp(max=cfg.f_pop)
        return f_pop, torch.stack([full(p) for p in pops], dim=1)
    net_hot = st.net_pressure > max(plimit, 1)
    congested = [occ[i] > (3 * qcaps[i]) // 4 for i in range(K)]
    chan_pops = [None] * K
    down = torch.zeros_like(net_hot)    # any congested queue downstream
    for i in reversed(range(K)):
        if i == K - 1:
            chan_pops[i] = full(pops[i])
        else:
            throttled = pops[i] // 4 if K == 2 else 0
            chan_pops[i] = torch.where(down | net_hot, full(throttled),
                                       full(pops[i]))
        down = down | congested[i]
    down_of_source = net_hot
    for i in range(1, K):
        down_of_source = down_of_source | congested[i]
    half0 = occ[0] > qcaps[0] // 2
    f_pop = torch.where(half0 | down_of_source, full(0),
                        torch.clamp(free0 - 2 * cfg.f_pop, min=0)
                        .clamp(max=cfg.f_pop))
    return f_pop, torch.stack(chan_pops, dim=1)


def pending_work(me, st: EngineState) -> torch.Tensor:
    """Per-tile pending work (frontier population + queue occupancies),
    the local contribution to the paper's hierarchical idle wire; the
    serving lanes take each query's idle signal from it too."""
    p = st.frontier.sum(dim=1, dtype=I32)
    for q in st.queues:
        p = p + q.count
    return p


def lane_select(active: torch.Tensor, old, new):
    """Per-lane select over matching lane-led tuples of tensors: ``new``
    where the lane is ``active`` ((B,) bool), ``old`` where it is frozen,
    so a finished query's Stats and Kahan compensation stop evolving the
    round its pending work reaches zero, as its solo run's loop stops."""
    def sel(o, n):
        return torch.where(active.reshape(active.shape + (1,) * (n.ndim - 1)),
                           n, o)
    out = [sel(o, n) for o, n in zip(old, new)]
    return type(new)(*out) if hasattr(new, "_fields") else tuple(out)


def keep_frozen(rows: torch.Tensor, old: EngineState,
                new: EngineState) -> EngineState:
    """``new`` with the frozen lanes' ``rows`` (int64 indices of the B * T
    lane-major rows) of ``old`` copied back into its vertex slices, queue
    counts and pressure, in place.  A frozen lane has no pending work, so
    its round moved nothing and these hold what they held; the copy makes
    that so whatever the round computed.  Its queues' storage is not
    copied: their counts are 0, so no slot of it is read.  The round's
    outputs are new tensors (the fused legs append in place only onto a
    queue that an earlier leg of the same round made); a field the round
    passed through unchanged is ``old``'s own and is left alone."""
    def keep(o, n):
        if n is not o:
            n.index_copy_(0, rows, o.index_select(0, rows))
        return n
    for f in ("value", "acc", "frontier", "next_frontier", "net_pressure"):
        keep(getattr(old, f), getattr(new, f))
    for qo, qn in zip(old.queues, new.queues):
        keep(qo.count, qn.count)
    return new


def _set_queue(st: EngineState, i: int, q: Queue) -> EngineState:
    return st._replace(queues=st.queues[:i] + (q,) + st.queues[i + 1:])


def _next_pending(me, st: EngineState) -> torch.Tensor:
    return st.next_frontier.sum(dim=1, dtype=I32)


def _bsp_swap(me, st: EngineState, do_swap: torch.Tensor) -> EngineState:
    """At a BSP barrier (``do_swap``, (T,) bool), the next epoch's
    frontier becomes live."""
    sw = do_swap[:, None]
    return st._replace(
        frontier=torch.where(sw, st.frontier | st.next_frontier,
                             st.frontier),
        next_frontier=torch.where(sw, torch.zeros_like(st.next_frontier),
                                  st.next_frontier))


def _check_mode(cfg: EngineConfig):
    """Raise for a mode the engine does not know."""
    if cfg.mode not in ("async", "bsp"):
        raise ValueError(f"unknown mode {cfg.mode!r}")


# --------------------------------------------------------------------------
# The round.
# --------------------------------------------------------------------------

def make_round(comm: LocalComm, net, cfg: EngineConfig, prog: Program,
               e_chunk: int, v_chunk: int, shard: GraphShard):
    """Build the round function ``(state, stats, kahan_comp, tbuf=None,
    r=0, active=None) -> (state, stats, kahan_comp, tbuf, pending)``;
    ``kahan_comp`` is the (cycles, energy) float32 compensation pair of
    the perf model's summation, ``tbuf`` the flight recorder's ring when
    ``cfg.trace`` (else None, passed through) and ``r`` the host's index
    of the round, which the ring's cadence reads.

    Over a :class:`~repro_torch.core.comm.LaneComm` the state holds
    ``comm.rows`` lane-major rows, the Stats, compensation and pending
    work come out lane-led, and a lane-led ring records on each lane's
    own pre-round ``Stats.rounds`` where ``active`` ((B,) bool) holds, as
    the solo ring records on its round index."""
    chans = prog.channels
    K = len(chans)
    backends = tuple(ch.resolve_backend(cfg) for ch in chans)
    # fuse: every leg is one fused-leg kernel when all channels run on
    # "kernels" (the reference fuses a leg iff its channels are "pallas")
    fused = cfg.fuse and all(b == "kernels" for b in backends)
    _check_mode(cfg)
    # an HBM-declared shard streams T2 through the windows of its space
    edge_space = resolve_edge_space(prog, cfg)
    streaming = edge_space == "hbm"
    window = resolve_window(cfg.hbm_window, cfg.max_t2) if streaming else 0
    ctx = Ctx(cfg, comm.size, e_chunk, v_chunk, fused=fused,
              edge_space=edge_space, hbm_window=window)
    cxs = tuple(ctx._replace(backend=b) for b in backends)
    caps = tuple(ch.route_cap(cfg) for ch in chans)
    pops = tuple(ch.pop_budget(cfg) for ch in chans)
    qcaps = tuple(ch.qcap(cfg) for ch in chans)
    owners = tuple(ch.owner_fn(ctx) for ch in chans)
    plimit = net.pressure_limit(cfg, caps)
    pp = cfg.perf
    t_hop, e_hop = link_cost_vectors(pp, net, comm.device)
    t_round = torch.tensor(pp.t_round, dtype=F32, device=comm.device)
    T = comm.size
    n_rows = comm.rows  # T, or B * T lane-major rows
    tracing = cfg.trace
    if tracing:
        # (C, num_links) one-hot splitting per-link flits by cost class
        cls = torch.from_numpy(net.link_classes.astype("int64")) \
            .to(comm.device)
        cls_onehot = (cls[None, :] == torch.arange(
            N_LINK_CLASSES, device=comm.device)[:, None]).to(I32)
        tile_ids = torch.arange(T, dtype=I32, device=comm.device)

    def requeue(st, i, sp, spv):
        """Spill re-queue into channel i's local queue."""
        q, d = queue_push(st.queues[i], sp, spv)
        return _set_queue(st, i, q), d

    def ingest(i, st, rows, valid, pop_i, cx):
        """Feed fresh rows into channel i and produce its network messages.

        Queued channels push the fresh tasks, pop up to the budget and
        bound each popped task with the channel transform (re-pushing the
        remainders); spill-only channels replay their backlog ahead of the
        fresh messages.  On "kernels" the push + pop pair is one
        ``queue_push_pop`` launch (a spill-only channel turns with an
        empty fresh batch), or its plain body ``fifo_turn`` inside a
        fused leg.  Also returns each tile's queue-op counts for the cycle
        model: entries popped and entries pushed this round.
        """
        q = st.queues[i]
        kernels = cx.backend == "kernels"
        turn = fifo_turn if cx.fused else queue_push_pop
        if chans[i].queued:
            if kernels:
                taken, tvalid, qdata, qcount, d0 = turn(
                    q.data, q.count, rows, valid, pop_i.contiguous(),
                    pops[i])
                q = Queue(qdata, qcount)
            else:
                q, d0 = queue_push(q, rows, valid)
                taken, tvalid, q = queue_take_front(q, pop_i, pops[i])
            msgs, mvalid, rem, remv = chans[i].transform(cx, taken, tvalid)
            q, d1 = queue_push(q, rem, remv)
            drops = d0 + d1
            npop = tvalid.sum(dim=1, dtype=I32)
            npush = (valid.sum(dim=1, dtype=I32)
                     + remv.sum(dim=1, dtype=I32))
        else:
            if kernels:
                w = q.data.shape[2]
                none = torch.zeros((n_rows, 1), dtype=torch.bool,
                                   device=comm.device)
                pad = torch.zeros((n_rows, 1, w), dtype=I32,
                                  device=comm.device)
                replay, rvalid, qdata, qcount, _ = turn(
                    q.data, q.count, pad, none, pop_i.contiguous(), pops[i])
                q = Queue(qdata, qcount)
            else:
                replay, rvalid, q = queue_take_front(q, pop_i, pops[i])
            msgs = torch.cat([replay, rows], dim=1)
            mvalid = torch.cat([rvalid, valid], dim=1)
            drops = torch.zeros((n_rows,), dtype=I32, device=comm.device)
            npop = rvalid.sum(dim=1, dtype=I32)
            npush = torch.zeros((n_rows,), dtype=I32, device=comm.device)
        return _set_queue(st, i, q), msgs, mvalid, drops, npop, npush

    def stage_first(me, sh, st):
        f_pop, dyn_pops = _budgets(cfg, prog, qcaps, pops, st, plimit)
        st, rows, valid = prog.source(cxs[0], me, sh, st, f_pop)
        st, msgs, mvalid, drops, npop, npush = ingest(
            0, st, rows, valid, dyn_pops[:, 0], cxs[0])
        return st, msgs, mvalid, drops, dyn_pops, npop, npush

    def make_mid(i):
        def stage(me, sh, st, recv, rv, sp, spv, dyn_pops):
            st, d0 = requeue(st, i - 1, sp, spv)
            st, rows, valid, work = chans[i - 1].handler(
                cxs[i - 1], me, sh, st, recv, rv)
            st, msgs, mvalid, d1, npop, npush = ingest(
                i, st, rows, valid, dyn_pops[:, i], cxs[i])
            nspill = spv.sum(dim=1, dtype=I32)
            return st, msgs, mvalid, d0 + d1, work, npop, npush, nspill
        return stage

    mids = {i: make_mid(i) for i in range(1, K)}

    def stage_last(me, sh, st, recv, rv, sp, spv):
        st, d0 = requeue(st, K - 1, sp, spv)
        st, _, _, work = chans[K - 1].handler(cxs[K - 1], me, sh, st, recv,
                                              rv)
        return st, d0, work, spv.sum(dim=1, dtype=I32)

    if fused:
        # each leg is one kernel; the stages above (under the fused Ctx)
        # are its plain version
        codes = prog.fused
        tmpl = LegTemplate(
            payload=codes.payload, emit=codes.emit, fold=codes.fold,
            k=codes.k, mode=cfg.mode, policy=cfg.policy, window=window,
            f_pop=cfg.f_pop, pops=pops, max_t2=cfg.max_t2, plimit=plimit,
            tile0=comm.tile0)
        legs = [functools.partial(getattr(fused_legs, name), tmpl)
                for name in fused_legs.LEGS[codes.family]]
        stage_first = functools.partial(legs[0], stage_first)
        for i in range(1, K):
            mids[i] = functools.partial(legs[i], mids[i])
        stage_last = functools.partial(legs[K], stage_last)

    def kahan_add(total, comp, inc):
        """Compensated float32 accumulation: (new_total, new_comp)."""
        y = inc - comp
        t = total + y
        return t, (t - total) - y

    def tile_sum(v):
        return v.sum(dim=1, dtype=I32)

    def rnd(st: EngineState, stats: Stats, kcomp, tbuf=None, r: int = 0,
            active=None):
        # a lane-led ring decides on the device, lane by lane
        recording = tracing and (comm.lane_led
                                 or on_cadence(r, cfg.trace_every))
        if recording:
            # the TSU's source grant, from the pre-round state leg 0
            # arbitrates on: taken now, as the fused legs append in place
            # onto queues of the state they are given
            src_grant = comm.run(lambda me, s: _budgets(
                cfg, prog, qcaps, pops, s, plimit)[0], st)
        with tally() as launch_tally:
            st, msgs, mvalid, drops, dyn_pops, n_pop, n_push = comm.run(
                stage_first, shard, st)
            routed = net.route(comm, msgs, mvalid, caps[0], owners[0])
            link_round = routed.link_flits
            hop_round = routed.hop_hist
            die_round = routed.die_hist
            sents = [routed.sent]
            spillv = [routed.spill_valid]
            edges = torch.zeros_like(drops)
            applied = torch.zeros_like(drops)
            n_replay = torch.zeros_like(drops)
            hbm_win = torch.zeros_like(drops) if streaming else None
            for i in range(1, K):
                if streaming and chans[i - 1].work == "edges":
                    # each delivered range message fetches its two windows
                    hbm_win = hbm_win + 2 * tile_sum(routed.recv_valid)
                st, msgs, mvalid, d, work, npop, npush, nspill = comm.run(
                    mids[i], shard, st, routed.recv, routed.recv_valid,
                    routed.spill, routed.spill_valid, dyn_pops)
                drops = drops + d
                n_pop = n_pop + npop
                n_push = n_push + npush
                n_replay = n_replay + nspill
                if chans[i - 1].work == "edges":
                    edges = edges + work
                elif chans[i - 1].work == "updates":
                    applied = applied + work
                routed = net.route(comm, msgs, mvalid, caps[i], owners[i])
                link_round = link_round + routed.link_flits
                hop_round = hop_round + routed.hop_hist
                die_round = die_round + routed.die_hist
                sents.append(routed.sent)
                spillv.append(routed.spill_valid)
            if streaming and chans[K - 1].work == "edges":
                hbm_win = hbm_win + 2 * tile_sum(routed.recv_valid)
            st, d, work, nspill = comm.run(stage_last, shard, st,
                                           routed.recv, routed.recv_valid,
                                           routed.spill, routed.spill_valid)
        drops = drops + d
        n_replay = n_replay + nspill
        if chans[K - 1].work == "edges":
            edges = edges + work
        elif chans[K - 1].work == "updates":
            applied = applied + work

        # NoC telemetry: global per-link occupancy of this round, and the
        # per-tile pressure fed back into next round's TSU budgets.
        link_round = comm.psum(link_round)
        hop_round = comm.psum(hop_round)
        die_round = comm.psum(die_round)
        st = st._replace(net_pressure=comm.run(net.pressure, link_round))
        pending = comm.psum(comm.run(pending_work, st))
        epochs = stats.epochs
        if cfg.mode == "bsp":
            # the barrier: once the live epoch drains, swap in the next
            nxt = comm.psum(comm.run(_next_pending, st))
            do_swap = (pending == 0) & (nxt > 0)
            st = comm.run(_bsp_swap, st, do_swap)
            epochs = epochs + comm.to_global(do_swap)
            pending = pending + nxt

        # globals: one copy, or one a lane (channels and links last)
        glob = comm.to_global
        msgs_vec = torch.stack([glob(comm.psum(s)) for s in sents], dim=-1)
        spills_vec = torch.stack([glob(comm.psum(tile_sum(sv)))
                                  for sv in spillv], dim=-1)
        link_g = glob(link_round)
        edges_g = glob(comm.psum(edges))
        applied_g = glob(comm.psum(applied))

        # Cycle/energy model: the slowest tile's compute plus the busiest
        # link's serialization; energy linear in the round's counters.  A
        # streamed shard also pays t_hbm / e_hbm per streamed edge word;
        # on resident runs the terms are absent (not multiplied by zero),
        # as in the reference, so those totals keep their bits.
        if streaming:
            hw_g = glob(comm.psum(hbm_win))
            he_g = hw_g * window
        comp = tile_compute_cycles(
            pp, n_pop, n_push, n_replay, edges, applied,
            hbm_edges=hbm_win * window if streaming else None)
        cyc_round = (t_round + glob(comm.pmax(comp))
                     + (link_g.to(F32) * t_hop).amax(dim=-1))
        energy_round = round_energy_pj(
            pp, T, edges_g, applied_g, msgs_vec.sum(dim=-1, dtype=I32),
            spills_vec.sum(dim=-1, dtype=I32), link_g, e_hop, cyc_round,
            hbm_edges_g=he_g if streaming else None)
        rounds_in = stats.rounds  # a lane-led ring records on it
        cycles_acc, c_cyc = kahan_add(stats.cycles, kcomp[0], cyc_round)
        energy_acc, c_en = kahan_add(stats.energy_pj, kcomp[1],
                                     energy_round)

        stats = Stats(
            rounds=stats.rounds + 1,
            epochs=epochs,
            msgs=stats.msgs + msgs_vec,
            spills=stats.spills + spills_vec,
            edges_scanned=stats.edges_scanned + edges_g,
            updates_applied=stats.updates_applied + applied_g,
            drops=stats.drops + glob(comm.psum(drops)),
            work_max=stats.work_max + glob(comm.pmax(edges)),
            flits_per_link=stats.flits_per_link + link_g,
            max_link_occupancy=torch.maximum(stats.max_link_occupancy,
                                             link_g.amax(dim=-1)),
            hop_histogram=stats.hop_histogram + glob(hop_round),
            die_crossings=stats.die_crossings + glob(die_round),
            cycles=cycles_acc,
            energy_pj=energy_acc,
            launches=stats.launches + launch_tally.n,
            hbm_windows=(stats.hbm_windows + hw_g if streaming
                         else stats.hbm_windows),
            hbm_edges=(stats.hbm_edges + he_g if streaming
                       else stats.hbm_edges),
            migrated_vertices=stats.migrated_vertices,
            migration_cycles=stats.migration_cycles,
            migration_pj=stats.migration_pj,
        )
        if recording:
            # reads of the round's telemetry and reductions of it: nothing
            # here feeds back into the state or the Stats
            occ = torch.stack([q.count for q in st.queues], dim=1)
            busy = glob(comm.all_gather(comp))  # (T,), lane-led (B, T)
            row = dict(
                cyc=cyc_round,
                cyc_total=cycles_acc,
                tile_busy=busy,
                # the first maximum, as jnp.argmax picks it on ties
                crit_tile=torch.where(busy == busy.amax(-1, keepdim=True),
                                      tile_ids, T).amin(-1),
                msgs=msgs_vec,
                spills=spills_vec,
                qdepth=glob(comm.psum(occ)),
                qdepth_max=glob(comm.pmax(occ)),
                chan_budget=glob(comm.psum(dyn_pops)),
                src_budget=glob(comm.psum(src_grant)),
                link_cls=(cls_onehot * link_g[..., None, :]).sum(
                    dim=-1, dtype=I32),
                launches=launch_tally.n,
                hbm_windows=hw_g if streaming else 0,
                frontier=glob(comm.psum(tile_sum(st.frontier))),
                pending=glob(pending),
            )
            if comm.lane_led:
                tbuf = record_lanes(tbuf, row, rounds_in, active,
                                    cfg.trace_every)
            else:
                tbuf = record_round(tbuf, row, r, cfg.trace_every)
        return st, stats, (c_cyc, c_en), tbuf, glob(pending)

    return rnd


def init_state(comm: LocalComm, cfg: EngineConfig, v_chunk: int, value,
               frontier, alg=BFS, acc=None) -> EngineState:
    """value/frontier/acc: (rows, v_chunk) tensors on the comm's device
    (T rows, or B * T lane-major rows over a LaneComm).  ``alg`` (AlgSpec
    or Program) fixes the channel queue shapes."""
    prog = as_program(alg)
    T, dev = comm.rows, comm.device
    if acc is None:
        acc = torch.zeros((T, v_chunk), dtype=F32, device=dev)
    return EngineState(
        value=value,
        acc=acc,
        frontier=frontier,
        next_frontier=torch.zeros((T, v_chunk), dtype=torch.bool,
                                  device=dev),
        queues=tuple(queue_make(T, ch.qcap(cfg), ch.width,
                                space=ch.resolve_space(cfg),
                                label=f"queue[{ch.name}]", device=dev)
                     for ch in prog.channels),
        net_pressure=torch.zeros((T,), dtype=I32, device=dev),
    )


def run_engine(comm: LocalComm, cfg: EngineConfig, alg, shard: GraphShard,
               st: EngineState, e_chunk: int, v_chunk: int):
    """Run rounds until the global idle signal fires (or ``max_rounds``).

    A host loop: each round's global pending-work count is read back (one
    device sync per round) to decide whether to run the next.  Returns
    ``(state, stats, trace)``: ``trace`` is the flight recorder's ring
    (:class:`~repro_torch.trace.TraceBuf`) when ``cfg.trace``, else None.
    """
    prog = as_program(alg)
    prog.validate(cfg, comm.size, e_chunk, v_chunk)
    net = make_network(cfg, comm.size)
    rnd = make_round(comm, net, cfg, prog, e_chunk, v_chunk, shard)
    stats = Stats.zero(net.num_links, net.max_hops, len(prog.channels),
                       net.max_die_crossings, comm.device)
    tbuf = zero_trace(cfg, comm.size, prog, comm.device) if cfg.trace \
        else None
    zf = torch.zeros((), dtype=F32, device=comm.device)
    kcomp = (zf, zf)
    pending = int(comm.to_global(comm.psum(comm.run(pending_work, st))))
    r = 0
    while pending > 0 and r < cfg.max_rounds:
        st, stats, kcomp, tbuf, pend = rnd(st, stats, kcomp, tbuf, r)
        pending = int(pend)
        r += 1
    return st, stats, tbuf
