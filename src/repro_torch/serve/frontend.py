"""Serving front end: request queue -> batches -> lanes -> latency rows
(port of ``repro.serve.frontend``).

The machine side (:mod:`repro_torch.serve.lanes`) answers a fixed batch of
B sources; this module is the service around it: a request queue admits
sources as they arrive, forms fixed-width batches (padding partial
batches with idle lanes), drives the batched round loop, and streams back
per-query results with latency on the perf model's cycle clock: every
timestamp below is modelled machine cycles, not host wall time.

Latency accounting (per query)::

    enqueue_cycle   the request arrives (the arrival process)
    admit_cycle     its batch forms / its lane is recycled to it
    complete_cycle  its lane's pending work reaches zero (batch clock)

    wait    = admit - enqueue      (queueing delay)
    latency = complete - enqueue   (what the client sees)

Two batching policies:

* ``"static"``: admit up to ``width`` arrived requests, run the batch to
  completion, advance the clock by the batch makespan, repeat.
  Stragglers hold the whole batch.
* ``"continuous"``: the round loop runs in segments that stop the moment
  any lane finishes; the freed lane is recycled to the next queued
  request at once (:func:`_recycle`: its state re-initialized, its
  channel queues reset with :func:`~repro_torch.core.queues.queue_clear`,
  its Stats slice and ring zeroed) while the other lanes keep their
  traversals.

Both price time on the shared batch clock of :mod:`repro_torch.serve.
lanes`.  Under ``EngineConfig.adapt`` the static policy migrates the
resident partition between batches (:meth:`Frontend._maybe_adapt`,
:mod:`repro_torch.place`) and charges the move to the clock.  On a mesh
the static policy runs each batch as SPMD (:func:`~repro_torch.serve.
lanes.spmd_lanes_call`, one tile a process); continuous batching is
refused there, as the reference refuses it.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.core.comm import LaneComm
from repro_torch.core.engine import EngineConfig, EngineState, GraphShard
from repro_torch.core.graph import PartitionedGraph
from repro_torch.core.program import as_program
from repro_torch.core.queues import Queue, queue_clear
from repro_torch.noc import make_network
from repro_torch.perf.model import migration_cost
from repro_torch.place import (adapt_partition, cfg_tile_die,
                               migration_words, score_tiles)
from repro_torch.serve.lanes import (POINT_QUERIES, LaneCarry,
                                     batch_min_state, lane_carry, lane_state,
                                     lane_values, local_lanes_segment,
                                     multi_source)
from repro_torch.trace.export import lane_trace


def arrival_cycles(n: int, pattern: str = "burst", gap: float = 0.0,
                   seed: int = 0) -> np.ndarray:
    """Enqueue timestamps (modelled cycles) for ``n`` requests.

    ``pattern``: "burst" (all at cycle 0: an offline batch), "uniform"
    (one every ``gap`` cycles: a paced open loop), or "poisson"
    (exponential interarrivals with mean ``gap``: an open loop with
    bursts).  Deterministic at a fixed ``seed``.
    """
    if pattern == "burst":
        return np.zeros(n, np.float64)
    if gap <= 0:
        raise ValueError(f"{pattern!r} arrivals need gap > 0 cycles")
    if pattern == "uniform":
        return gap * np.arange(n, dtype=np.float64)
    if pattern == "poisson":
        rng = np.random.default_rng(seed)
        return np.cumsum(rng.exponential(gap, size=n))
    raise ValueError(f"unknown arrival pattern {pattern!r}")


@dataclasses.dataclass
class QueryRecord:
    """One served query, timestamps in modelled cycles."""

    qid: int
    source: int
    enqueue_cycle: float
    admit_cycle: float
    complete_cycle: float
    rounds: int     # the lane's own rounds (== its solo run's)
    edges: int      # the lane's edges_scanned
    values: np.ndarray = None  # (V,) f64 result, original vertex order
    trace: object = None       # the lane's ring (continuous, cfg.trace)

    @property
    def wait(self) -> float:
        return self.admit_cycle - self.enqueue_cycle

    @property
    def latency(self) -> float:
        return self.complete_cycle - self.enqueue_cycle


@dataclasses.dataclass
class ServeReport:
    """Aggregate of one serving run; throughput on the modelled clock."""

    app: str
    policy: str
    width: int
    arrival: str
    records: list
    batches: int
    total_cycles: float      # serving makespan (batch clock + idle gaps)
    total_energy_pj: float
    total_rounds: int        # shared rounds actually run
    seq_rounds: int          # what solo runs would take (sum of lane
                             # rounds: each lane is its solo run)
    drops: int = 0           # summed over lanes; must be 0
    f_ghz: float = 1.0
    migrated_vertices: int = 0  # vertices moved between batches (adapt)

    @property
    def queries(self) -> int:
        return len(self.records)

    @property
    def time_s(self) -> float:
        return self.total_cycles / (self.f_ghz * 1e9)

    @property
    def qps(self) -> float:
        return self.queries / self.time_s if self.time_s > 0 else 0.0

    @property
    def j_per_query(self) -> float:
        return (self.total_energy_pj * 1e-12 / self.queries
                if self.queries else 0.0)

    @property
    def edges_total(self) -> int:
        return sum(r.edges for r in self.records)

    @property
    def gteps(self) -> float:
        return (self.edges_total / self.time_s / 1e9
                if self.time_s > 0 else 0.0)

    def latency_cycles(self, q: float) -> float:
        """Latency percentile (0..100) over the served queries, cycles."""
        return float(np.percentile([r.latency for r in self.records], q))

    def row(self) -> dict:
        """The reference's row, key for key."""
        row = {
            "app": self.app, "policy": self.policy, "width": self.width,
            "arrival": self.arrival, "queries": self.queries,
            "batches": self.batches, "rounds": self.total_rounds,
            "seq_rounds": self.seq_rounds,
            "cycles": int(round(self.total_cycles)),
            "energy_pj": round(self.total_energy_pj, 1),
            "drops": self.drops,
            "qps": round(self.qps, 1),
            "gteps": round(self.gteps, 6),
            "j_per_query": round(self.j_per_query * 1e12, 1),  # pJ/query
            "lat_p50": int(round(self.latency_cycles(50))),
            "lat_p95": int(round(self.latency_cycles(95))),
            "lat_max": int(round(self.latency_cycles(100))),
        }
        if self.migrated_vertices:
            row["migrated_vertices"] = self.migrated_vertices
        return row


def _put(x: torch.Tensor, rows: slice, v) -> torch.Tensor:
    """A copy of ``x`` with ``x[rows] = v``."""
    y = x.clone()
    y[rows] = v
    return y


def _recycle(carry: LaneCarry, lane: int, value, frontier) -> LaneCarry:
    """Re-initialize lane ``lane`` of the carry for a fresh query:
    min-app value / frontier ``(T, v_chunk)`` set, acc and BSP frontier
    zeroed, channel queues reset (:func:`queue_clear`: bit-equal to fresh
    ones), pressure, Stats slice, Kahan compensation and ring zeroed (the
    ring's cursor 0, its slots marked empty), pending recomputed, and the
    segment's ``halt`` cleared so the loop resumes.  Out of place."""
    st = carry.st
    T = value.shape[0]
    rows = slice(lane * T, (lane + 1) * T)
    cleared = [queue_clear(Queue(q.data[rows], q.count[rows]))
               for q in st.queues]
    st = EngineState(
        value=_put(st.value, rows, value),
        acc=_put(st.acc, rows, 0.0),
        frontier=_put(st.frontier, rows, frontier),
        next_frontier=_put(st.next_frontier, rows, False),
        queues=tuple(Queue(_put(q.data, rows, c.data),
                           _put(q.count, rows, c.count))
                     for q, c in zip(st.queues, cleared)),
        net_pressure=_put(st.net_pressure, rows, 0))
    stats = type(carry.stats)(*(_put(s, lane, 0) for s in carry.stats))
    kcomp = tuple(_put(k, lane, 0.0) for k in carry.kcomp)
    trace = carry.trace
    if trace is not None:
        trace = type(trace)(*(_put(x, lane, 0) for x in trace))
        trace = trace._replace(round_id=_put(trace.round_id, lane, -1))
    # a fresh lane: queues empty, so its pending work is its frontier
    pend = int(frontier.sum())
    return carry._replace(
        st=st, stats=stats, kcomp=kcomp, trace=trace,
        pending=_put(carry.pending, lane, pend),
        done_round=_put(carry.done_round, lane, -1),
        done_cycle=_put(carry.done_cycle, lane, 0.0), halt=False)


class Frontend:
    """The serving loop over one resident partitioned graph.

    >>> fe = Frontend(pg, app="bfs", cfg=cfg, width=8)
    >>> report = fe.serve(sources, arrival="poisson", gap=5e4)

    ``graph`` is the host CSR that between-batch adaptation
    (``cfg.adapt``) re-deals; ``mesh`` runs the static policy's batches
    as SPMD over its ``"x"`` axis (every process calls ``serve`` with the
    same arguments and gets the same report).
    """

    def __init__(self, pg: PartitionedGraph, app: str = "bfs",
                 cfg: EngineConfig = EngineConfig(), width: int = 8,
                 policy: str = "static", mesh=None, graph=None):
        if app not in POINT_QUERIES:
            raise ValueError(f"servable point-query apps: bfs/sssp, "
                             f"got {app!r}")
        if policy not in ("static", "continuous"):
            raise ValueError(f"unknown policy {policy!r}")
        if policy == "continuous" and mesh is not None:
            raise ValueError("continuous batching is LocalComm-only "
                             "(the host drives the admit loop)")
        if width < 1:
            raise ValueError("width must be >= 1")
        if cfg.adapt and graph is None:
            raise ValueError("cfg.adapt needs graph= (the host CSR) to "
                             "re-deal edge segments between batches")
        if cfg.adapt and policy != "static":
            raise ValueError("between-batch adaptation is static-policy "
                             "only (continuous lanes are never quiescent)")
        self.pg = pg
        self.mesh = mesh
        self.app = app
        self.cfg = cfg
        self.width = width
        self.policy = policy
        self.graph = graph          # host CSR; needed when cfg.adapt
        self.migrated_vertices = 0  # total moved by between-batch plans
        self.prog = as_program(POINT_QUERIES[app])
        self.prog.validate(cfg, pg.T, pg.e_chunk, pg.v_chunk)

    def serve(self, sources, arrival: str = "burst", gap: float = 0.0,
              seed: int = 0) -> ServeReport:
        """Serve ``sources`` (original vertex ids) arriving per
        ``arrival`` / ``gap`` (:func:`arrival_cycles`); returns the report
        with one :class:`QueryRecord` per query, in query order."""
        sources = np.asarray(sources, np.int64)
        enq = arrival_cycles(len(sources), arrival, gap, seed)
        queue = deque((i, int(s), float(t))
                      for i, (s, t) in enumerate(zip(sources, enq)))
        serve = (self._serve_static if self.policy == "static"
                 else self._serve_continuous)
        migrated0 = self.migrated_vertices
        records, batches, cyc, en, rounds, seq, drops = serve(queue)
        records.sort(key=lambda r: r.qid)
        return ServeReport(
            app=self.app, policy=self.policy, width=self.width,
            arrival=arrival, records=records, batches=batches,
            total_cycles=cyc, total_energy_pj=en, total_rounds=rounds,
            seq_rounds=seq, drops=drops, f_ghz=self.cfg.perf.f_ghz,
            migrated_vertices=self.migrated_vertices - migrated0)

    # -- between-batch adaptation (repro_torch.place) ----------------------

    def _maybe_adapt(self, res):
        """Relabel the resident partition from the finished batch's
        telemetry: the lane rings' busy vectors summed on the host in lane
        order (the planner's static in-degree fallback when the trace is
        off).  Every lane has drained at a batch boundary, so the move is
        a pure relabeling and later queries see the same values.  Returns
        the move's modelled ``(cycles, pJ)``, which the caller charges to
        the batch clock."""
        busy = None
        if res.trace is not None:
            busy = sum(score_tiles(lane_trace(res.trace, lane))
                       for lane in range(self.width))
        old = self.pg
        pg2, plan = adapt_partition(self.graph, old, self.cfg, busy=busy)
        if not plan.num_pairs:
            return 0.0, 0.0
        tile_die = cfg_tile_die(self.cfg, old.T)
        wi, wc = migration_words(old, plan, tile_die)
        cyc, pj = migration_cost(self.cfg.perf, wi, wc)
        self.migrated_vertices += plan.moved_vertices(old)
        self.pg = pg2
        # e_chunk can change in the aligned edge modes: re-check sizing
        self.prog.validate(self.cfg, pg2.T, pg2.e_chunk, pg2.v_chunk)
        return cyc, pj

    # -- static batches ----------------------------------------------------

    def _serve_static(self, queue):
        records, batches = [], 0
        now = 0.0
        energy = 0.0
        rounds = seq = drops = 0
        while queue:
            # the batch forms when its first request has arrived
            now = max(now, queue[0][2])
            batch = []
            while queue and len(batch) < self.width and queue[0][2] <= now:
                batch.append(queue.popleft())
            srcs = [s for _, s, _ in batch] + [-1] * (self.width -
                                                      len(batch))
            res = multi_source(self.pg, self.app, srcs, self.cfg, self.mesh)
            lane_rounds = res.stats.rounds.tolist()
            lane_edges = res.stats.edges_scanned.tolist()
            for lane, (qid, s, t_enq) in enumerate(batch):
                records.append(QueryRecord(
                    qid=qid, source=s, enqueue_cycle=t_enq,
                    admit_cycle=now,
                    complete_cycle=now + float(res.done_cycle[lane]),
                    rounds=int(lane_rounds[lane]),
                    edges=int(lane_edges[lane]),
                    values=res.values[lane]))
            now += res.batch_cycles
            energy += res.batch_energy_pj
            rounds += res.total_rounds
            seq += res.seq_rounds
            drops += int(res.stats.drops.sum())
            batches += 1
            if (self.cfg.adapt and queue
                    and batches % max(self.cfg.adapt_every, 1) == 0):
                mig_cyc, mig_pj = self._maybe_adapt(res)
                now += mig_cyc
                energy += mig_pj
        return records, batches, now, energy, rounds, seq, drops

    # -- continuous batching (lane recycling) ------------------------------

    def _serve_continuous(self, queue):
        pg, cfg, W = self.pg, self.cfg, self.width
        shard = GraphShard(pg.ptr_start, pg.deg, pg.edge_dst, pg.edge_val)
        comm = LaneComm(pg.T, W, pg.device)
        net = make_network(cfg, pg.T)

        # born idle: W padding lanes; the admit loop below fills them
        value, frontier = batch_min_state(pg, [-1] * W)
        st = lane_state(comm, cfg, pg.v_chunk, value, frontier, self.prog)
        carry = lane_carry(comm, net, cfg, self.prog, st)
        lane_qid = [-1] * W          # qid in flight per lane (-1 = idle)
        lane_meta = [None] * W       # (qid, source, enqueue, admit)
        records, batches = [], 0
        drops = 0
        now = 0.0                    # absolute serving clock (cycles)

        def admit():
            nonlocal carry, batches, now
            idle = [i for i in range(W) if lane_qid[i] < 0]
            # a fully idle machine fast-forwards to the next arrival
            if queue and len(idle) == W and queue[0][2] > now:
                now = queue[0][2]
            admitted = 0
            for lane in idle:
                if not queue or queue[0][2] > now:
                    break
                assert int(carry.pending[lane]) == 0
                qid, s, t_enq = queue.popleft()
                v1, f1 = batch_min_state(pg, [s])
                carry = _recycle(carry, lane, v1[0], f1[0])
                lane_qid[lane] = qid
                lane_meta[lane] = (qid, s, t_enq, now)
                admitted += 1
            if admitted:
                batches += 1  # here: one lane-refill event
            return admitted

        admit()
        while any(q >= 0 for q in lane_qid):
            prev_clock = float(carry.clock)
            # clear the segment stop flag even when nothing was admitted
            # (no arrival yet): the in-flight lanes must resume
            carry = carry._replace(halt=False)
            carry = local_lanes_segment(self.prog, cfg, pg.T, pg.e_chunk,
                                        pg.v_chunk, shard, carry)
            now += float(carry.clock) - prev_clock
            lane_rounds = carry.stats.rounds.tolist()
            lane_edges = carry.stats.edges_scanned.tolist()
            lane_drops = carry.stats.drops.tolist()
            for lane in range(W):
                if lane_qid[lane] >= 0 and int(carry.pending[lane]) == 0:
                    qid, s, t_enq, t_admit = lane_meta[lane]
                    T = pg.T
                    ring = None
                    if carry.trace is not None:
                        ring = type(carry.trace)(
                            *(x[lane].clone() for x in carry.trace))
                    records.append(QueryRecord(
                        qid=qid, source=s, enqueue_cycle=t_enq,
                        admit_cycle=t_admit, complete_cycle=now,
                        rounds=int(lane_rounds[lane]),
                        edges=int(lane_edges[lane]),
                        values=lane_values(
                            pg, carry.st.value[lane * T:(lane + 1) * T]),
                        trace=ring))
                    drops += int(lane_drops[lane])
                    lane_qid[lane] = -1
            admit()
        # each lane is its solo run, so the sequential cost is the sum of
        # the records' round counts
        seq = sum(r.rounds for r in records)
        return (records, batches, now, float(carry.energy), carry.rounds,
                seq, drops)
