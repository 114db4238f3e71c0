"""The Dalorex task-based programming model, classic part (port of
``repro.core.program``).

* :class:`TaskSpec` — one task channel: payload width, the owner function
  that decodes the destination tile from the head flit, the handler run
  at the owner, and the channel-queue / local-queue / budget knobs.
* :class:`Program` — an ordered chain of task channels run once per
  engine round, plus the *source* that turns frontier bits into the
  first channel's tasks.

:func:`classic_program` compiles an :class:`AlgSpec` to the paper's
Listing-1 program (T1 range split -> T2 edge scan -> T3 fold) for the
five paper workloads; :func:`kcore_program` reuses the shape with a
threshold fold, and :data:`TRIANGLES` is the 4-channel 2-hop chain
(range -> wedge -> second range -> intersection-count fold).

Sources, transforms and handlers are batched per-tile stages: they take
tile-led ``(T, ...)`` tensors and ``me = arange(T)``.  The building
blocks dispatch on ``Ctx.backend``: ``"kernels"`` calls the Hopper kernel
wrappers of :mod:`repro_torch.kernels.engine` (the counterpart of the
reference's unfused ``"pallas"`` backend), ``"torch"`` runs inline
PyTorch ops (the counterpart of ``"xla"``).  Both give the same bits.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.core.queues import f2i, i2f
from repro_torch.kernels.engine import (edge_scan_gather, fold_scatter,
                                        frontier_pop, scatter_body,
                                        segment_gather)
from repro_torch.mem import check_alloc, check_budgets

INF = float(np.finfo(np.float32).max)  # "unreached": float32 max, not inf
BACKENDS = ("kernels", "torch")


class Ctx(NamedTuple):
    """Static per-run context threaded to sources/transforms/handlers.
    ``backend`` is the resolved backend of the current channel."""

    cfg: object   # EngineConfig
    T: int
    e_chunk: int
    v_chunk: int
    backend: str = "kernels"


# --------------------------------------------------------------------------
# Algorithm specifications of the classic workloads.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AlgSpec:
    """How values flow through the classic T1/T2/T3 pipeline.

    ``emit``   — T2's payload: f(parent_value, edge_value) for a neighbor.
    ``kind``   — T3's fold: "min" (relaxation; improvements re-enter the
                 frontier) or "add" (accumulation into ``acc``).
    ``parent`` — what T1 loads from the local shard for a frontier vertex.
    """

    name: str
    kind: str  # "min" | "add"
    emit: str  # "plus1" | "plus_w" | "copy" | "times_w"
    parent: str = "value"  # "value" | "value_over_deg"


BFS = AlgSpec("bfs", "min", "plus1")
SSSP = AlgSpec("sssp", "min", "plus_w")
WCC = AlgSpec("wcc", "min", "copy")
PAGERANK = AlgSpec("pagerank", "add", "copy", parent="value_over_deg")
SPMV = AlgSpec("spmv", "add", "times_w")


def _emit(alg: AlgSpec, parent: torch.Tensor, w: torch.Tensor):
    if alg.emit == "plus1":
        return parent + 1.0
    if alg.emit == "plus_w":
        return parent + w
    if alg.emit == "copy":
        return parent
    if alg.emit == "times_w":
        return parent * w
    raise ValueError(alg.emit)


# --------------------------------------------------------------------------
# TaskSpec / Program.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """One task channel of a Program (fields as in the reference).

    ``owner`` "edge" / "vertex" selects the equal-chunk owner of a placed
    edge / vertex index (``idx // chunk``); a callable ``owner(ctx)`` may
    return any ``msgs -> dest`` function.  ``knobs`` picks the
    EngineConfig defaults ("range" or "update") for the CQ capacity, queue
    capacity and pop budget; ``cap_route`` / ``queue_cap`` / ``pop``
    override them.  ``handler(ctx, me, sh, st, recv, recv_valid) -> (st,
    rows, valid, work)`` runs at the owner tile.  ``backend`` pins this
    channel to "kernels" or "torch" (``None`` inherits the config).
    """

    name: str
    width: int
    owner: Union[str, Callable] = "vertex"
    knobs: str = "update"
    handler: Optional[Callable] = None
    queued: bool = False
    transform: Optional[Callable] = None
    emit_factor: Union[int, str] = 1
    work: str = ""
    cap_route: Optional[int] = None
    queue_cap: Optional[int] = None
    pop: Optional[int] = None
    backend: Optional[str] = None
    space: Optional[str] = None

    def resolve_space(self, cfg) -> str:
        s = self.space if self.space is not None else "vmem"
        check_alloc(s, "queue", f"queue[{self.name}]")
        return s

    def resolve_backend(self, cfg) -> str:
        b = self.backend if self.backend is not None else cfg.backend
        if b not in BACKENDS:
            raise ValueError(f"unknown backend {b!r}; the port has "
                             f"{BACKENDS}")
        return b

    def route_cap(self, cfg) -> int:
        if self.cap_route is not None:
            return self.cap_route
        return (cfg.cap_route_range if self.knobs == "range"
                else cfg.cap_route_update)

    def qcap(self, cfg) -> int:
        if self.queue_cap is not None:
            return self.queue_cap
        return cfg.cap_rangeq if self.knobs == "range" else cfg.cap_updq

    def pop_budget(self, cfg) -> int:
        if self.pop is not None:
            return self.pop
        return cfg.r_pop if self.knobs == "range" else cfg.u_pop

    def emit_bound(self, cfg) -> int:
        f = cfg.max_t2 if self.emit_factor == "max_t2" else self.emit_factor
        return int(f)

    def owner_fn(self, ctx: Ctx) -> Callable:
        if callable(self.owner):
            return self.owner(ctx)
        chunk = ctx.e_chunk if self.owner == "edge" else ctx.v_chunk
        return lambda m: m[..., 0] // chunk


@dataclasses.dataclass(frozen=True)
class Program:
    """An ordered chain of task channels plus the frontier source."""

    name: str
    channels: tuple
    source: Optional[Callable] = None
    edge_space: Optional[str] = None
    state_space: str = "vmem"

    def min_caps(self, cfg, T: int) -> tuple:
        """Per-channel worst-case one-round queue inflow (the reference's
        formula, physical-NoC terms included)."""
        physical = cfg.noc != "ideal"
        deep = len(self.channels) > 2
        needs = []
        for i, ch in enumerate(self.channels):
            cap_i = ch.route_cap(cfg)
            pop_i = ch.pop_budget(cfg)
            if i == 0:
                feed = cfg.f_pop
            else:
                prev = self.channels[i - 1]
                feed = T * prev.route_cap(cfg) * prev.emit_bound(cfg)
            inflow = feed + pop_i
            if physical:
                inflow += pop_i + T * cap_i if ch.queued else T * cap_i
            if i == 0 and ch.queued:
                need = 2 * feed
                if physical:
                    need += 2 * pop_i + T * cap_i
            elif deep:
                need = 4 * inflow
            else:
                need = inflow
            needs.append(need)
        return tuple(needs)

    def validate(self, cfg, T: int, e_chunk: Optional[int] = None,
                 v_chunk: Optional[int] = None):
        """No-drop invariant (every queue absorbs its worst-case inflow)
        and, with the chunks known, the modelled tile's memory budget."""
        for ch, need in zip(self.channels, self.min_caps(cfg, T)):
            cap = ch.qcap(cfg)
            if cap < need:
                raise ValueError(
                    f"program {self.name!r} channel {ch.name!r}: queue cap "
                    f"{cap} < worst-case inflow {need}")
        if e_chunk is not None and v_chunk is not None:
            check_budgets(self.name, self.tile_decls(cfg, T, e_chunk,
                                                     v_chunk),
                          cfg.vmem_limit_bytes)

    def tile_decls(self, cfg, T: int, e_chunk: int, v_chunk: int) -> list:
        """Per-tile ``(label, space, bytes)`` buffer declarations: each
        channel queue (``qcap * width`` int32 words), the vertex state (18
        bytes per owned vertex) and the edge shard (8 bytes per edge)."""
        edge_space = resolve_edge_space(self, cfg)
        decls = [(f"queue[{ch.name}]", ch.resolve_space(cfg),
                  ch.qcap(cfg) * ch.width * 4) for ch in self.channels]
        decls.append(("vertex-state", self.state_space, 18 * v_chunk))
        decls.append((f"edge-shard[{self.name}]", edge_space, 8 * e_chunk))
        return decls


def resolve_edge_space(prog: Program, cfg) -> str:
    """The memory space of the tile's edge shard: a program pin wins, else
    ``cfg.edge_space``.  Only "vmem" (resident shard) is ported."""
    want = cfg.edge_space
    if prog.edge_space is not None:
        if want not in ("vmem", prog.edge_space):
            raise ValueError(
                f"program {prog.name!r} pins its edge shard to "
                f"{prog.edge_space!r}, but cfg.edge_space={want!r}")
        space = prog.edge_space
    else:
        space = want
    if space == "hbm":
        raise NotImplementedError(
            "edge_space='hbm' (streamed edge shards) is still to port "
            "(ROADMAP.md, 'Memory spaces in full')")
    check_alloc(space, "edge", f"edge-shard[{prog.name}]")
    return space


# --------------------------------------------------------------------------
# Building blocks: frontier source, range split, edge scan, folds.
# --------------------------------------------------------------------------

def take_first_k(mask: torch.Tensor, k: torch.Tensor, k_max: int):
    """Indices of the first ``min(k, popcount)`` set bits of each tile's
    bitmap, FIFO by position, by an argsort of rank keys (the "torch"
    twin of the ``frontier_pop`` kernel; invalid ``idx`` slots hold
    unpopped positions instead of 0).  mask (T, n), k (T,).
    Returns (idx (T, min(k_max, n)) int32, valid, cleared mask)."""
    T, n = mask.shape
    ar = torch.arange(n, dtype=torch.int32, device=mask.device)[None]
    mi = mask.to(torch.int32)
    rank = torch.cumsum(mi, dim=1, dtype=torch.int32) - mi
    take = mask & (rank < k[:, None])
    key = torch.where(take, rank, n + ar)
    order = torch.argsort(key, dim=1)[:, :k_max]
    valid = torch.gather(take, 1, order)
    return order.to(torch.int32), valid, mask & ~take


def frontier_source(payload: Callable) -> Callable:
    """T4: pop up to the TSU budget of frontier bits into channel-0 tasks
    ``(edge_start, edge_end, *payload)``.  ``payload(ctx, me, sh, st, vidx,
    deg)`` returns the payload column(s), (T, k) or (T, k, P) int32."""

    def source(ctx: Ctx, me, sh, st, budget):
        if ctx.backend == "kernels":
            vidx, vvalid, frontier = frontier_pop(st.frontier, budget,
                                                  ctx.cfg.f_pop)
        else:
            vidx, vvalid, frontier = take_first_k(st.frontier, budget,
                                                  ctx.cfg.f_pop)
        vl = vidx.to(torch.int64)
        deg = sh.deg.gather(1, vl)
        start = sh.ptr_start.gather(1, vl)
        pay = payload(ctx, me, sh, st, vidx, deg)
        if pay.ndim == 2:
            pay = pay[:, :, None]
        vvalid = vvalid & (deg > 0)
        rows = torch.cat([start[:, :, None], (start + deg)[:, :, None], pay],
                         dim=2)
        return st._replace(frontier=frontier), rows, vvalid

    return source


def range_split(ctx: Ctx, taken: torch.Tensor, tvalid: torch.Tensor):
    """Listing 1's T1: bound each popped range task at the chunk border and
    at MAX_T2; re-push the remainder.  Payload columns ride along."""
    t_start, t_end = taken[..., 0], taken[..., 1]
    boundary = (t_start // ctx.e_chunk + 1) * ctx.e_chunk
    stop = torch.minimum(torch.minimum(t_end, boundary),
                         t_start + ctx.cfg.max_t2)
    pay = taken[..., 2:]
    msgs = torch.cat([t_start[..., None], stop[..., None], pay], dim=-1)
    rem = torch.cat([stop[..., None], t_end[..., None], pay], dim=-1)
    return msgs, tvalid, rem, tvalid & (stop < t_end)


def edge_scan(emit_rows: Callable) -> Callable:
    """T2 skeleton: scan the local edge chunk for each received range
    message ``(start, stop, *payload)``; ``emit_rows(ctx, recv, nb, w,
    jvalid)`` maps the (T, R, MAX_T2) neighbor/weight grids to output rows
    (T, R, MAX_T2, W') and their validity."""

    def handler(ctx: Ctx, me, sh, st, recv, rv):
        r_start, r_stop = recv[..., 0], recv[..., 1]
        if ctx.backend == "kernels":
            nb, w, jvalid = edge_scan_gather(
                sh.edge_dst, sh.edge_val, r_start.contiguous(),
                r_stop.contiguous(), rv.contiguous(), ctx.cfg.max_t2)
        else:
            # the reference's inline gather is the same ops as the body
            nb, w, jvalid = segment_gather(sh.edge_dst, sh.edge_val,
                                           r_start, r_stop, rv,
                                           ctx.cfg.max_t2)
        rows, ov = emit_rows(ctx, recv, nb, w, jvalid)
        edges = jvalid.sum(dim=(1, 2), dtype=torch.int32)
        T = rows.shape[0]
        return st, rows.reshape(T, -1, rows.shape[-1]), ov.reshape(T, -1), \
            edges

    return handler


def scatter_fold(ctx: Ctx, target, lidx, vals, valid, op: str):
    """T3 scatter primitive: min/add ``vals[valid]`` into each tile's
    ``target`` at local indices ``lidx`` (invalid rows already mapped to
    the trash slot ``v_chunk``)."""
    if ctx.backend == "kernels":
        return fold_scatter(target, lidx.contiguous(), vals.contiguous(),
                            valid.contiguous(), op=op)
    return scatter_body(target, lidx, vals, valid, op)


def min_fold(ctx: Ctx, me, sh, st, recv, rv):
    """T3 for relaxations: scatter-min into ``value``; improved vertices
    re-enter the live (async) or next-epoch (BSP) frontier."""
    nb, vb = recv[..., 0], recv[..., 1]
    lidx = torch.where(rv, nb % ctx.v_chunk, ctx.v_chunk)  # pad -> trash
    val = i2f(vb)
    applied = rv.sum(dim=1, dtype=torch.int32)
    after = scatter_fold(ctx, st.value, lidx, val, rv, "min")
    improved = after < st.value
    return _rearm(ctx, st._replace(value=after), improved), None, None, \
        applied


def _rearm(ctx: Ctx, st, hit):
    """Re-arm ``hit`` vertices: in the live frontier (async) or in the
    next epoch's (BSP)."""
    if ctx.cfg.mode == "async":
        return st._replace(frontier=st.frontier | hit)
    return st._replace(next_frontier=st.next_frontier | hit)


def add_fold(ctx: Ctx, me, sh, st, recv, rv):
    """T3 for accumulations: scatter-add into ``acc`` in row order
    (atomic-free: this tile is the only owner)."""
    nb, vb = recv[..., 0], recv[..., 1]
    lidx = torch.where(rv, nb % ctx.v_chunk, ctx.v_chunk)
    val = i2f(vb)
    applied = rv.sum(dim=1, dtype=torch.int32)
    acc = scatter_fold(ctx, st.acc, lidx, val, rv, "add")
    return st._replace(acc=acc), None, None, applied


# --------------------------------------------------------------------------
# The classic 3-task program.
# --------------------------------------------------------------------------

@lru_cache(maxsize=None)
def classic_program(alg: AlgSpec) -> Program:
    """Compile an AlgSpec to the paper's Listing-1 program: T1 range split
    -> T2 edge scan (routed to the edge owner) -> T3 fold (routed to the
    neighbor's vertex owner)."""

    def payload(ctx, me, sh, st, vidx, deg):
        value = st.value.gather(1, vidx.to(torch.int64))
        if alg.parent == "value_over_deg":
            # an eager float32 division, correctly rounded on every device
            value = value / torch.clamp(deg, min=1).to(torch.float32)
        return f2i(value)

    def emit_rows(ctx, recv, nb, w, jvalid):
        out = _emit(alg, i2f(recv[..., 2])[..., None], w).expand(nb.shape)
        return torch.stack([nb, f2i(out)], dim=-1), jvalid

    return Program(
        name=alg.name,
        source=frontier_source(payload),
        channels=(
            TaskSpec("range", width=3, owner="edge", knobs="range",
                     queued=True, transform=range_split,
                     handler=edge_scan(emit_rows), emit_factor="max_t2",
                     work="edges"),
            TaskSpec("update", width=2, owner="vertex", knobs="update",
                     handler=min_fold if alg.kind == "min" else add_fold,
                     work="updates"),
        ))


def as_program(alg) -> Program:
    """AlgSpec -> Program (cached); Programs pass through."""
    if isinstance(alg, Program):
        return alg
    return classic_program(alg)


def sized_cfg(cfg, program: Program, T: int):
    """Return ``cfg`` with ``cap_rangeq``/``cap_updq`` raised (next power
    of two) to satisfy ``program.validate`` — for programs whose channel
    inflow exceeds the classic defaults (triangles' second range
    channel).  Deep chains ask ``min_caps`` for 4x the one-round inflow,
    so the TSU's throttle has a full burst of headroom above 3/4."""
    rangeq, updq = cfg.cap_rangeq, cfg.cap_updq
    for ch, need in zip(program.channels, program.min_caps(cfg, T)):
        if ch.queue_cap is not None:
            continue
        need = 1 << (max(int(need), 1) - 1).bit_length()
        if ch.knobs == "range":
            rangeq = max(rangeq, need)
        else:
            updq = max(updq, need)
    return dataclasses.replace(cfg, cap_rangeq=rangeq, cap_updq=updq)


# --------------------------------------------------------------------------
# k-core peeling: the classic shape with a threshold fold (different T3).
# --------------------------------------------------------------------------

@lru_cache(maxsize=None)
def kcore_program(k: int) -> Program:
    """Peel the k-core: removed vertices emit one decrement per out-edge;
    the fold subtracts and re-arms the frontier when a still-alive vertex
    drops below k (``acc`` is the removed flag).  Needs a symmetrized,
    deduplicated graph; async and BSP reach the same fixed point."""
    kf = float(k)
    one = int(np.float32(1.0).view(np.int32))

    def payload(ctx, me, sh, st, vidx, deg):
        return torch.full_like(vidx, one)

    def emit_rows(ctx, recv, nb, w, jvalid):
        return torch.stack([nb, torch.full_like(nb, one)], dim=-1), jvalid

    def fold(ctx, me, sh, st, recv, rv):
        nb, vb = recv[..., 0], recv[..., 1]
        lidx = torch.where(rv, nb % ctx.v_chunk, ctx.v_chunk)
        dec = i2f(vb)
        applied = rv.sum(dim=1, dtype=torch.int32)
        after = scatter_fold(ctx, st.value, lidx, -dec, rv, "add")
        newly = (st.acc == 0.0) & (after < kf)
        acc = torch.where(newly, 1.0, st.acc)
        return _rearm(ctx, st._replace(value=after, acc=acc), newly), \
            None, None, applied

    return Program(
        name=f"kcore{k}",
        source=frontier_source(payload),
        channels=(
            TaskSpec("range", width=3, owner="edge", knobs="range",
                     queued=True, transform=range_split,
                     handler=edge_scan(emit_rows), emit_factor="max_t2",
                     work="edges"),
            TaskSpec("decrement", width=2, owner="vertex", knobs="update",
                     handler=fold, work="updates"),
        ))


# --------------------------------------------------------------------------
# 2-hop triangle counting: a 4-channel chain (range -> wedge -> second
# range at the neighbor's owner -> intersection-count fold).
# --------------------------------------------------------------------------

def _segment_contains(edge_dst: torch.Tensor, lo, deg, target):
    """Batched bounded binary search: is ``target`` in the sorted local
    segment ``edge_dst[t, lo : lo+deg]`` of each tile?  edge_dst
    (T, e_chunk); lo, deg, target (T, R).  A fixed log2(e_chunk)+1 steps,
    as the reference takes."""
    e_chunk = edge_dst.shape[1]

    def at(i):
        return edge_dst.gather(1, torch.clamp(i, 0, e_chunk - 1)
                               .to(torch.int64))

    left, right = lo, lo + deg
    for _ in range(max(1, int(e_chunk).bit_length())):
        has = left < right
        mid = torch.div(left + right, 2, rounding_mode="floor")
        go = has & (at(mid) < target)
        left = torch.where(go, mid + 1, left)
        right = torch.where(has & ~go, mid, right)
    return (left < lo + deg) & (at(left) == target)


def _make_triangles_program() -> Program:
    """Count each triangle once at its placed-minimum vertex: wedges
    v -> u -> w with v < u < w (placed order) close iff w is in adj(v).
    Needs a ``prepare_triangles`` partition (vertex-aligned edges, each
    vertex's segment sorted by placed destination)."""

    def payload(ctx, me, sh, st, vidx, deg):
        return me[:, None] * ctx.v_chunk + vidx  # placed vertex id

    def scan1_rows(ctx, recv, nb, w, jvalid):
        v = recv[..., 2][..., None].expand(nb.shape)
        return torch.stack([nb, v], dim=-1), jvalid & (nb > v)

    def wedge_to_range(ctx, me, sh, st, recv, rv):
        # at u's owner: u's adjacency range -> the second-hop range task
        u, v = recv[..., 0], recv[..., 1]
        lidx = torch.where(rv, u % ctx.v_chunk, 0).to(torch.int64)
        start = sh.ptr_start.gather(1, lidx)
        deg = sh.deg.gather(1, lidx)
        rows = torch.stack([start, start + deg, v, u], dim=-1)
        return st, rows, rv & (deg > 0), \
            torch.zeros(u.shape[0], dtype=torch.int32, device=u.device)

    def scan2_rows(ctx, recv, nb, w, jvalid):
        v = recv[..., 2][..., None].expand(nb.shape)
        u = recv[..., 3][..., None]
        return torch.stack([v, nb], dim=-1), jvalid & (nb > u)

    def close_fold(ctx, me, sh, st, recv, rv):
        # at v's owner: does the closing edge (v, w) exist in v's sorted,
        # local adjacency?
        v, w = recv[..., 0], recv[..., 1]
        lidx = torch.where(rv, v % ctx.v_chunk, 0)
        lo = sh.ptr_start.gather(1, lidx.to(torch.int64)) % ctx.e_chunk
        deg = sh.deg.gather(1, lidx.to(torch.int64))
        found = _segment_contains(sh.edge_dst, lo, deg, w) & rv
        slot = torch.where(rv, lidx, ctx.v_chunk)
        acc = scatter_fold(ctx, st.acc, slot, found.to(torch.float32), rv,
                           "add")
        return st._replace(acc=acc), None, None, \
            found.sum(dim=1, dtype=torch.int32)

    return Program(
        name="triangles",
        source=frontier_source(payload),
        edge_space="vmem",  # close_fold searches the resident shard
        channels=(
            TaskSpec("range", width=3, owner="edge", knobs="range",
                     queued=True, transform=range_split,
                     handler=edge_scan(scan1_rows), emit_factor="max_t2",
                     work="edges"),
            TaskSpec("wedge", width=2, owner="vertex", knobs="update",
                     handler=wedge_to_range, emit_factor=1),
            TaskSpec("range2", width=4, owner="edge", knobs="range",
                     queued=True, transform=range_split,
                     handler=edge_scan(scan2_rows), emit_factor="max_t2",
                     work="edges"),
            TaskSpec("close", width=2, owner="vertex", knobs="update",
                     handler=close_fold, work="updates"),
        ))


TRIANGLES = _make_triangles_program()
