"""Fused engine legs: one Hopper kernel launch per channel leg (port of
``repro.kernels.engine.kernel.fused_leg_call``).

The reference's ``fused_leg_call(fn, *operands)`` makes the per-tile
stage ``fn`` itself the body of one ``pallas_call``.  Here each leg of the
repository's programs is a hand-written CUDA kernel
(``csrc/fused_legs.cu``), templated on the :class:`LegTemplate`, over a
grid of G blocks a tile and one or two more: leg 0's G blocks move the
range queue's old live rows while one more takes the frontier; the scan
legs' share messages and live rows, the wedge leg's wedges and live rows,
the close leg's the searched rows, the fold legs' column ranges of the
slice (:func:`~repro_torch.kernels.engine.kernel.column_split`); one more
block a tile appends the spills (the wedge leg: two, its append and its
pop).
Leg ``i`` of a K-channel program is channel ``i - 1``'s handler plus
channel ``i``'s ingest (leg 0: the source plus channel 0's ingest; leg K:
channel K-1's handler):

========================  ===============================================
wrapper                   one launch computes, per tile
========================  ===============================================
:func:`fused_leg0`        TSU budgets, T4 frontier pop and payload, range-
                          queue turn (live rows), T1 range split, remainder
                          re-push (classic and k-core leg 0)
:func:`fused_leg1`        range-spill re-queue, T2 scan (resident gather or
                          streamed windows) and emit, update-queue replay
                          turn, replay + fresh rows into the messages
                          (classic and k-core leg 1)
:func:`fused_leg2`        update-spill re-queue (in place), T3 min fold +
                          frontier re-arm (async or BSP) or ordered add fold
:func:`fused_kcore_leg2`  decrement-spill re-queue (in place), ordered add
                          of the decrements into ``value``, the newly
                          removed vertices into ``acc`` and the re-armed
                          flags
:func:`fused_tri_leg0`    leg 0 with the placed-id payload and the TSU over
                          the four queues of the triangles chain
:func:`fused_tri_leg1`    leg 1 emitting wedges ``(nb, v)``, valid iff
                          ``nb > v``; wedge-queue replay
:func:`fused_tri_leg2`    wedge-spill re-queue, ``wedge_to_range``, range2-
                          queue turn of the width-4 rows, T1 range split,
                          remainder re-push
:func:`fused_tri_leg3`    leg 1 on width-4 messages emitting ``(v, nb)``,
                          valid iff ``nb > u``; close-queue replay
:func:`fused_tri_leg4`    close-spill re-queue (in place), bounded binary
                          search of the closing edge, the hits added into
                          ``acc`` by slot counts
========================  ===============================================

:data:`LEGS` names each program family's wrappers, leg by leg
(``Program.fused.family``).  Each wrapper takes the stage's own arguments
and returns what the stage returns.  Its plain version is the stage
itself, ``plain``, built by the engine under ``Ctx.fused``: the same
composition of the plain bodies of :mod:`repro_torch.kernels.engine.
kernel` (``frontier_take``, ``fifo_turn``, ``queue_push``,
``segment_gather``/``segment_stream``, ``scatter_body``), as the
reference's fused body composes its pure bodies.  On CPU tensors a wrapper
runs ``plain``; on CUDA tensors it launches its kernel and raises if the
launch failed, with no fallback.  Each call is one
:func:`~repro_torch.kernels.engine.launches.record`, so a round counts one
launch per leg (3 for the classic and k-core programs, 5 for triangles),
as the reference's fused round.

The state may hold B * T lane-major rows of B serving lanes over one
``(T, ...)`` shard (:mod:`repro_torch.serve`): every leg is one launch
for the whole batch, and leg 0 and the scan legs read shard row ``row %
T`` (:func:`~repro_torch.kernels.engine.kernel.shard_rows`); the fold
legs touch state only.  Under SPMD (:class:`~repro_torch.core.comm.
AxisComm`) a process holds one tile: the shard has one row and leg 0's
placed-id payload takes the tile id from ``LegTemplate.tile0`` (the
rank), not from the row.

The kernels write what the plain stage writes where the reference
defines it: every queue row below its count, every valid message row,
every other output.  Two kinds of don't-care element differ.  A queue that
leg 0, a scan leg or the wedge leg turns holds its live rows only: its
slots from the new count on are left unwritten (the plain stage's shift
keeps stale rows there).  And the popped message rows past the pop, which
are invalid, hold 0 (the plain stage keeps the stale queue rows).  No
consumer reads either: ``tests/test_torch_dont_care.py`` poisons both
after every plain stage and the runs keep every bit.  Five legs append
their spills in place onto the queue the previous leg of the same round
made fresh (leg 1: the range queue; leg 2 and k-core's leg 2: the update
queue; the wedge leg: the wedge queue; the close leg: the close queue):
the returned state's queue shares that storage.

Past what shared memory holds, each kernel takes a second path with the
same bits (``path`` on the wrapper names the last launch's): leg 0 and the
wedge leg stage their popped rows in a device-memory scratch past
``STAGE_SMEM_MAX`` bytes, the add folds of leg 2 sort in row-order chunks
of ``FOLD_ADD_MAX_ROWS`` rows, and a streamed scan leg reads a window
wider than ``STREAM_MAX_WINDOW`` from device memory.  The close leg sorts
nothing and has one path at any row count (:data:`CLOSE_PATH`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.queues import Queue
from repro_torch.kernels.cuda_build import I as _I, P as _P
from repro_torch.kernels.cuda_build import CudaLibrary, check as _check
from repro_torch.kernels.engine.kernel import (CSRC, ENGINE_DEVICE,
                                               MIN_FOLD_MAX_ROWS,
                                               ORDERED_SCATTER, add_chunks,
                                               device_split, shard_rows,
                                               staging, window_path)
from repro_torch.kernels.engine.launches import record

_L = ctypes.c_longlong  # a staging's bytes a tile
SOURCE = CSRC / "fused_legs.cu"
LIBRARY = CudaLibrary(SOURCE, {
    "repro_fused_leg0": [_P] * 18 + [_I] * 15 + [_L, _P],
    "repro_fused_leg0_chain": [_P] * 20 + [_I] * 19 + [_L, _P],
    "repro_fused_leg1": [_P] * 22 + [_I] * 12 + [_P],
    "repro_fused_leg1_chain": [_P] * 22 + [_I] * 13 + [_P],
    "repro_fused_leg2": [_P] * 14 + [_I] * 8 + [_P],
    "repro_fused_kcore_leg2": [_P] * 16 + [_I] * 8 + [_P],
    "repro_fused_wedge_leg": [_P] * 22 + [_I] * 12 + [_L, _P],
    "repro_fused_close_leg": [_P] * 16 + [_I] * 8 + [_P],
}, headers=(ENGINE_DEVICE, ORDERED_SCATTER))
_launch = LIBRARY.launch

# template codes shared with csrc/fused_legs.cu; the mode picks the flags
# the fold legs re-arm (frontier or next_frontier), so it is no template
PAYLOADS = ("value", "value_over_deg", "one", "placed")
EMITS = ("plus1", "plus_w", "copy", "times_w", "one", "wedge", "close")
FOLDS = ("min", "add", "kcore")
POLICIES = ("traffic", "static")


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def leg0_stage_bytes(f_pop: int, eff: int) -> int:
    """Leg 0's staging a tile (csrc/fused_legs.cu ``leg0_stage_bytes``):
    the f_pop popped slots and compacted rows of 3, the eff popped tasks of
    3 and their remainder flags."""
    return (_pad16(4 * f_pop) + _pad16(12 * f_pop) + _pad16(12 * eff)
            + _pad16(eff))


def wedge_stage_bytes(eff: int) -> int:
    """The wedge leg's staging a tile (``wedge_stage_bytes``): the eff
    popped tasks of 4 and their remainder flags."""
    return _pad16(16 * eff) + _pad16(eff)


# The range-queue rows one of leg 0's G blocks may have to move: 32,768
# rows of 12 bytes take each of its 1,024 threads 24 steps of 4 moves,
# about the source block's own chain.  A grid of more 1,024-thread blocks
# than the SMs hold at once runs in waves, so the main paths' queues
# (2,048 and 32,768 rows) take one block.
LEG0_BLOCK_ROWS = 32768


def leg0_split(T: int, cap_r: int, dev) -> int:
    """Leg 0's G blocks a tile that move the range queue's old live rows:
    one per LEG0_BLOCK_ROWS rows of its capacity, at most the column
    split's."""
    return max(1, min(device_split(T, cap_r, dev).G,
                      -(-cap_r // LEG0_BLOCK_ROWS)))


def close_split(T: int, R: int, dev):
    """The close leg's G blocks a tile: the column split of its R rows."""
    return device_split(T, R, dev)


def scan_split(T: int, R: int, max_t2: int, dev):
    """The scan leg's G blocks a tile: the column split of its R * max_t2
    message lanes."""
    return device_split(T, R * max_t2, dev)


def wedge_split(T: int, R: int, dev):
    """The wedge leg's G blocks a tile: the column split of its R wedges."""
    return device_split(T, R, dev)


class LegTemplate(NamedTuple):
    """The static shape of a round's legs: the program's codes (payload,
    emit, fold, and k-core's threshold ``k``), the run's mode and TSU
    policy, the edge shard's window (0: resident), the budgets of the
    TSU (``pops``: each channel's pop budget), and ``tile0``, the tile id
    of shard row 0 (the comm's ``tile0``: 0 where the launch holds every
    tile, the rank where a process runs one tile), which leg 0's placed-id
    payload adds to the row's shard row."""

    payload: str
    emit: str
    fold: str
    k: int
    mode: str
    policy: str
    window: int
    f_pop: int
    pops: tuple
    max_t2: int
    plimit: int
    tile0: int = 0


def _code(options, value):
    if value not in options:
        raise ValueError(f"{value!r} not in {options}")
    return options.index(value)


def _count(name: str, path=None) -> None:
    """One CUDA launch of wrapper ``name`` on ``path``, on the wrapper
    itself (looked up in :data:`KERNELS`, so a caller that wraps the
    module's functions does not hide it)."""
    _WRAPPERS[name].launches += 1
    _WRAPPERS[name].path = path


def _on_cpu(st) -> bool:
    return st.frontier.device.type == "cpu"


def _with_queues(st, i: int, *qs):
    """``st`` with queues ``i, i + 1, ...`` replaced by ``qs``."""
    queues = list(st.queues)
    queues[i:i + len(qs)] = qs
    return st._replace(queues=tuple(queues))


def _spill_checks(q, sp, spv, recv, rv, T, w):
    """The checks of a spill re-queue into ``q`` (rows of ``w`` words) and
    of the delivered messages of the same channel."""
    cap = q.data.shape[1]
    S, R = sp.shape[1], recv.shape[1]
    return (("queue", q.data, torch.int32, (T, cap, w)),
            ("queue count", q.count, torch.int32, (T,)),
            ("spill", sp, torch.int32, (T, S, w)),
            ("spill_valid", spv, torch.bool, (T, S)),
            ("recv", recv, torch.int32, (T, R, w)),
            ("recv_valid", rv, torch.bool, (T, R)))


# --------------------------------------------------------------------------
# Leg 0: the source leg.
# --------------------------------------------------------------------------

def _source_leg(name: str, tmpl: LegTemplate, plain, me, sh, st):
    if _on_cpu(st):
        record()
        return plain(me, sh, st)
    queues = st.queues
    rq, K = queues[0], len(queues)
    T, v_chunk = st.frontier.shape
    Ts = sh.deg.shape[0]
    shard_rows(sh.deg, T)
    cap_r = rq.data.shape[1]
    eff = min(tmpl.pops[0], cap_r)
    e_chunk = sh.edge_dst.shape[1]
    _check(("frontier", st.frontier, torch.bool, (T, v_chunk)),
           ("value", st.value, torch.float32, (T, v_chunk)),
           ("deg", sh.deg, torch.int32, (Ts, v_chunk)),
           ("ptr_start", sh.ptr_start, torch.int32, (Ts, v_chunk)),
           ("range queue", rq.data, torch.int32, (T, cap_r, 3)),
           *((f"queue {i} count", q.count, torch.int32, (T,))
             for i, q in enumerate(queues)),
           ("net_pressure", st.net_pressure, torch.int32, (T,)))
    dev = st.frontier.device
    nbytes = leg0_stage_bytes(tmpl.f_pop, eff)
    path, scratch = staging(T, nbytes, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    frontier = torch.empty_like(st.frontier)
    qdata = torch.empty_like(rq.data)
    msgs = torch.empty((T, eff, 3), **i32)
    mvalid = torch.empty((T, eff), dtype=torch.bool, device=dev)
    # the queue count, drops, npop, npush and dyn_pops in one allocation
    ints = torch.empty((4 + K) * T, **i32)
    qcount, counts = ints[:T], ints[T:4 * T].view(3, T)
    dyn_pops = ints[4 * T:].view(T, K)
    ins = (st.frontier, st.value, sh.deg, sh.ptr_start, rq.data, rq.count)
    outs = (st.net_pressure, frontier, qdata, qcount, msgs, mvalid,
            counts[0], dyn_pops, counts[1], counts[2], scratch, T, Ts,
            tmpl.tile0, v_chunk, e_chunk, cap_r)
    codes = (tmpl.max_t2, tmpl.plimit, _code(PAYLOADS, tmpl.payload),
             _code(POLICIES, tmpl.policy), leg0_split(T, cap_r, dev), nbytes)
    if K == 2:
        uq = queues[1]
        _launch("repro_fused_leg0", *ins, uq.count, *outs, uq.data.shape[1],
                tmpl.f_pop, tmpl.pops[0], tmpl.pops[1], *codes)
    elif K == 4:
        _launch("repro_fused_leg0_chain", *ins,
                *(q.count for q in queues[1:]), *outs,
                *(q.data.shape[1] for q in queues[1:]), tmpl.f_pop,
                *tmpl.pops, *codes)
    else:
        raise ValueError(f"fused leg 0 runs 2- or 4-channel programs; got "
                         f"{K} channels")
    _count(name, path)
    record()
    st = _with_queues(st._replace(frontier=frontier), 0,
                      Queue(qdata, qcount))
    return st, msgs, mvalid, counts[0], dyn_pops, counts[1], counts[2]


def fused_leg0(tmpl: LegTemplate, plain, me, sh, st):
    """Leg 0 of a classic or k-core round (the engine's ``stage_first``).
    Returns ``(state, msgs (T, r_pop, 3), mvalid, drops, dyn_pops (T, 2),
    npop, npush)``; the state's frontier and range queue are new."""
    return _source_leg("fused_leg0", tmpl, plain, me, sh, st)


def fused_tri_leg0(tmpl: LegTemplate, plain, me, sh, st):
    """Leg 0 of a triangles round: :func:`fused_leg0` with the placed-id
    payload and ``dyn_pops`` (T, 4) from the four queue counts."""
    return _source_leg("fused_tri_leg0", tmpl, plain, me, sh, st)


# --------------------------------------------------------------------------
# The scan legs: range-spill re-queue, T2 + emit, replay of a spill queue.
# --------------------------------------------------------------------------

def _scan_leg(name: str, chan: int, emit: str, tmpl: LegTemplate, plain, me,
              sh, st, recv, rv, sp, spv, dyn_pops):
    """Channel ``chan - 1`` (a range channel)'s handler, then the replay
    turn of the spill-only channel ``chan``, over a grid (T, G + 1)
    (:func:`scan_split`).  The range spills append in place onto queue
    ``chan - 1``, which the previous leg of the round made; queue ``chan``
    is new and holds its live rows only."""
    if _on_cpu(st):
        record()
        return plain(me, sh, st, recv, rv, sp, spv, dyn_pops)
    recv, rv, sp, spv = (x.contiguous() for x in (recv, rv, sp, spv))
    rq, uq = st.queues[chan - 1], st.queues[chan]
    K = len(st.queues)
    T, cap_r, W = rq.data.shape
    cap_u = uq.data.shape[1]
    Ts, e_chunk = sh.edge_dst.shape
    shard_rows(sh.edge_dst, T)
    S, R = sp.shape[1], recv.shape[1]
    _check(*_spill_checks(rq, sp, spv, recv, rv, T, W),
           ("edge_dst", sh.edge_dst, torch.int32, (Ts, e_chunk)),
           ("edge_val", sh.edge_val, torch.float32, (Ts, e_chunk)),
           ("update queue", uq.data, torch.int32, (T, cap_u, 2)),
           ("update count", uq.count, torch.int32, (T,)),
           ("dyn_pops", dyn_pops, torch.int32, (T, K)))
    if tmpl.window and tmpl.window < tmpl.max_t2:
        raise ValueError(f"fused leg 1: window {tmpl.window} must be at "
                         f"least max_t2={tmpl.max_t2}")
    u_pop = tmpl.pops[chan]
    eff = min(u_pop, cap_u)
    n_msgs = eff + R * tmpl.max_t2
    dev = rq.data.device
    i32 = dict(dtype=torch.int32, device=dev)
    udata = torch.empty_like(uq.data)
    # queue counts (range, update), drops, edges, npop, npush, nspill; then
    # the G blocks' edge sums and tickets, which the launch clears
    counts = torch.empty((9, T), **i32)
    msgs = torch.empty((T, n_msgs, 2), **i32)
    mvalid = torch.empty((T, n_msgs), dtype=torch.bool, device=dev)
    G = scan_split(T, R, tmpl.max_t2, dev).G
    path = window_path(tmpl.window) if tmpl.window else "resident"
    args = (rq.data, rq.count, sp, spv, recv, rv, sh.edge_dst, sh.edge_val,
            uq.data, uq.count, dyn_pops, counts[0], udata, counts[1], msgs,
            mvalid, counts[2], counts[3], counts[4], counts[5], counts[6],
            counts[7:], T, Ts, cap_r, S, R, e_chunk, tmpl.max_t2)
    if K == 2:
        _launch("repro_fused_leg1", *args, tmpl.window, cap_u, u_pop,
                _code(EMITS, emit), G)
    else:  # the chain's shard is resident (triangles pins it)
        if tmpl.window:
            raise ValueError("the triangles chain scans a resident shard")
        _launch("repro_fused_leg1_chain", *args, cap_u, u_pop, K, chan,
                _code(EMITS, emit), G)
    _count(name, path)
    record()
    st = _with_queues(st, chan - 1, Queue(rq.data, counts[0]),
                      Queue(udata, counts[1]))
    return (st, msgs, mvalid, counts[2], counts[3], counts[4], counts[5],
            counts[6])


def fused_leg1(tmpl: LegTemplate, plain, me, sh, st, recv, rv, sp, spv,
               dyn_pops):
    """Leg 1 of a classic or k-core round (the engine's mid stage): range-
    spill re-queue (in place), T2 with ``tmpl.emit``, update-queue replay.
    Returns ``(state, msgs (T, u_pop + R * max_t2, 2), mvalid, drops,
    edges, npop, npush, nspill)``; the state's update queue is new, its
    range queue the one it was given, with the spills appended.  A second
    call on the same operands appends the same rows again and gives the
    same bits."""
    return _scan_leg("fused_leg1", 1, tmpl.emit, tmpl, plain, me, sh, st,
                     recv, rv, sp, spv, dyn_pops)


def fused_tri_leg1(tmpl: LegTemplate, plain, me, sh, st, recv, rv, sp, spv,
                   dyn_pops):
    """Leg 1 of a triangles round: range-spill re-queue, T2 emitting the
    wedges ``(nb, v)`` valid iff ``nb > v``, wedge-queue replay; the
    returns of :func:`fused_leg1`: queue 0 appended in place, queue 1
    new."""
    return _scan_leg("fused_tri_leg1", 1, "wedge", tmpl, plain, me, sh, st,
                     recv, rv, sp, spv, dyn_pops)


def fused_tri_leg3(tmpl: LegTemplate, plain, me, sh, st, recv, rv, sp, spv,
                   dyn_pops):
    """Leg 3 of a triangles round: range2-spill re-queue, T2 of the width-4
    messages ``(start, stop, v, u)`` emitting ``(v, nb)`` valid iff ``nb >
    u``, close-queue replay; the returns of :func:`fused_leg1`: queue 2
    appended in place, queue 3 new."""
    return _scan_leg("fused_tri_leg3", 3, "close", tmpl, plain, me, sh, st,
                     recv, rv, sp, spv, dyn_pops)


# --------------------------------------------------------------------------
# The fold legs.
# --------------------------------------------------------------------------

def fused_leg2(tmpl: LegTemplate, plain, me, sh, st, recv, rv, sp, spv):
    """Leg 2 of a classic round (the engine's ``stage_last``):
    update-spill re-queue, then the T3 fold, over a grid (T, G + 1): G
    column ranges of each tile's slice (:func:`~repro_torch.kernels.
    engine.kernel.column_split`) and the tile's spill append.  Returns
    ``(state, drops, applied, nspill)``; ``value``
    and the re-armed frontier (min fold; ``next_frontier`` in BSP mode)
    or ``acc`` (add fold) are new.

    The kernel appends the spill rows onto the update queue it is given,
    in place, at its count, and copies nothing: the returned state's queue
    shares that storage (``data``), and holds what the plain stage's
    copy-and-append holds, bit for bit.  The input queue changes with it,
    in slots from its count on: the engine's round always gives the leg
    the queue that leg 1 of the same round has just made, which nothing
    else reads.  A second call on the same operands writes the same rows
    again and gives the same bits."""
    if _on_cpu(st):
        record()
        return plain(me, sh, st, recv, rv, sp, spv)
    recv, rv, sp, spv = (x.contiguous() for x in (recv, rv, sp, spv))
    rq, uq = st.queues
    T, cap_u, _ = uq.data.shape
    v_chunk = st.value.shape[1]
    S, R = sp.shape[1], recv.shape[1]
    is_min = tmpl.fold == "min"
    if is_min and R > MIN_FOLD_MAX_ROWS:
        raise ValueError(f"fused leg 2: a min fold of {R} rows a tile; its "
                         f"kernel folds at most {MIN_FOLD_MAX_ROWS}")
    target = st.value if is_min else st.acc
    flags = st.frontier if tmpl.mode == "async" else st.next_frontier
    _check(*_spill_checks(uq, sp, spv, recv, rv, T, 2),
           ("target", target, torch.float32, (T, v_chunk)),
           ("flags", flags, torch.bool, (T, v_chunk)))
    counts = torch.empty((4, T), dtype=torch.int32, device=uq.data.device)
    # queue count, drops, applied, nspill
    out = torch.empty_like(target)
    new_flags = torch.empty_like(flags) if is_min else flags
    _launch("repro_fused_leg2", uq.data, uq.count, sp, spv, recv, rv,
            target, flags, counts[0], out, new_flags, counts[1], counts[2],
            counts[3], T, cap_u, S, R, v_chunk,
            *device_split(T, v_chunk, uq.data.device),
            _code(FOLDS, tmpl.fold))
    _count("fused_leg2", None if is_min else add_chunks(R))
    record()
    st = st._replace(queues=(rq, Queue(uq.data, counts[0])))
    if not is_min:
        st = st._replace(acc=out)
    elif tmpl.mode == "async":
        st = st._replace(value=out, frontier=new_flags)
    else:
        st = st._replace(value=out, next_frontier=new_flags)
    return st, counts[1], counts[2], counts[3]


def _flags_field(tmpl: LegTemplate) -> str:
    return "frontier" if tmpl.mode == "async" else "next_frontier"


def fused_kcore_leg2(tmpl: LegTemplate, plain, me, sh, st, recv, rv, sp,
                     spv):
    """Leg 2 of a k-core round: decrement-spill re-queue; the ordered add
    of ``-dec`` into ``value``; ``newly = (acc == 0) & (value' < k)``;
    ``acc`` set to 1 where newly, and newly re-armed in the frontier
    (async) or ``next_frontier`` (BSP); over the grid of
    :func:`fused_leg2`.  Returns ``(state, drops, applied, nspill)``;
    ``value``, ``acc`` and the re-armed flags are new; the spill rows
    append in place onto the update queue it is given, as in
    :func:`fused_leg2`."""
    if _on_cpu(st):
        record()
        return plain(me, sh, st, recv, rv, sp, spv)
    recv, rv, sp, spv = (x.contiguous() for x in (recv, rv, sp, spv))
    rq, uq = st.queues
    T, cap_u, _ = uq.data.shape
    v_chunk = st.value.shape[1]
    S, R = sp.shape[1], recv.shape[1]
    flags = getattr(st, _flags_field(tmpl))
    _check(*_spill_checks(uq, sp, spv, recv, rv, T, 2),
           ("value", st.value, torch.float32, (T, v_chunk)),
           ("acc", st.acc, torch.float32, (T, v_chunk)),
           ("flags", flags, torch.bool, (T, v_chunk)))
    counts = torch.empty((4, T), dtype=torch.int32, device=uq.data.device)
    # queue count, drops, applied, nspill
    value, acc = torch.empty_like(st.value), torch.empty_like(st.acc)
    new_flags = torch.empty_like(flags)
    _launch("repro_fused_kcore_leg2", uq.data, uq.count, sp, spv, recv, rv,
            st.value, flags, st.acc, counts[0], value, new_flags, acc,
            counts[1], counts[2], counts[3], T, cap_u, S, R, v_chunk,
            *device_split(T, v_chunk, uq.data.device), tmpl.k)
    _count("fused_kcore_leg2", add_chunks(R))
    record()
    st = st._replace(queues=(rq, Queue(uq.data, counts[0])), value=value,
                     acc=acc, **{_flags_field(tmpl): new_flags})
    return st, counts[1], counts[2], counts[3]


def fused_tri_leg2(tmpl: LegTemplate, plain, me, sh, st, recv, rv, sp, spv,
                   dyn_pops):
    """Leg 2 of a triangles round: wedge-spill re-queue (in place, onto the
    wedge queue leg 1 made); at u's owner the second-hop tasks ``(start,
    start + deg, v, u)`` of the delivered wedges ``(u, v)``, valid where
    ``deg > 0``; the range2-queue turn with them (the new queue holds its
    live rows only); T1 range split; remainder re-push; over a grid (T, G
    + 2) (:func:`wedge_split`).  Returns ``(state, msgs (T, r_pop, 4),
    mvalid, drops, work (0), npop, npush, nspill)``; queue 2 is new, queue
    1 the one it was given, with the spills appended."""
    if _on_cpu(st):
        record()
        return plain(me, sh, st, recv, rv, sp, spv, dyn_pops)
    recv, rv, sp, spv = (x.contiguous() for x in (recv, rv, sp, spv))
    wq, rq = st.queues[1], st.queues[2]
    T, cap_w, _ = wq.data.shape
    cap_r = rq.data.shape[1]
    v_chunk = sh.deg.shape[1]
    S, R = sp.shape[1], recv.shape[1]
    K = len(st.queues)
    _check(*_spill_checks(wq, sp, spv, recv, rv, T, 2),
           ("ptr_start", sh.ptr_start, torch.int32, (T, v_chunk)),
           ("deg", sh.deg, torch.int32, (T, v_chunk)),
           ("range2 queue", rq.data, torch.int32, (T, cap_r, 4)),
           ("range2 count", rq.count, torch.int32, (T,)),
           ("dyn_pops", dyn_pops, torch.int32, (T, K)))
    r_pop = tmpl.pops[2]
    eff = min(r_pop, cap_r)
    dev = rq.data.device
    i32 = dict(dtype=torch.int32, device=dev)
    nbytes = wedge_stage_bytes(eff)
    path, scratch = staging(T, nbytes, dev)
    rdata = torch.empty_like(rq.data)
    # queue counts (wedge, range2), drops, work, npop, npush, nspill
    counts = torch.empty((7, T), **i32)
    msgs = torch.empty((T, eff, 4), **i32)
    mvalid = torch.empty((T, eff), dtype=torch.bool, device=dev)
    _launch("repro_fused_wedge_leg", wq.data, wq.count, sp, spv, recv, rv,
            sh.ptr_start, sh.deg, rq.data, rq.count, dyn_pops, counts[0],
            rdata, counts[1], msgs, mvalid, counts[2], counts[3], counts[4],
            counts[5], counts[6], scratch, T, cap_w, S, R, v_chunk,
            sh.edge_dst.shape[1], cap_r, r_pop, tmpl.max_t2, K, 2,
            wedge_split(T, R, dev).G, nbytes)
    _count("fused_tri_leg2", path)
    record()
    st = _with_queues(st, 1, Queue(wq.data, counts[0]),
                      Queue(rdata, counts[1]))
    return (st, msgs, mvalid, counts[2], counts[3], counts[4], counts[5],
            counts[6])


# the close leg's one path: its hits folded by slot counts, at any R
CLOSE_PATH = "slot counts"


def search_steps(e_chunk: int) -> int:
    """The close fold's binary-search steps: ``max(1, bit_length(e_chunk))``
    (program.py ``_segment_contains``)."""
    return max(1, int(e_chunk).bit_length())


def fused_tri_leg4(tmpl: LegTemplate, plain, me, sh, st, recv, rv, sp, spv):
    """Leg 4 of a triangles round: close-spill re-queue (in place, onto the
    close queue leg 3 made); for each delivered ``(v, w)`` whether the
    closing edge is in v's sorted local segment; the hits added into
    ``acc`` at v's slot, as the plain stage's ordered add, by counts of
    each slot's valid rows and hits (no sort: its addends are 0.0 and 1.0,
    whose adds commute); over a grid (T, G + 1) (:func:`close_split`).
    Returns ``(state, drops, found, nspill)``; ``acc`` is new, queue 3 the
    one it was given, with the spills appended."""
    if _on_cpu(st):
        record()
        return plain(me, sh, st, recv, rv, sp, spv)
    recv, rv, sp, spv = (x.contiguous() for x in (recv, rv, sp, spv))
    cq = st.queues[3]
    T, cap_c, _ = cq.data.shape
    v_chunk = st.acc.shape[1]
    e_chunk = sh.edge_dst.shape[1]
    S, R = sp.shape[1], recv.shape[1]
    _check(*_spill_checks(cq, sp, spv, recv, rv, T, 2),
           ("ptr_start", sh.ptr_start, torch.int32, (T, v_chunk)),
           ("deg", sh.deg, torch.int32, (T, v_chunk)),
           ("edge_dst", sh.edge_dst, torch.int32, (T, e_chunk)),
           ("acc", st.acc, torch.float32, (T, v_chunk)))
    dev = cq.data.device
    acc = torch.empty_like(st.acc)
    # each slot's counts (two words), the G blocks' found sums and tickets
    # (the launch clears these), then the queue count, drops, found and
    # nspill
    scratch = torch.empty(2 * T * (v_chunk + 3), dtype=torch.int32,
                          device=dev)
    counts = scratch[2 * T * (v_chunk + 1):].view(4, T)
    _launch("repro_fused_close_leg", cq.data, cq.count, sp, spv, recv, rv,
            sh.ptr_start, sh.deg, sh.edge_dst, st.acc, counts[0], acc,
            counts[1], counts[2], counts[3], scratch, T, cap_c, S, R,
            v_chunk, e_chunk, search_steps(e_chunk),
            close_split(T, R, dev).G)
    _count("fused_tri_leg4", CLOSE_PATH)
    record()
    st = _with_queues(st._replace(acc=acc), 3, Queue(cq.data, counts[0]))
    return st, counts[1], counts[2], counts[3]


KERNELS = (fused_leg0, fused_leg1, fused_leg2, fused_kcore_leg2,
           fused_tri_leg0, fused_tri_leg1, fused_tri_leg2, fused_tri_leg3,
           fused_tri_leg4)
for _k in KERNELS:
    _k.launches = 0
    _k.path = None
_WRAPPERS = {k.__name__: k for k in KERNELS}

# Each fused leg's queue that it appends its spills onto in place (the one
# the previous leg of the round made), and the queue it turns keeping its
# live rows only (its popped message rows past the pop: 0).
IN_PLACE = {"fused_leg1": 0, "fused_leg2": 1, "fused_kcore_leg2": 1,
            "fused_tri_leg1": 0, "fused_tri_leg2": 1, "fused_tri_leg3": 2,
            "fused_tri_leg4": 3}
LIVE_TURN = {"fused_leg0": 0, "fused_tri_leg0": 0, "fused_leg1": 1,
             "fused_tri_leg1": 1, "fused_tri_leg2": 2, "fused_tri_leg3": 3}
STATE_SLICES = ("value", "acc", "frontier", "next_frontier", "net_pressure")


def popped_rows(name: str, tmpl: LegTemplate, st) -> int:
    """The message rows that the pop of a LIVE_TURN leg's queue fills (of
    its state operand ``st``): min(pop budget, capacity)."""
    i = LIVE_TURN[name]
    return min(tmpl.pops[i], st.queues[i].data.shape[1])


def contract(name: str, tmpl: LegTemplate, st, out):
    """The outputs ``out`` of fused leg ``name`` on state operand ``st``,
    split by the kernels' contract: ``(defined, popped_past)``.
    ``defined`` lists the elements that the kernel and the plain stage
    share bit for bit: the state's slices, each queue's count and its rows
    below the count, the message flags, the message rows that are valid or
    lie past the pop's, and every other output.  ``popped_past`` holds the
    popped message rows past the pop (invalid): 0 in the kernel's, stale
    queue rows in the plain stage's."""
    new = out[0]
    defined = [getattr(new, f) for f in STATE_SLICES]
    for q in new.queues:
        live = torch.arange(q.data.shape[1], device=q.count.device)[None] \
            < q.count[:, None]
        defined += [q.count, q.data[live]]
    rest = list(out[1:])
    popped_past = new.net_pressure[:0]
    if name in LIVE_TURN:
        msgs, mvalid = rest[:2]
        head = torch.arange(msgs.shape[1], device=mvalid.device)[None] \
            < popped_rows(name, tmpl, st)
        keep = mvalid | ~head
        defined += [mvalid, msgs[keep]]
        popped_past = msgs[~keep]
        rest = rest[2:]
    return defined + rest, popped_past


# each program family's wrappers, leg by leg (Program.fused.family)
LEGS = {
    "classic": ("fused_leg0", "fused_leg1", "fused_leg2"),
    "kcore": ("fused_leg0", "fused_leg1", "fused_kcore_leg2"),
    "triangles": tuple(f"fused_tri_leg{i}" for i in range(5)),
}
