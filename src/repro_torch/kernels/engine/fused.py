"""Fused engine legs: one Hopper kernel launch per channel leg of the
classic program (port of ``repro.kernels.engine.kernel.fused_leg_call``).

The reference's ``fused_leg_call(fn, *operands)`` makes the per-tile
stage ``fn`` itself the body of one ``pallas_call``.  Here each of the
classic program's three legs is a hand-written CUDA kernel
(``csrc/fused_legs.cu``), one block per tile, templated on the
:class:`LegTemplate`:

=====================  ==================================================
wrapper                one launch computes, per tile
=====================  ==================================================
:func:`fused_leg0`     TSU budgets, T4 frontier pop and payload, range-queue
                       turn, T1 range split, remainder re-push
:func:`fused_leg1`     range-spill re-queue, T2 scan (resident gather or
                       streamed windows), update-queue replay turn,
                       replay + fresh rows into the messages
:func:`fused_leg2`     update-spill re-queue, T3 min fold + frontier
                       re-arm (async or BSP) or ordered add fold
=====================  ==================================================

Each wrapper takes the stage's own arguments and returns what the stage
returns.  Its plain version is the stage itself, ``plain``, built by the
engine under ``Ctx.fused``: the same composition of the plain bodies of
:mod:`repro_torch.kernels.engine.kernel` (``frontier_take``,
``fifo_turn``, ``queue_push``, ``segment_gather``/``segment_stream``,
``scatter_body``), as the reference's fused body composes its pure
bodies.  On CPU tensors a wrapper runs ``plain``; on CUDA tensors it
launches its kernel and raises if the launch failed, with no fallback.
Each call is one :func:`~repro_torch.kernels.engine.launches.record`, so
the classic round counts 3 launches, as the reference's fused round.

The kernels write every output element as the plain stage does,
including the don't-care slots (the whole shifted queues, the messages of
invalid rows), so the two are compared element for element.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.queues import Queue
from repro_torch.kernels.cuda_build import I as _I, P as _P
from repro_torch.kernels.cuda_build import CudaLibrary, check as _check
from repro_torch.kernels.engine.kernel import (CSRC, ENGINE_DEVICE,
                                               FOLD_ADD_MAX_ROWS,
                                               ORDERED_SCATTER,
                                               STREAM_MAX_WINDOW)
from repro_torch.kernels.engine.launches import record

SOURCE = CSRC / "fused_legs.cu"
LIBRARY = CudaLibrary(SOURCE, {
    "repro_fused_leg0": [_P] * 17 + [_I] * 12 + [_P],
    "repro_fused_leg1": [_P] * 22 + [_I] * 10 + [_P],
    "repro_fused_leg2": [_P] * 15 + [_I] * 6 + [_P],
}, headers=(ENGINE_DEVICE, ORDERED_SCATTER))
_launch = LIBRARY.launch

# template codes shared with csrc/fused_legs.cu; the mode picks the flags
# leg 2 re-arms (frontier or next_frontier), so it is no template there
PAYLOADS = ("value", "value_over_deg")
EMITS = ("plus1", "plus_w", "copy", "times_w")
FOLDS = ("min", "add")
POLICIES = ("traffic", "static")
# leg 0 keeps its popped frontier tasks and range rows in shared memory
LEG0_MAX_ROWS = 256


class LegTemplate(NamedTuple):
    """The static shape of a classic round's legs: the AlgSpec (payload,
    emit, fold), the run's mode and TSU policy, the edge shard's window
    (0: resident), and the budgets of the TSU."""

    payload: str
    emit: str
    fold: str
    mode: str
    policy: str
    window: int
    f_pop: int
    r_pop: int
    u_pop: int
    max_t2: int
    plimit: int


def _code(options, value):
    if value not in options:
        raise ValueError(f"{value!r} not in {options}")
    return options.index(value)


def fused_leg0(tmpl: LegTemplate, plain, me, sh, st):
    """Leg 0 of a classic round (the engine's ``stage_first``).  Returns
    ``(state, msgs (T, r_pop, 3), mvalid, drops, dyn_pops (T, 2), npop,
    npush)``; the state's frontier and range queue are new."""
    if st.frontier.device.type == "cpu":
        record()
        return plain(me, sh, st)
    rq, uq = st.queues
    T, v_chunk = st.frontier.shape
    cap_r = rq.data.shape[1]
    eff = min(tmpl.r_pop, cap_r)
    e_chunk = sh.edge_dst.shape[1]
    _check(("frontier", st.frontier, torch.bool, (T, v_chunk)),
           ("value", st.value, torch.float32, (T, v_chunk)),
           ("deg", sh.deg, torch.int32, (T, v_chunk)),
           ("ptr_start", sh.ptr_start, torch.int32, (T, v_chunk)),
           ("range queue", rq.data, torch.int32, (T, cap_r, 3)),
           ("range count", rq.count, torch.int32, (T,)),
           ("update count", uq.count, torch.int32, (T,)),
           ("net_pressure", st.net_pressure, torch.int32, (T,)))
    if tmpl.f_pop > LEG0_MAX_ROWS or eff > LEG0_MAX_ROWS:
        raise ValueError(f"fused_leg0 holds at most {LEG0_MAX_ROWS} "
                         f"popped rows; got f_pop={tmpl.f_pop}, r_pop="
                         f"{tmpl.r_pop}")
    dev = st.frontier.device
    i32 = dict(dtype=torch.int32, device=dev)
    frontier = torch.empty_like(st.frontier)
    qdata = torch.empty_like(rq.data)
    qcount = torch.empty_like(rq.count)
    msgs = torch.empty((T, eff, 3), **i32)
    mvalid = torch.empty((T, eff), dtype=torch.bool, device=dev)
    counts = torch.empty((3, T), **i32)  # drops, npop, npush
    dyn_pops = torch.empty((T, 2), **i32)
    _launch("repro_fused_leg0", st.frontier, st.value, sh.deg, sh.ptr_start,
            rq.data, rq.count, uq.count, st.net_pressure, frontier, qdata,
            qcount, msgs, mvalid, counts[0], dyn_pops, counts[1], counts[2],
            T, v_chunk, e_chunk, cap_r, uq.data.shape[1], tmpl.f_pop,
            tmpl.r_pop, tmpl.u_pop, tmpl.max_t2, tmpl.plimit,
            _code(PAYLOADS, tmpl.payload), _code(POLICIES, tmpl.policy))
    fused_leg0.launches += 1
    record()
    st = st._replace(frontier=frontier, queues=(Queue(qdata, qcount), uq))
    return st, msgs, mvalid, counts[0], dyn_pops, counts[1], counts[2]


def fused_leg1(tmpl: LegTemplate, plain, me, sh, st, recv, rv, sp, spv,
               dyn_pops):
    """Leg 1 of a classic round (the engine's mid stage): range-spill
    re-queue, T2, update-queue replay.  Returns ``(state, msgs (T, u_pop +
    R * max_t2, 2), mvalid, drops, edges, npop, npush, nspill)``; both
    queues of the state are new."""
    if st.frontier.device.type == "cpu":
        record()
        return plain(me, sh, st, recv, rv, sp, spv, dyn_pops)
    recv, rv, sp, spv = (x.contiguous() for x in (recv, rv, sp, spv))
    rq, uq = st.queues
    T, cap_r, _ = rq.data.shape
    cap_u = uq.data.shape[1]
    e_chunk = sh.edge_dst.shape[1]
    S, R = sp.shape[1], recv.shape[1]
    _check(("range queue", rq.data, torch.int32, (T, cap_r, 3)),
           ("range count", rq.count, torch.int32, (T,)),
           ("spill", sp, torch.int32, (T, S, 3)),
           ("spill_valid", spv, torch.bool, (T, S)),
           ("recv", recv, torch.int32, (T, R, 3)),
           ("recv_valid", rv, torch.bool, (T, R)),
           ("edge_dst", sh.edge_dst, torch.int32, (T, e_chunk)),
           ("edge_val", sh.edge_val, torch.float32, (T, e_chunk)),
           ("update queue", uq.data, torch.int32, (T, cap_u, 2)),
           ("update count", uq.count, torch.int32, (T,)),
           ("dyn_pops", dyn_pops, torch.int32, (T, 2)))
    if tmpl.window and not tmpl.max_t2 <= tmpl.window <= STREAM_MAX_WINDOW:
        raise ValueError(f"fused_leg1: window {tmpl.window} must lie in "
                         f"[max_t2={tmpl.max_t2}, {STREAM_MAX_WINDOW}]")
    eff = min(tmpl.u_pop, cap_u)
    n_msgs = eff + R * tmpl.max_t2
    dev = rq.data.device
    i32 = dict(dtype=torch.int32, device=dev)
    rdata, udata = torch.empty_like(rq.data), torch.empty_like(uq.data)
    # queue counts (range, update), drops, edges, npop, npush, nspill
    counts = torch.empty((7, T), **i32)
    msgs = torch.empty((T, n_msgs, 2), **i32)
    mvalid = torch.empty((T, n_msgs), dtype=torch.bool, device=dev)
    _launch("repro_fused_leg1", rq.data, rq.count, sp, spv, recv, rv,
            sh.edge_dst, sh.edge_val, uq.data, uq.count, dyn_pops, rdata,
            counts[0], udata, counts[1], msgs, mvalid, counts[2], counts[3],
            counts[4], counts[5], counts[6],
            T, cap_r, S, R, e_chunk, tmpl.max_t2, tmpl.window, cap_u,
            tmpl.u_pop, _code(EMITS, tmpl.emit))
    fused_leg1.launches += 1
    record()
    st = st._replace(queues=(Queue(rdata, counts[0]),
                             Queue(udata, counts[1])))
    return (st, msgs, mvalid, counts[2], counts[3], counts[4], counts[5],
            counts[6])


def fused_leg2(tmpl: LegTemplate, plain, me, sh, st, recv, rv, sp, spv):
    """Leg 2 of a classic round (the engine's ``stage_last``):
    update-spill re-queue, then the T3 fold.  Returns ``(state, drops,
    applied, nspill)``; the state's update queue is new, and so are
    ``value`` and the re-armed frontier (min fold; ``next_frontier`` in
    BSP mode) or ``acc`` (add fold)."""
    if st.frontier.device.type == "cpu":
        record()
        return plain(me, sh, st, recv, rv, sp, spv)
    recv, rv, sp, spv = (x.contiguous() for x in (recv, rv, sp, spv))
    rq, uq = st.queues
    T, cap_u, _ = uq.data.shape
    v_chunk = st.value.shape[1]
    S, R = sp.shape[1], recv.shape[1]
    is_min = tmpl.fold == "min"
    target = st.value if is_min else st.acc
    flags = st.frontier if tmpl.mode == "async" else st.next_frontier
    _check(("update queue", uq.data, torch.int32, (T, cap_u, 2)),
           ("update count", uq.count, torch.int32, (T,)),
           ("spill", sp, torch.int32, (T, S, 2)),
           ("spill_valid", spv, torch.bool, (T, S)),
           ("recv", recv, torch.int32, (T, R, 2)),
           ("recv_valid", rv, torch.bool, (T, R)),
           ("target", target, torch.float32, (T, v_chunk)),
           ("flags", flags, torch.bool, (T, v_chunk)))
    if not is_min and R > FOLD_ADD_MAX_ROWS:
        raise ValueError(f"fused_leg2 (add fold) sorts at most "
                         f"{FOLD_ADD_MAX_ROWS} rows per tile in shared "
                         f"memory; got {R}")
    dev = uq.data.device
    udata = torch.empty_like(uq.data)
    counts = torch.empty((4, T), dtype=torch.int32, device=dev)
    # queue count, drops, applied, nspill
    out = torch.empty_like(target)
    new_flags = torch.empty_like(flags) if is_min else flags
    _launch("repro_fused_leg2", uq.data, uq.count, sp, spv, recv, rv,
            target, flags, udata, counts[0], out, new_flags, counts[1],
            counts[2], counts[3], T, cap_u, S, R, v_chunk,
            _code(FOLDS, tmpl.fold))
    fused_leg2.launches += 1
    record()
    st = st._replace(queues=(rq, Queue(udata, counts[0])))
    if not is_min:
        st = st._replace(acc=out)
    elif tmpl.mode == "async":
        st = st._replace(value=out, frontier=new_flags)
    else:
        st = st._replace(value=out, next_frontier=new_flags)
    return st, counts[1], counts[2], counts[3]


KERNELS = (fused_leg0, fused_leg1, fused_leg2)
for _k in KERNELS:
    _k.launches = 0
