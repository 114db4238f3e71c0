"""Hopper kernels of the engine round, their plain PyTorch versions, and the
build loader (port of ``repro.kernels.engine.kernel``'s standalone
kernels; the fused legs are :mod:`repro_torch.kernels.engine.fused`).

Six wrappers replace the five standalone TPU kernels the reference's
``backend="pallas", pallas_fuse=False`` round launches (5 launches per
round: ``queue_push_pop`` once per channel; T2 gathers a resident shard
or streams an HBM-declared one; the fold is min or add):

=====================  ===============================================
wrapper                TPU kernel it replaces (src/repro/kernels/...)
=====================  ===============================================
:func:`frontier_pop`      ``engine/kernel.py:371`` (body ``frontier_take``)
:func:`queue_push_pop`    ``engine/kernel.py:417`` (``fifo_turn`` +
                          ``queue_append``)
:func:`edge_scan_gather`  ``engine/kernel.py:473`` (``segment_gather``)
:func:`edge_scan_stream`  ``engine/kernel.py:519`` (``segment_stream``)
:func:`fold_scatter`      ``engine/kernel.py:557`` (``scatter_body``,
                          ``op="min"``)
:func:`fold_scatter_add`  ``engine/kernel.py:557`` (``op="add"``)
=====================  ===============================================

Each wrapper takes tile-batched ``(T, ...)`` tensors.  On CPU tensors it
runs its plain version (:func:`frontier_take`, :func:`fifo_turn`,
:func:`segment_gather`, :func:`segment_stream`, :func:`scatter_body` —
batched ports of the reference's pure bodies, which the fused legs
compose too).  On CUDA tensors it checks dtype, shape and contiguity,
allocates its outputs, launches its CUDA kernel (``csrc/engine_kernels.cu``
over the device functions of ``csrc/engine_device.cuh``; what bounds it
and how is written beside each kernel there) on the current stream and
raises if the launch failed; there is no fallback.  Every call is counted
for ``Stats.launches`` through
:func:`repro_torch.kernels.engine.launches.record`; the wrapper's own
``launches`` attribute counts real CUDA launches only.

The add fold keeps the reference's serial order per slot on every
device: the kernel's column-owning blocks add a slot's only row at once
and sort the others by slot (in row-order chunks of ``FOLD_ADD_MAX_ROWS``
rows past what shared memory holds), and the plain
version adds one occurrence rank per pass (:func:`ordered_scatter_add`),
so no float atomics decide an order.

No wrapper refuses a shape for its kernel's shared memory: where the
staging does not fit, the kernel takes a second path that gives the same
bits (the add folds sort in chunks; ``queue_push_pop`` and the fused legs
stage in a device-memory scratch past ``STAGE_SMEM_MAX`` bytes; a
streamed window wider than ``STREAM_MAX_WINDOW`` is read from device
memory, not staged).  Each such wrapper notes the path of its last launch
in its ``path`` attribute.

The CUDA source is built at first use (:mod:`repro_torch.kernels.
cuda_build`: ``nvcc`` for ``sm_90a`` into ``build/repro_torch/``, loaded
with ``ctypes``).  A failed build raises with nvcc's output.
"""
from __future__ import annotations

import functools
import re
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.queues import Queue, occurrence_index, queue_push
from repro_torch.kernels.cuda_build import I as _I, P as _P
from repro_torch.kernels.cuda_build import CudaLibrary, check as _check
from repro_torch.kernels.engine.launches import record

# float32 max: the "unreached" sentinel and the min fold's neutral element
_INF = float(np.finfo(np.float32).max)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "engine_kernels.cu"
ENGINE_DEVICE = CSRC / "engine_device.cuh"
ORDERED_SCATTER = CSRC / "ordered_scatter.cuh"



def _constant(header: Path, name: str) -> int:
    """The value of ``constexpr <type> name = <integer>;`` in ``header``."""
    m = re.search(rf"constexpr \w+ {name} = (\d+);", header.read_text())
    if m is None:
        raise ValueError(f"{name} is not defined in {header}")
    return int(m.group(1))


# The thresholds between each kernel's two paths, compiled into the kernels
# and read here from their headers.  The add folds sort one 8-byte key and
# one value a row in shared memory, at most FOLD_ADD_MAX_ROWS rows at a
# time: more rows a tile are sorted and added chunk after chunk, in row
# order (csrc/ordered_scatter.cuh).  A streamed T2 stages a warp's 2 *
# window (dst, val) pairs in shared memory up to STREAM_MAX_WINDOW; a wider
# window is read from device memory.  queue_push_pop's fresh-row indices
# and the fused legs' popped rows take at most STAGE_SMEM_MAX bytes of
# dynamic shared memory a block; a larger staging goes to a device-memory
# scratch the wrapper allocates (csrc/engine_device.cuh).
FOLD_ADD_MAX_ROWS = _constant(ORDERED_SCATTER, "FOLD_ADD_MAX_ROWS")
STREAM_MAX_WINDOW = _constant(ENGINE_DEVICE, "STREAM_MAX_WINDOW")
STAGE_SMEM_MAX = _constant(ENGINE_DEVICE, "STAGE_SMEM_MAX")
# The column-owning split of the T3 folds over a grid (NB, G) (the
# scatter_segments kernel and the fused leg 2): G aims at SPLIT_BLOCKS_PER_SM
# blocks on each SM, with at most one block per SPLIT_MIN_COLS slots, and
# every inner boundary a multiple of SPLIT_QUANTUM slots (a 16-byte vector).
SPLIT_BLOCKS_PER_SM, SPLIT_MIN_COLS, SPLIT_QUANTUM = 2, 512, 4


class Split(NamedTuple):
    """G column ranges of ``step`` slots: block ``j`` owns the slots
    ``[j * step, min((j + 1) * step, b))`` of its bin."""

    G: int
    step: int

    def bounds(self, b: int) -> list:
        """The G + 1 boundaries of the ranges over ``b`` slots."""
        return [min(j * self.step, b) for j in range(self.G)] + [b]


def column_split(nb: int, b: int, sms: int) -> Split:
    """The split of ``nb`` bins of ``b`` slots each over ``sms`` SMs: G
    ranges a bin, as many as give every SM SPLIT_BLOCKS_PER_SM blocks
    but at most one per SPLIT_MIN_COLS slots, of equal width rounded up
    to SPLIT_QUANTUM (the last takes the remainder), none empty."""
    want = -(-SPLIT_BLOCKS_PER_SM * sms // max(nb, 1))
    G = max(1, min(want, -(-b // SPLIT_MIN_COLS)))
    step = SPLIT_QUANTUM * max(1, -(-b // (SPLIT_QUANTUM * G)))
    return Split(max(1, -(-b // step)), step)


@functools.lru_cache(maxsize=None)
def device_split(nb: int, b: int, dev) -> Split:
    """:func:`column_split` over the SMs of CUDA device ``dev`` (kept per
    shape: the legs' wrappers ask for it every call)."""
    return column_split(nb, b, _sm_count(torch.device(dev).index or 0))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


LIBRARY = CudaLibrary(SOURCE, {
    "repro_frontier_pop": [_P] * 5 + [_I] * 3 + [_P],
    "repro_queue_push_pop": [_P] * 11 + [_I] * 6 + [_P],
    "repro_edge_scan_gather": [_P] * 8 + [_I] * 4 + [_P],
    "repro_edge_scan_stream": [_P] * 8 + [_I] * 5 + [_P],
    "repro_fold_scatter_min": [_P] * 5 + [_I] * 3 + [_P],
    "repro_fold_scatter_add": [_P] * 5 + [_I] * 5 + [_P],
}, headers=(ENGINE_DEVICE, ORDERED_SCATTER))
_launch = LIBRARY.launch


def add_chunks(R: int) -> str:
    """The path of an ordered add of ``R`` rows a tile: how many row-order
    chunks of ``FOLD_ADD_MAX_ROWS`` it sorts."""
    n = max(1, -(-R // FOLD_ADD_MAX_ROWS))
    return "one chunk" if n == 1 else f"{n} chunks"


def staging(T: int, nbytes: int, dev):
    """Where a kernel stages ``nbytes`` a tile: ``(path, scratch)``, in
    dynamic shared memory up to ``STAGE_SMEM_MAX`` bytes (``scratch`` then
    None, a null pointer), else in a device-memory scratch of ``nbytes`` a
    tile."""
    if nbytes <= STAGE_SMEM_MAX:
        return "shared memory", None
    return ("device scratch",
            torch.empty((T, nbytes), dtype=torch.uint8, device=dev))


def window_path(window: int) -> str:
    """How a streamed T2 reads its windows: staged in shared memory up to
    ``STREAM_MAX_WINDOW``, else from device memory."""
    return ("staged window" if window <= STREAM_MAX_WINDOW
            else "device window")


# ==========================================================================
# Plain versions: batched ports of the reference's pure bodies.
# ==========================================================================

def frontier_take(mask: torch.Tensor, k: torch.Tensor, k_max: int):
    """The first ``min(k, popcount)`` set bits of each tile's bitmap, in
    position order, compacted with a cumsum-rank scatter (no sort).

    mask (T, n) bool, k (T,) int32 -> (idx (T, k_max) int32 with 0 in the
    invalid slots, valid (T, k_max) bool, cleared mask (T, n) bool).
    """
    T, n = mask.shape
    dev = mask.device
    ar = torch.arange(n, dtype=torch.int32, device=dev).expand(T, n)
    mi = mask.to(torch.int32)
    rank = torch.cumsum(mi, dim=1, dtype=torch.int32) - mi
    take = mask & (rank < k[:, None])
    # slot k_max is the trash slot; ranks past it are dropped, as the
    # reference's out-of-range scatter drops them
    slot = torch.where(take & (rank <= k_max), rank, k_max).to(torch.int64)
    idx = torch.zeros((T, k_max + 1), dtype=torch.int32, device=dev)
    idx.scatter_(1, slot, ar)
    n_take = take.sum(dim=1, dtype=torch.int32)
    valid = torch.arange(k_max, dtype=torch.int32, device=dev)[None] \
        < n_take[:, None]
    return idx[:, :k_max].contiguous(), valid, mask & ~take


def fifo_turn(data, count, rows, valid, n, max_n: int):
    """One circular-FIFO turn per tile: append the valid rows at the tail
    (overflow -> drops), then pop ``min(n, count')`` rows off the front
    with one shift of the whole buffer, stale rows included.

    Returns (taken (T, min(max_n, cap), w), taken_valid, new_data
    (T, cap, w), new_count (T,), drops (T,)).  A cap-0 queue stores
    nothing: the pop is empty and every offered row is a drop.
    """
    T, cap, w = data.shape
    dev = data.device
    if cap == 0:
        return (data.new_zeros((T, 0, w)),
                torch.zeros((T, 0), dtype=torch.bool, device=dev),
                data, count + 0, valid.sum(dim=1, dtype=torch.int32))
    # the reference's queue_append body is bit-identical to queue_push
    (data2, count2), drops = queue_push(Queue(data, count), rows, valid)
    eff = min(max_n, cap)
    n_pop = torch.minimum(n, count2)
    ar = torch.arange(cap, dtype=torch.int32, device=dev)[None]
    taken = data2[:, :eff].contiguous()
    tvalid = ar[:, :eff] < n_pop[:, None]
    src = torch.clamp(ar + n_pop[:, None], max=cap - 1).to(torch.int64)
    shifted = torch.gather(data2, 1, src[:, :, None].expand(-1, -1, w))
    return taken, tvalid, shifted, count2 - n_pop, drops


def segment_gather(edge_dst, edge_val, start, stop, rv, max_t2: int):
    """The T2 ragged segment gather out of each tile's edge shard.

    edge_dst/edge_val (T, e_chunk), start/stop/rv (T, R) -> nb, w, jvalid,
    each (T, R, max_t2).  Every lane reads the clamped index, valid or not.
    """
    T, e_chunk = edge_dst.shape
    R = start.shape[1]
    length = torch.where(rv, stop - start, 0)
    local0 = torch.where(rv, start % e_chunk, 0)
    j = torch.arange(max_t2, dtype=torch.int32, device=start.device)
    eidx = local0[:, :, None] + j                  # (T, R, MAX_T2)
    jvalid = rv[:, :, None] & (j < length[:, :, None])
    eidx_c = torch.clamp(eidx, max=e_chunk - 1).reshape(T, -1) \
        .to(torch.int64)
    nb = torch.gather(edge_dst, 1, eidx_c).reshape(T, R, max_t2)
    w = torch.gather(edge_val, 1, eidx_c).reshape(T, R, max_t2)
    return nb, w, jvalid & (nb >= 0)


def segment_stream(edge_dst, edge_val, start, stop, rv, max_t2: int,
                   window: int):
    """T2 over a streamed (HBM-declared) edge shard: each message stages
    the two aligned ``window``-sized windows that cover it, ``[base, base
    + 2 * window)`` with ``base = (start % e_chunk) // window * window``
    (indices clamped to the shard), and gathers its lanes out of that
    staging buffer only (offsets clamped to it).

    Same operands and outputs as :func:`segment_gather`.  With ``window >=
    max_t2`` every valid lane reads the same shard word as the gather; the
    invalid lanes read the staging buffer, so they differ from it.
    """
    T, e_chunk = edge_dst.shape
    R = start.shape[1]
    dev = start.device
    length = torch.where(rv, stop - start, 0)
    local0 = torch.where(rv, start % e_chunk, 0)
    base = torch.div(local0, window, rounding_mode="floor") * window
    k = torch.arange(2 * window, dtype=torch.int32, device=dev)
    sidx = torch.clamp(base[:, :, None] + k, max=e_chunk - 1) \
        .reshape(T, -1).to(torch.int64)
    stage_dst = torch.gather(edge_dst, 1, sidx).reshape(T, R, 2 * window)
    stage_val = torch.gather(edge_val, 1, sidx).reshape(T, R, 2 * window)
    j = torch.arange(max_t2, dtype=torch.int32, device=dev)
    jvalid = rv[:, :, None] & (j < length[:, :, None])
    off = torch.clamp((local0 - base)[:, :, None] + j, max=2 * window - 1) \
        .to(torch.int64)
    nb = torch.gather(stage_dst, 2, off)
    w = torch.gather(stage_val, 2, off)
    return nb, w, jvalid & (nb >= 0)


def ordered_scatter_add(target: torch.Tensor, idx: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    """``target[t, idx[t, r]] += vals[t, r]`` for every row whose ``idx``
    lies in ``[0, n)`` (the others are skipped, as the kernel skips them),
    each slot's rows added in increasing ``r`` on any device: the serial
    order of XLA's scatter.  target (T, n) f32, idx (T, R), vals (T, R).

    Pass ``k`` adds every row that is the k-th of its slot (its rank from
    :func:`occurrence_index`).  Within one pass no two rows share a slot,
    so each pass reads its slots, adds and writes them back, and the
    passes together are the serial sum.  No float atomic adds (CUDA's
    flush subnormal inputs and results to zero; the kernels' adds do
    not).  The rows of other passes go to a spare column, which is
    dropped.
    """
    T, n = target.shape
    live = (idx >= 0) & (idx < n)
    occ = torch.where(live, occurrence_index(idx, live, n), -1)
    ext = torch.cat([target, target.new_zeros((T, 1))], dim=1)
    for k in range(int(occ.max()) + 1 if occ.numel() else 0):
        hit = occ == k
        at = torch.where(hit, idx, n).to(torch.int64)
        ext.scatter_(1, at, ext.gather(1, at) + torch.where(hit, vals, 0.0))
    return ext[:, :n].contiguous()


def scatter_body(target, lidx, vals, valid, op: str):
    """The T3 owner-local scatter-min / scatter-add of each tile's rows
    into its ``(v_chunk,)`` slice; ``lidx == v_chunk`` is the trash slot
    and invalid rows contribute the neutral element.  The add keeps row
    order per slot (:func:`ordered_scatter_add`), so it is the same on
    every device."""
    T, v_chunk = target.shape
    neutral = _INF if op == "min" else 0.0
    masked = torch.where(valid, vals, neutral)
    if op == "add":
        return ordered_scatter_add(target, lidx, masked)
    ext = torch.cat([target, target.new_full((T, 1), neutral)], dim=1)
    ext.scatter_reduce_(1, lidx.to(torch.int64), masked, "amin")
    return ext[:, :v_chunk].contiguous()


# ==========================================================================
# Wrappers: the plain version on CPU tensors, the CUDA kernel otherwise.
# ==========================================================================

def frontier_pop(mask: torch.Tensor, k: torch.Tensor, k_max: int):
    """T4: pop the first ``min(k, popcount)`` set bits of every tile's
    frontier bitmap.  mask (T, n) bool, k (T,) int32 (<= k_max).  Returns
    (idx (T, k_max) int32, valid (T, k_max) bool, cleared (T, n) bool),
    with 0 in the invalid ``idx`` slots."""
    if mask.device.type == "cpu":
        record()
        return frontier_take(mask, k, k_max)
    T, n = mask.shape
    _check(("mask", mask, torch.bool, (T, n)), ("k", k, torch.int32, (T,)))
    idx = torch.empty((T, k_max), dtype=torch.int32, device=mask.device)
    valid = torch.empty((T, k_max), dtype=torch.bool, device=mask.device)
    rem = torch.empty_like(mask)
    _launch("repro_frontier_pop", mask, k, idx, valid, rem, T, n, k_max)
    frontier_pop.launches += 1
    record()
    return idx, valid, rem


def queue_push_pop(data, count, rows, valid, n, max_n: int):
    """One FIFO turn per tile: ``queue_push(rows[valid])`` then pop
    ``min(n, count')`` in one kernel.  data (T, cap, w) int32, count (T,),
    rows (T, m, w), valid (T, m), n (T,) int32 (<= max_n <= cap).  Returns
    (taken (T, max_n, w), taken_valid, new_data, new_count, drops).  A
    cap-0 queue returns at once, with no launch.

    The kernel runs over a grid (T, G + 1), G from :func:`device_split` of
    the queue's capacity: G blocks a tile move the old live rows, one
    compacts the fresh rows' indices (4 bytes each) in shared memory or,
    past ``STAGE_SMEM_MAX`` bytes, in a device-memory scratch (``path``).
    It writes ``new_data`` below ``new_count`` only: the slots from it on
    are the reference's don't-care ("unobservable garbage",
    ``src/repro/kernels/engine/kernel.py:424-427``), where
    :func:`fifo_turn` keeps the shifted stale rows.  Every other output is
    :func:`fifo_turn`'s, bitwise."""
    T, cap, w = data.shape
    if cap == 0:
        return fifo_turn(data, count, rows, valid, n, max_n)
    if max_n > cap:
        raise ValueError(f"pop budget bound {max_n} > queue capacity {cap}")
    if data.device.type == "cpu":
        record()
        return fifo_turn(data, count, rows, valid, n, max_n)
    m = rows.shape[1]
    _check(("data", data, torch.int32, (T, cap, w)),
           ("count", count, torch.int32, (T,)),
           ("rows", rows, torch.int32, (T, m, w)),
           ("valid", valid, torch.bool, (T, m)),
           ("n", n, torch.int32, (T,)))
    if cap * w >= 2 ** 31:
        raise ValueError(f"queue_push_pop indexes a tile's queue with an "
                         f"int: cap*w < 2**31; got {cap}*{w}")
    dev = data.device
    taken = torch.empty((T, max_n, w), dtype=torch.int32, device=dev)
    tvalid = torch.empty((T, max_n), dtype=torch.bool, device=dev)
    ndata = torch.empty_like(data)
    ncount = torch.empty_like(count)
    drops = torch.empty_like(count)
    path, scratch = staging(T, 4 * m, dev)
    _launch("repro_queue_push_pop", data, count, rows, valid, n, taken,
            tvalid, ndata, ncount, drops, scratch, T,
            device_split(T, cap, dev).G, cap, w, m, max_n)
    queue_push_pop.path = path
    queue_push_pop.launches += 1
    record()
    return taken, tvalid, ndata, ncount, drops


def turn_contract(out):
    """The outputs of a turn that :func:`queue_push_pop`'s kernel and
    :func:`fifo_turn` share bitwise: all five, with ``new_data``'s slots
    from ``new_count`` on set to 0 (the kernel does not write them)."""
    taken, tvalid, ndata, ncount, drops = out
    live = torch.arange(ndata.shape[1], device=ndata.device)[None] \
        < ncount[:, None]
    return (taken, tvalid, torch.where(live[:, :, None], ndata, 0), ncount,
            drops)


def edge_scan_gather(edge_dst, edge_val, start, stop, rv, max_t2: int):
    """T2: for each tile's R delivered range messages, the up-to-``max_t2``
    (dst, val) pairs of its edge shard from ``start % e_chunk``.
    edge_dst (T, e_chunk) int32, edge_val float32, start/stop (T, R)
    int32, rv (T, R) bool -> nb, w, jvalid, each (T, R, max_t2)."""
    if edge_dst.device.type == "cpu":
        record()
        return segment_gather(edge_dst, edge_val, start, stop, rv, max_t2)
    T, e_chunk = edge_dst.shape
    R = start.shape[1]
    _check(("edge_dst", edge_dst, torch.int32, (T, e_chunk)),
           ("edge_val", edge_val, torch.float32, (T, e_chunk)),
           ("start", start, torch.int32, (T, R)),
           ("stop", stop, torch.int32, (T, R)),
           ("rv", rv, torch.bool, (T, R)))
    if -(-R * max_t2 // 256) > 65535:
        raise ValueError(f"edge_scan_gather: R*max_t2={R * max_t2} lanes "
                         f"exceed the grid")
    dev = edge_dst.device
    nb = torch.empty((T, R, max_t2), dtype=torch.int32, device=dev)
    w = torch.empty((T, R, max_t2), dtype=torch.float32, device=dev)
    jvalid = torch.empty((T, R, max_t2), dtype=torch.bool, device=dev)
    _launch("repro_edge_scan_gather", edge_dst, edge_val, start, stop, rv,
            nb, w, jvalid, T, e_chunk, R, max_t2)
    edge_scan_gather.launches += 1
    record()
    return nb, w, jvalid


def edge_scan_stream(edge_dst, edge_val, start, stop, rv, max_t2: int,
                     window: int):
    """T2 over a streamed edge shard (:func:`segment_stream`): the
    operands and outputs of :func:`edge_scan_gather`, plus the static
    ``window`` (``window >= max_t2``, as the reference's
    ``resolve_window`` asks); a window wider than ``STREAM_MAX_WINDOW`` is
    read from device memory instead of staged (``path``)."""
    if window < max(max_t2, 1):
        raise ValueError(f"edge_scan_stream: window {window} must be at "
                         f"least max_t2={max_t2}")
    if edge_dst.device.type == "cpu":
        record()
        return segment_stream(edge_dst, edge_val, start, stop, rv, max_t2,
                              window)
    T, e_chunk = edge_dst.shape
    R = start.shape[1]
    _check(("edge_dst", edge_dst, torch.int32, (T, e_chunk)),
           ("edge_val", edge_val, torch.float32, (T, e_chunk)),
           ("start", start, torch.int32, (T, R)),
           ("stop", stop, torch.int32, (T, R)),
           ("rv", rv, torch.bool, (T, R)))
    dev = edge_dst.device
    nb = torch.empty((T, R, max_t2), dtype=torch.int32, device=dev)
    w = torch.empty((T, R, max_t2), dtype=torch.float32, device=dev)
    jvalid = torch.empty((T, R, max_t2), dtype=torch.bool, device=dev)
    _launch("repro_edge_scan_stream", edge_dst, edge_val, start, stop, rv,
            nb, w, jvalid, T, e_chunk, R, max_t2, window)
    edge_scan_stream.path = window_path(window)
    edge_scan_stream.launches += 1
    record()
    return nb, w, jvalid


def _fold_checked(target, lidx, vals, valid):
    T, v_chunk = target.shape
    R = lidx.shape[1]
    _check(("target", target, torch.float32, (T, v_chunk)),
           ("lidx", lidx, torch.int32, (T, R)),
           ("vals", vals, torch.float32, (T, R)),
           ("valid", valid, torch.bool, (T, R)))
    return T, v_chunk, R


def fold_scatter(target, lidx, vals, valid, op: str = "min"):
    """T3: fold each tile's delivered rows into its ``(v_chunk,)`` slice —
    scatter-min (relaxations), or with ``op="add"`` the scatter-add of
    :func:`fold_scatter_add` (accumulations).  target (T, v_chunk)
    float32, lidx (T, R) int32 with ``v_chunk`` as the trash slot, vals
    (T, R) float32, valid (T, R) bool."""
    if op == "add":
        return fold_scatter_add(target, lidx, vals, valid)
    if op != "min":
        raise ValueError(op)
    if target.device.type == "cpu":
        record()
        return scatter_body(target, lidx, vals, valid, "min")
    T, v_chunk, R = _fold_checked(target, lidx, vals, valid)
    out = torch.empty_like(target)
    _launch("repro_fold_scatter_min", target, lidx, vals, valid, out, T,
            v_chunk, R)
    fold_scatter.launches += 1
    record()
    return out


def fold_scatter_add(target, lidx, vals, valid):
    """T3's scatter-add, each slot's rows added in row order (in chunks of
    ``FOLD_ADD_MAX_ROWS`` rows a tile: ``path``); the arguments of
    :func:`fold_scatter`.  The kernel runs over a grid (T, G) of
    column-owning blocks, G and ``step`` the :func:`device_split` of the
    tiles' slices (``split``).  A wrapper of its own, so that its kernel's
    launches are counted apart from the min fold's."""
    if target.device.type == "cpu":
        record()
        return scatter_body(target, lidx, vals, valid, "add")
    T, v_chunk, R = _fold_checked(target, lidx, vals, valid)
    out = torch.empty_like(target)
    split = device_split(T, v_chunk, target.device)
    _launch("repro_fold_scatter_add", target, lidx, vals, valid, out, T,
            v_chunk, R, *split)
    fold_scatter_add.path = add_chunks(R)
    fold_scatter_add.split = split
    fold_scatter_add.launches += 1
    record()
    return out


KERNELS = (frontier_pop, queue_push_pop, edge_scan_gather, edge_scan_stream,
           fold_scatter, fold_scatter_add)
for _k in KERNELS:
    _k.launches = 0
for _k in (queue_push_pop, edge_scan_stream, fold_scatter_add):
    _k.path = None
fold_scatter_add.split = None
