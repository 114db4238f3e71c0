"""Hopper kernels of the engine round, their plain PyTorch versions, and the
build loader (port of ``repro.kernels.engine.kernel``'s unfused path).

Four wrappers replace the four TPU kernels the reference's
``backend="pallas", pallas_fuse=False`` round launches (5 launches per
round: ``queue_push_pop`` once per channel):

=====================  ===============================================
wrapper                TPU kernel it replaces (src/repro/kernels/...)
=====================  ===============================================
:func:`frontier_pop`      ``engine/kernel.py:371`` (body ``frontier_take``)
:func:`queue_push_pop`    ``engine/kernel.py:417`` (``fifo_turn`` +
                          ``queue_append``)
:func:`edge_scan_gather`  ``engine/kernel.py:473`` (``segment_gather``)
:func:`fold_scatter`      ``engine/kernel.py:557`` (``scatter_body``,
                          ``op="min"``)
=====================  ===============================================

Each wrapper takes tile-batched ``(T, ...)`` tensors.  On CPU tensors it
runs its plain version (:func:`frontier_take`, :func:`fifo_turn`,
:func:`segment_gather`, :func:`scatter_body` — batched ports of the
reference's pure bodies).  On CUDA tensors it checks dtype, shape and
contiguity, allocates its outputs, launches its CUDA kernel
(``csrc/engine_kernels.cu``, what bounds it and how is written beside
each kernel there) on the current stream and raises if the launch failed;
there is no fallback.  Every call is counted for ``Stats.launches``
through :func:`repro_torch.kernels.engine.launches.record`; the wrapper's
own ``launches`` attribute counts real CUDA launches only.

The CUDA source is compiled at first use by ``nvcc`` for ``sm_90a`` into
``build/repro_torch/`` at the repository root, keyed by a hash of the
source and the flags, and loaded with ``ctypes`` (plain C interface, no
torch headers).  A failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.queues import Queue, queue_push
from repro_torch.kernels.engine.launches import record

# float32 max: the "unreached" sentinel and the min fold's neutral element
_INF = float(np.finfo(np.float32).max)

SOURCE = Path(__file__).resolve().parent / "csrc" / "engine_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# queue_push_pop keeps the compacted fresh-row indices in shared memory
_QP_MAX_ROWS = 8192
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_frontier_pop": [_P] * 5 + [_I] * 3 + [_P],
    "repro_queue_push_pop": [_P] * 10 + [_I] * 5 + [_P],
    "repro_edge_scan_gather": [_P] * 8 + [_I] * 4 + [_P],
    "repro_fold_scatter_min": [_P] * 5 + [_I] * 3 + [_P],
}


# ==========================================================================
# Build and load.
# ==========================================================================

class _Library:
    """The built kernel library, loaded once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self.path = None
        self.build_log = ""      # nvcc/ptxas output of this process's build
        self.build_seconds = 0.0  # 0 when an earlier build was reused

    def get(self):
        with self._lock:
            if self._lib is None:
                self.path = self._build()
                lib = ctypes.CDLL(str(self.path))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
                lib.repro_cuda_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def _build(self) -> Path:
        src = SOURCE.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        out = BUILD_DIR / f"engine_kernels_{tag[:16]}.so"
        if out.exists():
            return out
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}: "
                f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
        return out


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the engine kernels are compiled with the CUDA "
        "toolkit's nvcc at first use (set CUDA_HOME)")


LIBRARY = _Library()


def _launch(name: str, *args):
    """Call launcher ``name`` with tensors as device pointers, ints as C
    ints and the current stream last; raise if the launch failed."""
    lib = LIBRARY.get()
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    rc = getattr(lib, name)(*cargs, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: "
                           f"{lib.repro_cuda_error_string(rc).decode()}")


def _check(*operands):
    """Check the operands of a CUDA launch, each ``(name, tensor, dtype,
    shape)``: every dtype, shape and contiguity first, then that each
    tensor lies on a CUDA device."""
    for name, x, dtype, shape in operands:
        if x.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: the kernel needs a contiguous tensor")
    for name, x, _, _ in operands:
        if x.device.type != "cuda":
            raise ValueError(f"{name}: the kernel needs a CUDA tensor, got "
                             f"{x.device}")


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


def scatter_body(target, lidx, vals, valid, op: str):
    """The T3 owner-local scatter-min / scatter-add of each tile's rows
    into its ``(v_chunk,)`` slice; ``lidx == v_chunk`` is the trash slot
    and invalid rows contribute the neutral element."""
    T, v_chunk = target.shape
    neutral = _INF if op == "min" else 0.0
    ext = torch.cat([target, target.new_full((T, 1), neutral)], dim=1)
    masked = torch.where(valid, vals, neutral)
    if op == "min":
        ext.scatter_reduce_(1, lidx.to(torch.int64), masked, "amin")
    else:
        ext.scatter_add_(1, lidx.to(torch.int64), masked)
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
    cap-0 queue returns at once, with no launch."""
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
    if m > _QP_MAX_ROWS or cap * w >= 2 ** 31:
        raise ValueError(f"queue_push_pop takes at most {_QP_MAX_ROWS} "
                         f"fresh rows and cap*w < 2**31; got {m}, "
                         f"{cap}*{w}")
    dev = data.device
    taken = torch.empty((T, max_n, w), dtype=torch.int32, device=dev)
    tvalid = torch.empty((T, max_n), dtype=torch.bool, device=dev)
    ndata = torch.empty_like(data)
    ncount = torch.empty_like(count)
    drops = torch.empty_like(count)
    _launch("repro_queue_push_pop", data, count, rows, valid, n, taken,
            tvalid, ndata, ncount, drops, T, cap, w, m, max_n)
    queue_push_pop.launches += 1
    record()
    return taken, tvalid, ndata, ncount, drops


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


def fold_scatter(target, lidx, vals, valid, op: str = "min"):
    """T3: fold each tile's delivered rows into its ``(v_chunk,)`` slice —
    scatter-min (relaxations) or scatter-add (accumulations; CPU only for
    now).  target (T, v_chunk) float32, lidx (T, R) int32 with ``v_chunk``
    as the trash slot, vals (T, R) float32, valid (T, R) bool."""
    if op not in ("min", "add"):
        raise ValueError(op)
    if target.device.type == "cpu":
        record()
        return scatter_body(target, lidx, vals, valid, op)
    if op == "add":
        raise NotImplementedError(
            "fold_scatter(op='add') on the card needs a reduction that "
            "keeps row order; still to port (ROADMAP.md, kernels queue)")
    T, v_chunk = target.shape
    R = lidx.shape[1]
    _check(("target", target, torch.float32, (T, v_chunk)),
           ("lidx", lidx, torch.int32, (T, R)),
           ("vals", vals, torch.float32, (T, R)),
           ("valid", valid, torch.bool, (T, R)))
    out = torch.empty_like(target)
    _launch("repro_fold_scatter_min", target, lidx, vals, valid, out, T,
            v_chunk, R)
    fold_scatter.launches += 1
    record()
    return out


KERNELS = (frontier_pop, queue_push_pop, edge_scan_gather, fold_scatter)
for _k in KERNELS:
    _k.launches = 0
