#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the Dalorex engine on one GPU.

    python3 chip_smoke.py [--phases kernels,twin,main,block,pagerank]

Phases, in order; any failed check raises and the script exits non-zero:

1. device and build — the card's name and power limit (nvidia-smi), and
   the build of the three kernel sources (``src/repro_torch/kernels/
   {engine,scatter_update,spmv}/csrc/*.cu``; one nvcc each, sm_90a, all
   started together);
2. kernels — each of the seven kernels against its plain PyTorch version
   on the same CUDA tensors, at the main paths' shapes plus the edge cases
   of the CPU sweeps: bitwise equal on every output element, except
   ``spmv_block_ell``, whose sums run in another order (``rtol = atol =
   1e-4``).  Prints each kernel's time (CUDA events, median of 25 launches
   with the L2 cache flushed before each), its plain version's time, its
   bound (bytes moved over 3.35 TB/s) and, where one PyTorch call
   computes the same function, that call's time;
3. engine twin — R-MAT scale 10 over 16 tiles, ``backend="torch"``
   against ``backend="kernels"``: values and Stats bitwise equal (but
   ``launches``), and equal to (or within the reference's tolerance of)
   the oracle, for BFS (async and BSP), SSSP, WCC, SpMV, PageRank,
   k-core (k = 2, 5; async and BSP) and triangles;
4. the main paths over R-MAT-22 (edge factor 10, seed 1) on 64 tiles,
   the partition built once: one BFS query from vertex 0 (the highest
   out-degree) with ``EngineConfig(cap_updq=262144)``, hop counts equal to
   the oracle; then one SpMV ``y[dst] += val * x[src]`` with
   ``EngineConfig(cap_updq=SPMV_CAP_UPDQ)``, every update applied once
   and within the reference's tolerance plus the float32 error limit of
   the oracle (``spmv_f32_bound``, which a planted lost or doubled hub
   term must exceed).  Each: no drops, five kernel calls per round, every
   kernel of the path launched (counts read just after the path);
5. block — R-MAT-14: ``spmv_block_ell`` (b = 128) on A[dst, src] = val
   against the dense oracle and the engine's SpMV at T = 16, and the
   same product as binned ``scatter_segments`` rounds (add, and a min),
   bitwise equal to numpy's serial ``np.add.at`` / ``np.minimum.at``;
6. PageRank — R-MAT-18 over 64 tiles, 5 iterations, against the oracle
   (the depth is cut from the reference's 20 for chip time only).

The last lines are the kernels' JSON record, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or away from
the repository, the script fails before printing any result.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core.engine import EngineConfig  # noqa: E402
from repro_torch.core.graph import CSRGraph, rmat_edges  # noqa: E402
from repro_torch.core import reference as ref  # noqa: E402
from repro_torch.kernels import scatter_update as SEG  # noqa: E402
from repro_torch.kernels import spmv as SPMV  # noqa: E402
from repro_torch.kernels.engine import kernel as K  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
ENGINE_SRC = "src/repro_torch/kernels/engine/csrc/engine_kernels.cu"
TPU_KERNEL = "src/repro/kernels/engine/kernel.py"
# name: (source, TPU kernel it replaces)
KERNEL_ROWS = {
    "frontier_pop": (ENGINE_SRC, f"{TPU_KERNEL}:371"),
    "queue_push_pop": (ENGINE_SRC, f"{TPU_KERNEL}:417"),
    "edge_scan_gather": (ENGINE_SRC, f"{TPU_KERNEL}:473"),
    "fold_scatter": (ENGINE_SRC, f"{TPU_KERNEL}:557"),
    "fold_scatter_add": (ENGINE_SRC, f"{TPU_KERNEL}:557"),
    "scatter_segments": (
        "src/repro_torch/kernels/scatter_update/csrc/scatter_segments.cu",
        "src/repro/kernels/scatter_update/kernel.py:47"),
    "spmv_block_ell": (
        "src/repro_torch/kernels/spmv/csrc/spmv_block_ell.cu",
        "src/repro/kernels/spmv/kernel.py:42"),
}
ALL_WRAPPERS = (*K.KERNELS, SEG.scatter_segments, SPMV.spmv_block_ell)

# Main path: R-MAT-22 over T=64 tiles (v_chunk, e_chunk of its partition).
# The update (spill) queue holds 262144 entries: its one-round burst bound
# (EngineConfig.min_caps, 32832 here, rounded up to 65536) drops updates on
# this graph, because tiles whose updates converge on a few hot owners keep
# spilling faster than the 64-entry replay drains; this run's peak
# occupancy is 169369 entries (PERF.md).
MAIN_SCALE, MAIN_T, MAIN_ROOT = 22, 64, 0
MAIN_V_CHUNK, MAIN_E_CHUNK = 65536, 642283
MAIN_CFG = EngineConfig(cap_updq=262144)
# SpMV on the same partition starts with every vertex that has out-edges
# in the frontier, so its update burst is larger: the update queue is the
# smallest power of two above 4/3 of the peak occupancy that
# tools/port_round_profile.py --app spmv measured with the queue at the
# tile budget's largest admissible size (PERF.md), so the TSU's throttle
# keeps its quarter of headroom.
SPMV_CAP_UPDQ = 131072
SPMV_CFG = EngineConfig(cap_updq=SPMV_CAP_UPDQ)
SPMV_SEED, SPMV_SOURCES = 0, 1750061  # x's seed; vertices with out-edges
BLOCK_SCALE, BLOCK_B, BLOCK_T = 14, 128, 16
# the knobs of the reference's block-ELL test (tests/test_kernels.py:75)
TEST_KNOBS = dict(f_pop=8, r_pop=8, u_pop=16, max_t2=8, cap_route_range=8,
                  cap_route_update=32, cap_rangeq=128, cap_updq=4096,
                  max_rounds=20000)
SEG_CAP = 4096        # updates per bin and round of the binned scatter
PR_SCALE, PR_ITERS = 18, 5
INF32 = float(np.finfo(np.float32).max)
REPS = 25


def log(*a):
    print(*a, flush=True)


def spmv_x(n: int) -> np.ndarray:
    """The main SpMV path's ``x``: normal float32 from ``SPMV_SEED``."""
    return np.random.default_rng(SPMV_SEED).normal(size=n) \
        .astype(np.float32)


# --------------------------------------------------------------------------
# Timing
# --------------------------------------------------------------------------

class Timer:
    """Median CUDA-event time of ``fn`` over REPS launches after warm-up,
    with the 50 MB L2 cache overwritten before each timed launch."""

    def __init__(self, dev):
        self.flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=dev)

    def ms(self, fn) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(REPS):
            self.flush.fill_(1)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(moved_bytes: int) -> float:
    return moved_bytes / HBM_BYTES_PER_S * 1e3


def max_abs_err(got, want) -> float:
    """Largest |kernel - plain| over all outputs; raises unless every
    output is bitwise equal."""
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"output {i}: {a.shape}/{a.dtype} vs "
                                 f"{b.shape}/{b.dtype}")
        bits_a = a.view(torch.int32) if a.dtype == torch.float32 else a
        bits_b = b.view(torch.int32) if b.dtype == torch.float32 else b
        if not torch.equal(bits_a, bits_b):
            bad = (bits_a != bits_b).nonzero()[:5].tolist()
            raise AssertionError(f"output {i} differs at {bad}")
        if a.numel():
            err = max(err, float((a.double() - b.double()).abs().max()))
    return err


# --------------------------------------------------------------------------
# Phase 1: device and build
# --------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"# card: {smi}")
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    libs = (K.LIBRARY, SEG.LIBRARY, SPMV.LIBRARY)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source
        list(pool.map(lambda lib: lib.get(), libs))
    log(f"# kernel build: {time.perf_counter() - t0:.2f} s for "
        f"{len(libs)} sources built together")
    for lib in libs:
        log(f"#   {lib.source.name}: nvcc {lib.build_seconds:.2f} s -> "
            f"{lib.path}")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"#   ptxas: {line.strip()}")
    return smi


# --------------------------------------------------------------------------
# Phase 2: each kernel against its plain version on the card
# --------------------------------------------------------------------------

def rng_tensor(rng, a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def frontier_inputs(rng, T, n, k_max, dev):
    dens = rng.choice([0.0, 0.001, 0.02, 0.3, 1.0], size=T)
    mask = rng.random((T, n)) < dens[:, None]
    k = rng.integers(0, k_max + 1, T).astype(np.int32)
    k[:4] = [0, k_max, k_max, 1][:T]
    return rng_tensor(rng, mask, dev), rng_tensor(rng, k, dev)


def check_frontier_pop(rng, dev, timer):
    k_max = MAIN_CFG.f_pop
    for T, n in ((3, 257), (5, 48), (2, 16)):  # ragged / small edge cases
        mask, k = frontier_inputs(rng, T, n, k_max, dev)
        max_abs_err(K.frontier_pop(mask, k, k_max),
                    K.frontier_take(mask, k, k_max))
    mask, k = frontier_inputs(rng, MAIN_T, MAIN_V_CHUNK, k_max, dev)
    out = K.frontier_pop(mask, k, k_max)
    err = max_abs_err(out, K.frontier_take(mask, k, k_max))
    moved = nbytes(mask, k, *out)
    return dict(
        max_abs_err=err,
        ms=timer.ms(lambda: K.frontier_pop(mask, k, k_max)),
        plain_ms=timer.ms(lambda: K.frontier_take(mask, k, k_max)),
        bound_ms=bound_ms(moved), library_ms=None)


def queue_inputs(rng, T, cap, w, m, max_n, dev, full_rows=False):
    data = rng.integers(-9, 1 << 22, (T, cap, w)).astype(np.int32)
    count = rng.integers(0, cap + 1, T).astype(np.int32)
    count[:3] = [0, cap, max(cap - 2, 0)][:T]  # empty / full / overflow
    rows = rng.integers(0, 1 << 22, (T, m, w)).astype(np.int32)
    valid = rng.random((T, m)) < (0.0 if not full_rows else 0.7)
    n = rng.integers(0, max_n + 1, T).astype(np.int32)
    n[:2] = [max_n, 0]
    return [rng_tensor(rng, a, dev) for a in (data, count, rows, valid, n)]


def check_queue_push_pop(rng, dev, timer):
    for T, cap, w, m, max_n in ((3, 16, 3, 8, 6), (4, 8, 2, 8, 8),
                                (2, 32, 4, 1, 8)):
        args = queue_inputs(rng, T, cap, w, m, max_n, dev, full_rows=True)
        max_abs_err(K.queue_push_pop(*args, max_n), K.fifo_turn(*args, max_n))
    cfg = MAIN_CFG
    calls = []
    # the two calls of a round: the range channel (fresh tasks) and the
    # update channel (replay only: one empty fresh row)
    for label, cap, w, m, max_n, fresh in (
            ("range", cfg.cap_rangeq, 3, cfg.f_pop, cfg.r_pop, True),
            ("update", cfg.cap_updq, 2, 1, cfg.u_pop, False)):
        args = queue_inputs(rng, MAIN_T, cap, w, m, max_n, dev, fresh)
        out = K.queue_push_pop(*args, max_n)
        err = max_abs_err(out, K.fifo_turn(*args, max_n))
        calls.append(dict(
            call=label, shape=[MAIN_T, cap, w], max_abs_err=err,
            ms=timer.ms(lambda: K.queue_push_pop(*args, max_n)),
            plain_ms=timer.ms(lambda: K.fifo_turn(*args, max_n)),
            bound_ms=bound_ms(nbytes(*args, *out))))
    total = {key: sum(c[key] for c in calls)
             for key in ("ms", "plain_ms", "bound_ms")}
    return dict(max_abs_err=max(c["max_abs_err"] for c in calls),
                library_ms=None, calls=calls, **total)


def scan_inputs(rng, T, e_chunk, R, max_t2, dev):
    ed = rng.integers(-1, 1 << 22, (T, e_chunk)).astype(np.int32)
    ev = rng.uniform(1, 10, (T, e_chunk)).astype(np.float32)
    start = rng.integers(0, T * e_chunk, (T, R)).astype(np.int32)
    stop = start + rng.integers(0, max_t2 + 1, (T, R)).astype(np.int32)
    rv = rng.random((T, R)) < 0.5
    start = np.where(rv | (rng.random((T, R)) < 0.5), start, -1)
    return [rng_tensor(rng, a, dev)
            for a in (ed, ev, start.astype(np.int32), stop, rv)]


def check_edge_scan_gather(rng, dev, timer):
    max_t2 = MAIN_CFG.max_t2
    for T, e_chunk, R, mt in ((2, 64, 10, 8), (2, 33, 24, 4),
                              (3, 128, 1, 16)):
        args = scan_inputs(rng, T, e_chunk, R, mt, dev)
        max_abs_err(K.edge_scan_gather(*args, mt),
                    K.segment_gather(*args, mt))
    R = MAIN_T * MAIN_CFG.cap_route_range
    ed, ev, start, stop, rv = args = scan_inputs(rng, MAIN_T, MAIN_E_CHUNK,
                                                 R, max_t2, dev)
    out = K.edge_scan_gather(*args, max_t2)
    err = max_abs_err(out, K.segment_gather(*args, max_t2))
    # bytes this run needs: the rows, each distinct shard word the lanes
    # address, and the three outputs
    local0 = torch.where(rv, start % MAIN_E_CHUNK, 0)
    j = torch.arange(max_t2, device=dev, dtype=torch.int32)
    eidx = torch.clamp(local0[:, :, None] + j, max=MAIN_E_CHUNK - 1)
    words = sum(int(torch.unique(eidx[t]).numel()) for t in range(MAIN_T))
    moved = nbytes(start, stop, rv, *out) + 8 * words
    # library yardstick: one torch.gather of the (dst, val) word pairs at
    # the clamped lane indices (jvalid not included)
    pairs = torch.stack([ed, ev.view(torch.int32)], dim=-1)
    gidx = eidx.reshape(MAIN_T, -1, 1).expand(-1, -1, 2).to(torch.int64)
    return dict(
        max_abs_err=err,
        ms=timer.ms(lambda: K.edge_scan_gather(*args, max_t2)),
        plain_ms=timer.ms(lambda: K.segment_gather(*args, max_t2)),
        bound_ms=bound_ms(moved),
        library_ms=timer.ms(lambda: torch.gather(pairs, 1, gidx)))


def fold_inputs(rng, T, v_chunk, R, dev):
    tgt = np.where(rng.random((T, v_chunk)) < 0.5, INF32,
                   rng.integers(0, 30, (T, v_chunk))).astype(np.float32)
    valid = rng.random((T, R)) < 0.8
    lidx = np.where(valid, rng.integers(0, v_chunk, (T, R)), v_chunk)
    lidx[:, : R // 4] = np.where(valid[:, : R // 4], 3, v_chunk)  # dups
    vals = rng.normal(10, 12, (T, R)).astype(np.float32)  # some negative
    return [rng_tensor(rng, a, dev)
            for a in (tgt, lidx.astype(np.int32), vals, valid)]


def check_fold_scatter(rng, dev, timer):
    for T, v, R in ((3, 32, 20), (2, 8, 64), (2, 128, 1)):
        args = fold_inputs(rng, T, v, R, dev)
        max_abs_err([K.fold_scatter(*args)], [K.scatter_body(*args, "min")])
    tgt, lidx, vals, valid = args = fold_inputs(
        rng, MAIN_T, MAIN_V_CHUNK, MAIN_T * MAIN_CFG.cap_route_update, dev)
    out = K.fold_scatter(*args)
    err = max_abs_err([out], [K.scatter_body(*args, "min")])
    # library yardstick: one scatter_reduce(amin) into the slice plus its
    # trash column, rows pre-masked
    ext = torch.cat([tgt, tgt.new_full((MAIN_T, 1), INF32)], dim=1)
    masked = torch.where(valid, vals, INF32)
    lidx64 = lidx.to(torch.int64)
    return dict(
        max_abs_err=err,
        ms=timer.ms(lambda: K.fold_scatter(*args)),
        plain_ms=timer.ms(lambda: K.scatter_body(*args, "min")),
        bound_ms=bound_ms(nbytes(*args, out)),
        library_ms=timer.ms(
            lambda: ext.scatter_reduce(1, lidx64, masked, "amin")))


def add_fold_inputs(rng, T, v_chunk, R, dev, kind):
    """Add-fold inputs: "path" draws slots as the SpMV path spreads them;
    "dups" puts a quarter of the rows on one slot, "one-slot" all of them,
    "invalid" none (every row on the trash slot); these send invalid rows
    to the trash slot.  "invalid-on-real-slots" puts the invalid rows on
    slots 0 and 1 and the valid ones on the others.  Slot 0 holds -0.0,
    which invalid rows alone turn into +0.0 (each adds 0.0, as the
    reference does)."""
    tgt = rng.normal(0, 1, (T, v_chunk)).astype(np.float32)
    tgt[:, 0] = -0.0
    valid = rng.random((T, R)) < 0.8
    lidx = rng.integers(0, v_chunk, (T, R))
    if kind == "dups":
        lidx[:, : R // 4] = 3
    elif kind == "one-slot":
        lidx[:] = 1
    elif kind == "invalid":
        valid[:] = False
    if kind == "invalid-on-real-slots":
        lidx = np.where(valid, rng.integers(2, v_chunk, (T, R)),
                        rng.integers(0, 2, (T, R)))
    else:
        lidx = np.where(valid, lidx, v_chunk)
    lidx = lidx.astype(np.int32)
    vals = (rng.normal(0, 1, (T, R)) * 10.0 ** rng.integers(
        -3, 4, (T, R))).astype(np.float32)  # mixed magnitudes
    return [rng_tensor(rng, a, dev) for a in (tgt, lidx, vals, valid)]


def check_fold_scatter_add(rng, dev, timer):
    fold = K.fold_scatter_add

    def plain(*a):
        return K.scatter_body(*a, "add")

    R = MAIN_T * SPMV_CFG.cap_route_update
    for T, v, r, kind in ((3, 32, 20, "dups"), (2, 8, 64, "dups"),
                          (2, 128, 1, "path"), (2, 16, 300, "one-slot"),
                          (2, 16, 40, "invalid"),
                          (3, 4, 64, "invalid-on-real-slots"),
                          (MAIN_T, MAIN_V_CHUNK, R, "dups"),
                          (MAIN_T, MAIN_V_CHUNK, R, "one-slot")):
        args = add_fold_inputs(rng, T, v, r, dev, kind)
        max_abs_err([fold(*args)], [plain(*args)])
    tgt, lidx, vals, valid = args = add_fold_inputs(
        rng, MAIN_T, MAIN_V_CHUNK, R, dev, "path")
    out = fold(*args)
    err = max_abs_err([out], [plain(*args)])
    # library yardstick: one out-of-place scatter_add into the slice plus
    # its trash column, rows pre-masked (float atomics: not order-keeping)
    ext = torch.cat([tgt, tgt.new_zeros((MAIN_T, 1))], dim=1)
    masked = torch.where(valid, vals, 0.0)
    lidx64 = lidx.to(torch.int64)
    return dict(
        max_abs_err=err, ms=timer.ms(lambda: fold(*args)),
        plain_ms=timer.ms(lambda: plain(*args)),
        bound_ms=bound_ms(nbytes(*args, out)),
        library_ms=timer.ms(lambda: ext.scatter_add(1, lidx64, masked)))


def seg_inputs(rng, nb, b, cap, dev, kind):
    base = rng.normal(0, 1, (nb, b)).astype(np.float32)
    idx = rng.integers(-1, b, (nb, cap))  # -1 = empty slot
    if kind == "one-slot":
        idx = np.where(rng.random((nb, cap)) < 0.8, 5, -1)
    elif kind == "empty":
        idx[:] = -1
    vals = rng.normal(0, 1, (nb, cap)).astype(np.float32)
    return [rng_tensor(rng, a, dev)
            for a in (base, idx.astype(np.int32), vals)]


def check_scatter_segments(rng, dev, timer):
    """At the TPU tests' shapes, the edge cases, and the engine's T3 shape
    (NB = 64 bins of b = 65536 slots, cap = 4096 updates each)."""
    calls = []
    for op in ("add", "min"):
        for nb, b, cap, kind in ((4, 128, 32, "mixed"), (2, 64, 128, "mixed"),
                                 (3, 32, 200, "one-slot"),
                                 (2, 64, 16, "empty"), (2, 16, 1, "mixed"),
                                 (MAIN_T, MAIN_V_CHUNK, SEG_CAP,
                                  "one-slot")):
            args = seg_inputs(rng, nb, b, cap, dev, kind)
            max_abs_err([SEG.scatter_segments(*args, op=op)],
                        [SEG.binned_scatter(*args, op)])
        # timed at the TPU tests' shapes and at the T3 shape
        for nb, b, cap in ((4, 128, 32), (2, 64, 128),
                           (MAIN_T, MAIN_V_CHUNK, SEG_CAP)):
            base, idx, vals = args = seg_inputs(rng, nb, b, cap, dev,
                                                "mixed")
            out = SEG.scatter_segments(*args, op=op)
            err = max_abs_err([out], [SEG.binned_scatter(*args, op)])
            ext = torch.cat([base, base.new_full((nb, 1), INF32)], dim=1)
            slot = torch.where(idx < 0, b, idx).to(torch.int64)
            library = (functools.partial(ext.scatter_add, 1, slot, vals)
                       if op == "add" else functools.partial(
                           ext.scatter_reduce, 1, slot, vals, "amin"))
            calls.append(dict(
                call=op, shape=[nb, b, cap], max_abs_err=err,
                ms=timer.ms(lambda: SEG.scatter_segments(*args, op=op)),
                plain_ms=timer.ms(lambda: SEG.binned_scatter(*args, op)),
                bound_ms=bound_ms(nbytes(*args, out)),
                library_ms=timer.ms(library)))
    t3 = [c for c in calls if c["shape"] == [MAIN_T, MAIN_V_CHUNK, SEG_CAP]]
    # the row's times: the add and the min call at the T3 shape, summed
    total = {key: sum(c[key] for c in t3)
             for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    return dict(max_abs_err=max(c["max_abs_err"] for c in calls),
                calls=calls, **total)


def coo_block_ell(n, rows, cols, vals, b, dev):
    """Block-ELL operands of the (n x n) COO matrix, on ``dev``."""
    bvals, bcols, n_pad = SPMV.to_block_ell(n, rows, cols, vals, b)
    return (torch.from_numpy(bvals).to(dev), torch.from_numpy(bcols).to(dev),
            n_pad)


@functools.lru_cache(maxsize=None)
def block_graph():
    """R-MAT-14 (edge factor 10, seed 1) as A[dst, src] = val."""
    n, src, dst, val = rmat_edges(BLOCK_SCALE, edge_factor=10, seed=1)
    g = CSRGraph.from_edges(n, src, dst, val)
    src_idx = np.repeat(np.arange(n), g.ptr[1:] - g.ptr[:-1])
    return g, src_idx


def spmv_within_tol(got, want, what):
    err = float((got.double() - want.double()).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4, msg=what)
    return err


def check_spmv_block_ell(rng, dev, timer):
    for n, nnz, b in ((300, 2000, 64), (513, 4000, 128), (100, 500, 32),
                      (64, 0, 32)):
        rows, cols = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
        vals = rng.normal(size=nnz).astype(np.float32)
        bv, bc, n_pad = coo_block_ell(n, rows, cols, vals, b, dev)
        x = torch.from_numpy(rng.normal(size=n_pad).astype(np.float32)) \
            .to(dev)
        spmv_within_tol(SPMV.spmv_block_ell(bv, bc, x),
                        SPMV.block_ell_matvec(bv, bc, x), f"n={n} b={b}")
    g, src_idx = block_graph()
    bv, bc, n_pad = coo_block_ell(g.num_vertices, g.dst, src_idx, g.val,
                                  BLOCK_B, dev)
    x = torch.from_numpy(rng.normal(size=n_pad).astype(np.float32)).to(dev)
    y = SPMV.spmv_block_ell(bv, bc, x)
    err = spmv_within_tol(y, SPMV.block_ell_matvec(bv, bc, x), "R-MAT-14")
    live = int((bc >= 0).sum())
    log(f"#   block-ELL R-MAT-{BLOCK_SCALE}: {live} nonzero blocks of "
        f"{BLOCK_B}x{BLOCK_B}, S = {bc.shape[1]}, bvals "
        f"{nbytes(bv) / 2 ** 30:.3f} GiB")
    # bytes this run needs: each nonzero block once, bcols, x, y
    moved = live * BLOCK_B * BLOCK_B * 4 + nbytes(bc, x, y)
    # library yardstick: one cuSPARSE CSR matrix-vector product of the
    # same matrix (built from the COO outside the timing)
    order = np.lexsort((src_idx, g.dst))
    crow = np.concatenate([[0], np.cumsum(np.bincount(g.dst,
                                                      minlength=n_pad))])
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(crow).to(dev), torch.from_numpy(src_idx[order])
        .to(dev), torch.from_numpy(g.val[order]).to(dev), (n_pad, n_pad),
        check_invariants=True)
    torch.testing.assert_close(csr @ x, y, rtol=1e-4, atol=1e-4)
    return dict(
        max_abs_err=err, ms=timer.ms(lambda: SPMV.spmv_block_ell(bv, bc, x)),
        plain_ms=timer.ms(lambda: SPMV.block_ell_matvec(bv, bc, x)),
        bound_ms=bound_ms(moved), library_ms=timer.ms(lambda: csr @ x))


def phase_kernels(dev):
    rng = np.random.default_rng(0)
    timer = Timer(dev)
    rows = {}
    for name, check in (("frontier_pop", check_frontier_pop),
                        ("queue_push_pop", check_queue_push_pop),
                        ("edge_scan_gather", check_edge_scan_gather),
                        ("fold_scatter", check_fold_scatter),
                        ("fold_scatter_add", check_fold_scatter_add),
                        ("scatter_segments", check_scatter_segments),
                        ("spmv_block_ell", check_spmv_block_ell)):
        r = check(rng, dev, timer)
        torch.cuda.synchronize()
        rows[name] = r
        lib = "n/a" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        agree = ("within rtol = atol = 1e-4 of" if name == "spmv_block_ell"
                 else "bitwise equal to")
        log(f"# kernel {name}: {agree} its plain version; "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms (bytes), library {lib}")
        for c in r.get("calls", []):
            log(f"#   {c['call']} call {c['shape']}: kernel "
                f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, bound "
                f"{c['bound_ms']:.4f} ms"
                + (f", library {c['library_ms']:.4f} ms"
                   if "library_ms" in c else ""))
    return rows


# --------------------------------------------------------------------------
# Phases 3 and 4: the engine
# --------------------------------------------------------------------------

def assert_stats_equal(a, b, where):
    for f, x, y in zip(a._fields, a, b):
        if f == "launches":
            continue
        bx = x.view(torch.int32) if x.dtype == torch.float32 else x
        by = y.view(torch.int32) if y.dtype == torch.float32 else y
        if not torch.equal(bx, by):
            raise AssertionError(f"Stats.{f} differs ({where}): "
                                 f"{x.tolist()} vs {y.tolist()}")


def build_graph(scale, T, dev):
    n, src, dst, val = rmat_edges(scale, edge_factor=10, seed=1)
    g = CSRGraph.from_edges(n, src, dst, val)
    return g, alg.prepare(g, T, "low_order", device=dev)


def reset_launches():
    for k in ALL_WRAPPERS:
        k.launches = 0


def read_launches() -> dict:
    return {k.__name__: k.launches for k in ALL_WRAPPERS}


def twin_apps(g, pg, gs, pgs, pgt, root, x):
    """name: (run(cfg) on the port, oracle, tolerance or None for exact)."""
    return {
        "bfs-bsp": (lambda c: alg.bfs(pg, root, dataclasses.replace(
            c, mode="bsp")), ref.bfs_ref(g, root), None),
        "sssp": (lambda c: alg.sssp(pg, root, c), ref.sssp_ref(g, root),
                 dict(rtol=1e-5, atol=0.0)),
        "wcc": (lambda c: alg.wcc(pgs, c), ref.wcc_ref(gs), None),
        "spmv": (lambda c: alg.spmv(pg, x, c),
                 ref.spmv_ref(g, x.astype(np.float64)),
                 dict(rtol=2e-4, atol=1e-4)),
        "pagerank": (lambda c: alg.pagerank(pg, iters=8, cfg=c),
                     ref.pagerank_ref(g, iters=8),
                     dict(rtol=2e-3, atol=1e-7)),
        **{f"kcore{k}-{mode}": (
            lambda c, k=k, mode=mode: alg.kcore(
                pgs, k, dataclasses.replace(c, mode=mode)),
            ref.kcore_ref(gs, k), None)
           for k in (2, 5) for mode in ("async", "bsp")},
        "triangles": (lambda c: alg.triangles(pgt, c),
                      ref.triangles_ref(gs, key=pgt.place), None),
    }


def check_values(got, want, tol, where):
    if tol is None:
        np.testing.assert_array_equal(got, want, err_msg=where)
        return
    finite = np.isfinite(want)
    assert (np.isfinite(got) == finite).all(), where
    np.testing.assert_allclose(got[finite], want[finite], err_msg=where,
                               **tol)


def phase_twin(dev):
    g, pg = build_graph(10, 16, dev)
    root = int(np.argmax(g.ptr[1:] - g.ptr[:-1]))
    small = dict(f_pop=8, r_pop=8, u_pop=16, max_t2=8, cap_route_range=8,
                 cap_route_update=32, cap_rangeq=128, cap_updq=4096)
    oracle = ref.bfs_ref(g, root)
    for knobs in (small, {}):
        res = {b: alg.bfs(pg, root, EngineConfig(backend=b, **knobs))
               for b in ("torch", "kernels")}
        np.testing.assert_array_equal(res["torch"].values,
                                      res["kernels"].values)
        np.testing.assert_array_equal(res["kernels"].values, oracle)
        assert_stats_equal(res["torch"].stats, res["kernels"].stats,
                           "torch vs kernels")
        st = res["kernels"].stats
        assert int(st.drops) == 0
        assert int(st.launches) == 5 * int(st.rounds)
        log(f"# engine twin (scale 10, T=16, "
            f"{'small knobs' if knobs else 'default knobs'}): torch == "
            f"kernels bitwise, == oracle; rounds {int(st.rounds)}, spills "
            f"{st.spills.tolist()}")
    gs = alg.symmetrize(g)
    pgs = alg.prepare(gs, 16, device=dev)
    pgt = alg.prepare_triangles(gs, 16, device=dev)
    x = np.random.default_rng(3).normal(size=g.num_vertices) \
        .astype(np.float32)
    for name, (run, want, tol) in twin_apps(g, pg, gs, pgs, pgt, root,
                                            x).items():
        t0 = time.perf_counter()
        res = {b: run(EngineConfig(backend=b)) for b in ("torch", "kernels")}
        np.testing.assert_array_equal(res["torch"].values,
                                      res["kernels"].values, err_msg=name)
        assert_stats_equal(res["torch"].stats, res["kernels"].stats, name)
        check_values(res["kernels"].values, want, tol, name)
        st = res["kernels"].stats
        assert int(st.drops) == 0, name
        assert int(st.launches) > 0 and int(res["torch"].stats.launches) \
            == 0, name
        log(f"# engine twin {name} (scale 10, T=16, default knobs): torch "
            f"== kernels bitwise, matches the oracle "
            f"({'exact' if tol is None else tol}); rounds {int(st.rounds)},"
            f" epochs {int(st.epochs)}, launches {int(st.launches)}; "
            f"{time.perf_counter() - t0:.1f} s for both backends")


def drive(fn, smi, what, fold):
    """Run one main path with every launch counter at 0 just before it;
    ``fold`` names the fold wrapper the path launches.  Returns (result,
    the counters just after)."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = res.stats
    rounds = int(st.rounds)
    assert int(st.drops) == 0, (what, int(st.drops))
    assert int(st.launches) == 5 * rounds, (what, int(st.launches), rounds)
    want = dict.fromkeys(launches, 0)
    want.update({"frontier_pop": rounds, "queue_push_pop": 2 * rounds,
                 "edge_scan_gather": rounds, fold: rounds})
    assert launches == want, (what, launches, want)
    edges = int(st.edges_scanned)
    log(f"# main path {what}: drops 0; rounds {rounds}, engine wall "
        f"{wall:.3f} s ({1e3 * wall / rounds:.3f} ms/round), edges scanned "
        f"{edges}, {edges / wall / 1e6:.3f} M traversed edges/s, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} "
        f"GiB, kernel launches {launches}; card {smi}")
    return res, launches


def phase_main(dev, smi):
    t0 = time.perf_counter()
    g, pg = build_graph(MAIN_SCALE, MAIN_T, dev)
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    deg = g.ptr[1:] - g.ptr[:-1]
    assert (pg.v_chunk, pg.e_chunk) == (MAIN_V_CHUNK, MAIN_E_CHUNK), \
        (pg.v_chunk, pg.e_chunk)
    assert int(np.argmax(deg)) == MAIN_ROOT
    log(f"# main path graph: R-MAT-{MAIN_SCALE} V={g.num_vertices} "
        f"E={g.num_edges} T={MAIN_T} v_chunk={pg.v_chunk} "
        f"e_chunk={pg.e_chunk}, root {MAIN_ROOT} (out-degree "
        f"{int(deg[MAIN_ROOT])}); host build {t_graph:.1f} s")

    t0 = time.perf_counter()
    oracle = ref.bfs_ref(g, MAIN_ROOT)
    log(f"# BFS oracle: {time.perf_counter() - t0:.1f} s, "
        f"{int(np.isfinite(oracle).sum())} reachable vertices")
    res, bfs_launches = drive(lambda: alg.bfs(pg, MAIN_ROOT, MAIN_CFG), smi,
                              "BFS", "fold_scatter")
    np.testing.assert_array_equal(res.values, oracle)
    log("# main path BFS: hop counts equal to the oracle")

    x = spmv_x(g.num_vertices)
    assert int((deg > 0).sum()) == SPMV_SOURCES
    t0 = time.perf_counter()
    want = ref.spmv_ref(g, x.astype(np.float64))
    log(f"# SpMV oracle: {time.perf_counter() - t0:.1f} s; initial "
        f"frontier {SPMV_SOURCES} vertices with out-edges")
    res, spmv_launches = drive(lambda: alg.spmv(pg, x, SPMV_CFG), smi,
                               f"SpMV (cap_updq {SPMV_CFG.cap_updq})",
                               "fold_scatter_add")
    # every edge scanned once and one update folded for each
    assert int(res.stats.edges_scanned) == g.num_edges
    assert int(res.stats.updates_applied) == g.num_edges
    # The reference's tolerance (rtol 2e-4, atol 1e-4) was set on scale-8
    # graphs.  Here hubs sum ~10^5 float32 terms of both signs, and where
    # they cancel a float32 sum in any order can miss it, so the limit adds
    # the oracle's float32 error limit (SPMV_F32_C times the error scale
    # of a float32 sum).  Printed: the largest error over that scale, for
    # the engine and for numpy's own float32 sum in edge order, and what a
    # median-size term lost or doubled at the largest hub reads.
    ref_tol = 2e-4 * np.abs(want) + 1e-4
    bound = ref.spmv_f32_bound(g, x.astype(np.float64))
    limit = ref_tol + bound
    has = bound > 0   # vertices with in-edges
    src = np.repeat(np.arange(g.num_vertices), deg)
    prod = g.val * x[src]
    y32 = np.zeros(g.num_vertices, np.float32)
    np.add.at(y32, g.dst, prod)
    for what, y in (("engine", res.values), ("numpy float32", y32)):
        err = np.abs(y - want)
        log(f"# SpMV {what} vs the float64 oracle: max abs err "
            f"{err.max():.3e}; {int((err > ref_tol).sum())} of "
            f"{g.num_vertices} vertices outside rtol 2e-4 / atol 1e-4; "
            f"max err / error scale "
            f"{(err[has] / bound[has]).max() * ref.SPMV_F32_C:.4f}; "
            f"max err / limit {(err / limit).max():.4e}")
    hub = int(np.argmax(np.bincount(g.dst, minlength=g.num_vertices)))
    terms = np.sort(np.abs(prod[g.dst == hub]))
    t_med = terms[len(terms) // 2]
    planted = {"lost": res.values[hub] - t_med,
               "doubled": res.values[hub] + t_med}
    log(f"# SpMV planted at hub {hub} ({len(terms)} terms, median |t| "
        f"{t_med:.4e}, limit {limit[hub]:.4e} = tolerance "
        f"{ref_tol[hub]:.4e} + float32 limit {bound[hub]:.4e}): " + ", ".join(
            f"{k} term reads {abs(v - want[hub]) / limit[hub]:.3f} x the "
            f"limit" for k, v in planted.items()))
    err = np.abs(res.values - want)
    assert (err <= limit).all(), int((err > limit).sum())
    assert all(abs(v - want[hub]) > limit[hub] for v in planted.values())
    log("# main path SpMV: within rtol 2e-4 / atol 1e-4 plus the float32 "
        "error limit of the oracle at every vertex; a lost or doubled "
        "median hub term exceeds it")
    return bfs_launches, spmv_launches


def binned_rounds(g, src_idx, prod, b, cap):
    """The products ``prod`` of the edges of ``g`` binned by destination
    block (bins of ``b`` slots), in edge order, as rounds of ``cap`` slots
    per bin: a list of (idx, vals) numpy pairs, -1 marking empty slots."""
    nb = -(-g.num_vertices // b)
    order = np.argsort(g.dst // b, kind="stable")
    bins = g.dst[order] // b
    rank = np.arange(len(order)) - np.searchsorted(bins, bins)
    rounds = []
    for k in range(int(rank.max()) // cap + 1 if len(order) else 0):
        pick = (rank >= k * cap) & (rank < (k + 1) * cap)
        idx = np.full((nb, cap), -1, np.int32)
        vals = np.zeros((nb, cap), np.float32)
        e = order[pick]
        idx[bins[pick], rank[pick] - k * cap] = g.dst[e] % b
        vals[bins[pick], rank[pick] - k * cap] = prod[e]
        rounds.append((idx, vals))
    return nb, rounds


def phase_block(dev, smi):
    g, src_idx = block_graph()
    n = g.num_vertices
    x = np.random.default_rng(7).normal(size=n).astype(np.float32)
    expect = SPMV.spmv_dense_ref(n, g.dst, src_idx, g.val, x)
    bv, bc, n_pad = coo_block_ell(n, g.dst, src_idx, g.val, BLOCK_B, dev)
    x_pad = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    x_pad[:n] = torch.from_numpy(x).to(dev)
    prod = g.val * x[src_idx]  # float32 products, the engine's emit
    nb, rounds = binned_rounds(g, src_idx, prod, BLOCK_B, SEG_CAP)
    add_ref = np.zeros(nb * BLOCK_B, np.float32)
    np.add.at(add_ref, g.dst, prod)   # serial float32, in edge order
    min_ref = np.full(nb * BLOCK_B, np.float32(INF32))
    np.minimum.at(min_ref, g.dst, prod)
    ops = {"add": torch.zeros((nb, BLOCK_B), dtype=torch.float32,
                              device=dev),
           "min": torch.full((nb, BLOCK_B), INF32, device=dev)}

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = SPMV.spmv_block_ell(bv, bc, x_pad)
    for idx, vals in rounds:
        idx_t = torch.from_numpy(idx).to(dev)
        vals_t = torch.from_numpy(vals).to(dev)
        for op in ops:
            ops[op] = SEG.scatter_segments(ops[op], idx_t, vals_t, op=op)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    assert launches["spmv_block_ell"] == 1
    assert launches["scatter_segments"] == 2 * len(rounds)

    y = y[:n].cpu().numpy()
    np.testing.assert_allclose(y, expect, rtol=1e-4, atol=1e-4)
    for op, want in (("add", add_ref), ("min", min_ref)):
        got = ops[op].reshape(-1).cpu().numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32), err_msg=op)
    np.testing.assert_allclose(add_ref[:n], expect, rtol=1e-4, atol=1e-4)
    pg = alg.prepare(g, BLOCK_T, device=dev)
    res = alg.spmv(pg, x, EngineConfig(**TEST_KNOBS))
    assert int(res.stats.drops) == 0
    np.testing.assert_allclose(res.values, expect, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y, res.values, rtol=1e-4, atol=1e-4)
    log(f"# block: R-MAT-{BLOCK_SCALE} (V={n}, E={g.num_edges}) "
        f"spmv_block_ell (b={BLOCK_B}, S={bc.shape[1]}) within 1e-4 of the "
        f"dense oracle and of the engine's SpMV (T={BLOCK_T}, "
        f"{int(res.stats.rounds)} rounds); binned scatter_segments "
        f"({len(rounds)} rounds of {nb} bins x {SEG_CAP}) add and min "
        f"bitwise equal to np.add.at / np.minimum.at; {wall:.3f} s for the "
        f"kernels, launches {launches}; card {smi}")
    return launches


def phase_pagerank(dev, smi):
    t0 = time.perf_counter()
    g, pg = build_graph(PR_SCALE, MAIN_T, dev)
    want = ref.pagerank_ref(g, iters=PR_ITERS)
    t_build = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = alg.pagerank(pg, iters=PR_ITERS, cfg=SPMV_CFG)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = res.stats
    assert int(st.drops) == 0 and res.epochs == PR_ITERS
    assert int(st.launches) == 5 * int(st.rounds)
    np.testing.assert_allclose(res.values, want, rtol=2e-3, atol=1e-7)
    log(f"# PageRank R-MAT-{PR_SCALE} (V={g.num_vertices}, "
        f"E={g.num_edges}) over T={MAIN_T}, {PR_ITERS} iterations "
        f"(cap_updq {SPMV_CFG.cap_updq}): within rtol 2e-3 / atol 1e-7 of "
        f"the "
        f"oracle, drops 0; rounds {int(st.rounds)}, engine wall "
        f"{wall:.3f} s ({1e3 * wall / int(st.rounds):.3f} ms/round); host "
        f"build and oracle {t_build:.1f} s; card {smi}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="kernels,twin,main,block,pagerank",
                    help="comma-separated subset of kernels,twin,main,"
                         "block,pagerank (default: all)")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    smi = phase_device()
    dev = torch.device("cuda", 0)
    rows = phase_kernels(dev) if "kernels" in phases else {}
    if "twin" in phases:
        phase_twin(dev)
    bfs_l, spmv_l = phase_main(dev, smi) if "main" in phases else ({}, {})
    block_l = phase_block(dev, smi) if "block" in phases else {}
    if "pagerank" in phases:
        phase_pagerank(dev, smi)
    # each kernel's launches summed over the driven paths
    paths = (bfs_l, spmv_l, block_l)
    record = []
    for name, r in rows.items():
        source, replaces = KERNEL_ROWS[name]
        record.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(p.get(name, 0) for p in paths),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by="bytes",
            library_ms=r["library_ms"],
            **({"calls": r["calls"]} if "calls" in r else {})))
    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
