#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the Dalorex engine on one GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. device and build — the card's name and power limit (nvidia-smi), and
   the build of the Hopper kernels from ``src/repro_torch/kernels/engine/
   csrc/engine_kernels.cu`` (nvcc, sm_90a, at first use);
2. kernels — each of the four kernels against its plain PyTorch version on
   the same CUDA tensors, at the main path's shapes plus the edge cases of
   the CPU sweeps: bitwise equal on every output element.  Prints each
   kernel's time (CUDA events, median of 25 launches with the L2 cache
   flushed before each), its plain version's time, its bound (bytes moved
   over 3.35 TB/s) and, where one PyTorch call computes the same
   function, that call's time;
3. engine twin — BFS at R-MAT scale 10 over 16 tiles, ``backend="torch"``
   against ``backend="kernels"``: values and Stats bitwise equal (but
   ``launches``), and equal to the oracle;
4. the main path — one BFS query from vertex 0 (the highest out-degree)
   over R-MAT-22 (edge factor 10, seed 1) on 64 tiles with
   ``EngineConfig(cap_updq=262144)``: hop counts equal to the oracle,
   no drops, five kernel calls per round, every kernel's CUDA launch
   counter > 0.

The last lines are the kernels' JSON record, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or away from
the repository, the script fails before printing any result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core.engine import EngineConfig  # noqa: E402
from repro_torch.core.graph import CSRGraph, rmat_edges  # noqa: E402
from repro_torch.core.reference import bfs_ref  # noqa: E402
from repro_torch.kernels.engine import kernel as K  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
SOURCE = "src/repro_torch/kernels/engine/csrc/engine_kernels.cu"
TPU_KERNEL = "src/repro/kernels/engine/kernel.py"
REPLACES = {"frontier_pop": f"{TPU_KERNEL}:371",
            "queue_push_pop": f"{TPU_KERNEL}:417",
            "edge_scan_gather": f"{TPU_KERNEL}:473",
            "fold_scatter": f"{TPU_KERNEL}:557"}

# Main path: R-MAT-22 over T=64 tiles (v_chunk, e_chunk of its partition).
# The update (spill) queue holds 262144 entries: its one-round burst bound
# (EngineConfig.min_caps, 32832 here, rounded up to 65536) drops updates on
# this graph, because tiles whose updates converge on a few hot owners keep
# spilling faster than the 64-entry replay drains; this run's peak
# occupancy is 169369 entries (PERF.md).
MAIN_SCALE, MAIN_T, MAIN_ROOT = 22, 64, 0
MAIN_V_CHUNK, MAIN_E_CHUNK = 65536, 642283
MAIN_CFG = EngineConfig(cap_updq=262144)
INF32 = float(np.finfo(np.float32).max)
REPS = 25


def log(*a):
    print(*a, flush=True)


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
    t0 = time.perf_counter()
    K.LIBRARY.get()
    log(f"# kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {K.LIBRARY.build_seconds:.2f} s) -> {K.LIBRARY.path}")
    for line in K.LIBRARY.build_log.splitlines():
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


def phase_kernels(dev):
    rng = np.random.default_rng(0)
    timer = Timer(dev)
    rows = {}
    for name, check in (("frontier_pop", check_frontier_pop),
                        ("queue_push_pop", check_queue_push_pop),
                        ("edge_scan_gather", check_edge_scan_gather),
                        ("fold_scatter", check_fold_scatter)):
        r = check(rng, dev, timer)
        torch.cuda.synchronize()
        rows[name] = r
        lib = "n/a" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        log(f"# kernel {name}: bitwise equal to its plain version; "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms (bytes), library {lib}")
        for c in r.get("calls", []):
            log(f"#   {c['call']} channel {c['shape']}: kernel "
                f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, bound "
                f"{c['bound_ms']:.4f} ms")
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


def phase_twin(dev):
    g, pg = build_graph(10, 16, dev)
    root = int(np.argmax(g.ptr[1:] - g.ptr[:-1]))
    small = dict(f_pop=8, r_pop=8, u_pop=16, max_t2=8, cap_route_range=8,
                 cap_route_update=32, cap_rangeq=128, cap_updq=4096)
    oracle = bfs_ref(g, root)
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


def phase_main(dev):
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
    oracle = bfs_ref(g, MAIN_ROOT)
    log(f"# oracle: {time.perf_counter() - t0:.1f} s, "
        f"{int(np.isfinite(oracle).sum())} reachable vertices")

    for k in K.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = alg.bfs(pg, MAIN_ROOT, MAIN_CFG)
    torch.cuda.synchronize()
    t_engine = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in K.KERNELS}

    st = res.stats
    rounds = int(st.rounds)
    np.testing.assert_array_equal(res.values, oracle)
    assert int(st.drops) == 0, int(st.drops)
    assert int(st.launches) == 5 * rounds, (int(st.launches), rounds)
    want = {"frontier_pop": rounds, "queue_push_pop": 2 * rounds,
            "edge_scan_gather": rounds, "fold_scatter": rounds}
    assert launches == want, (launches, want)
    edges = int(st.edges_scanned)
    log(f"# main path BFS: equal to the oracle, drops 0; rounds {rounds}, "
        f"engine wall {t_engine:.3f} s ({1e3 * t_engine / rounds:.3f} "
        f"ms/round), edges scanned {edges}, "
        f"{edges / t_engine / 1e6:.3f} M traversed edges/s, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB, "
        f"kernel launches {launches}")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="kernels,twin,main",
                    help="comma-separated subset of kernels,twin,main "
                         "(default: all)")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    smi = phase_device()
    dev = torch.device("cuda", 0)
    rows = phase_kernels(dev) if "kernels" in phases else {}
    if "twin" in phases:
        phase_twin(dev)
    launches = phase_main(dev) if "main" in phases else {}
    record = [dict(name=name, route="cuda", source=SOURCE,
                   replaces=REPLACES[name],
                   launches=launches.get(name, 0),
                   max_abs_err=r["max_abs_err"], ms=r["ms"],
                   plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                   bound_by="bytes", library_ms=r["library_ms"],
                   **({"calls": r["calls"]} if "calls" in r else {}))
              for name, r in rows.items()]
    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
