#!/usr/bin/env python3
"""Round-level profile of the PyTorch/CUDA port's main path on one GPU.

    python3 tools/port_round_profile.py [--app bfs|spmv|kcore|triangles]
        [--scale 22] [--k 16] [--tiles 64] [--cap-updq 65536 262144]
        [--fuse 0 1 1 0] [--edge-space vmem hbm] [--max-rounds N]
        [--profile-at 3000] [--profile-rounds 50] [--scan-at N]

Builds R-MAT-``scale`` (edge factor 10, seed 1; symmetrized for k-core
and triangles, and laid out by ``prepare_triangles`` for triangles) over
``tiles`` tiles and runs the app once per ``--cap-updq`` value,
``--edge-space`` entry and ``--fuse`` entry, in the order given
(``--fuse 0 1 1 0`` alternates unfused and fused runs on one card) — one
BFS query from vertex 0, one SpMV ``y[dst] += val * x[src]`` with
``chip_smoke.py``'s main-path ``x``, k-core peeling at ``--k``, or
triangle counting (queues sized by ``sized_cfg``) — driving the engine
round by round (the loop of ``run_engine``, async mode) to record what the
Stats do not: the peak occupancy of each channel queue, and — over
``--profile-rounds`` rounds starting at ``--profile-at`` — a
``torch.profiler`` breakdown of device time by kernel.  Prints, per run:
rounds, drops, whether the result matches the oracle (BFS hop counts,
k-core membership and triangle counts equal; SpMV within the reference's
rtol 2e-4 / atol 1e-4 plus the oracle's float32 error limit, with the
count of vertices outside the bare tolerance; not checked when
``--max-rounds`` stops the run early), wall
time per round (unprofiled rounds only), device time per round, the
device busy share (device time per round over unprofiled wall time per
round), and per profiled round the CUDA kernels launched, the copies and
memsets, and the PyTorch operators the host dispatched (top-level
``aten::`` calls), with the top kernels.  With ``--scan-at N``, an
unfused run also reports the T2 scan (``edge_scan_gather``, or
``edge_scan_stream`` with ``--edge-space hbm``) of its round N (counted
from 0, as ``--profile-at``): its shape, the share of valid messages, the
live-lane share (lanes below a valid message's length: the lanes whose
``nb`` and ``w`` the kernel writes, in groups of four) and the ``jvalid``
share.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import spmv_x  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core.comm import LocalComm  # noqa: E402
from repro_torch.core.engine import (EngineConfig, GraphShard,  # noqa: E402
                                     Stats, init_state, make_round)
from repro_torch.core.graph import CSRGraph, rmat_edges  # noqa: E402
from repro_torch.core.program import (BFS, INF, SPMV, TRIANGLES,  # noqa
                                      as_program, kcore_program, sized_cfg)
from repro_torch.core.reference import (bfs_ref, kcore_ref,  # noqa
                                        spmv_f32_bound, spmv_ref,
                                        triangles_wedge_ref)
from repro_torch.noc import make_network  # noqa: E402


def device_us(prof) -> tuple[float, dict, dict]:
    """Total device time (µs) of the profiled window, its split by kernel
    name, and counts: CUDA kernels, copies and memsets on the device, and
    the top-level PyTorch operators the host dispatched.  Kernels of one
    stream do not overlap, so the sum is the time the device was busy."""
    total, by_name = 0.0, {}
    counts = dict(kernels=0, copies=0, aten_ops=0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            parent = e.cpu_parent
            if e.name.startswith("aten::") and not (
                    parent is not None and parent.name.startswith("aten::")):
                counts["aten_ops"] += 1
            continue
        us = e.time_range.elapsed_us()
        total += us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        copy = e.name.startswith(("Memcpy", "Memset"))
        counts["copies" if copy else "kernels"] += 1
    return total, by_name, counts


def scan_share(args, out) -> str:
    """The shape and lane shares of one T2 scan call."""
    start, stop, rv, max_t2 = args[2], args[3], args[4], args[5]
    length = torch.where(rv, stop - start, 0)
    j = torch.arange(max_t2, device=start.device, dtype=torch.int32)
    live = j < length[:, :, None]
    n = live.numel()
    return (f"shape {list(out[0].shape)}, valid messages "
            f"{float(rv.float().mean()):.6f}, live lanes "
            f"{int(live.sum())} (share {int(live.sum()) / n:.6f}), jvalid "
            f"share {int(out[2].sum()) / n:.6f}")


def run(pg, oracle, cap_updq: int, space: str, fuse: bool, args):
    from repro_torch.core import program as PROG
    name = "edge_scan_stream" if space == "hbm" else "edge_scan_gather"
    real_scan, scans, seen = getattr(PROG, name), [0], []

    def spy(*a):
        out = real_scan(*a)
        if scans[0] == args.scan_at:
            seen.append((a, out))  # read after the run
        scans[0] += 1
        return out

    setattr(PROG, name, spy)
    try:
        run_rounds(pg, oracle, cap_updq, space, fuse, args)
    finally:
        setattr(PROG, name, real_scan)
    for a, out in seen:
        print(f"  {name} at round {args.scan_at}: {scan_share(a, out)}",
              flush=True)


def run_rounds(pg, oracle, cap_updq: int, space: str, fuse: bool, args):
    dev = pg.device
    T = pg.T
    cfg = EngineConfig(cap_updq=cap_updq, fuse=fuse, edge_space=space,
                       max_rounds=args.max_rounds)
    comm = LocalComm(T, dev)
    shard = GraphShard(pg.ptr_start, pg.deg, pg.edge_dst, pg.edge_val)
    acc = None
    if args.app == "bfs":
        prog = as_program(BFS)
        value, frontier = alg.init_min_state(pg, [0])
    elif args.app == "spmv":
        prog = as_program(SPMV)
        value, frontier = alg.init_add_state(pg, spmv_x(pg.num_vertices))
    elif args.app == "kcore":
        prog = kcore_program(args.k)
        value, frontier, acc = alg.init_kcore_state(pg, args.k)
    else:
        prog = TRIANGLES
        cfg = sized_cfg(cfg, prog, T)
        value, frontier = alg.init_triangles_state(pg)
    st = init_state(comm, cfg, pg.v_chunk, value, frontier, prog, acc)
    net = make_network(cfg, T)
    rnd = make_round(comm, net, cfg, prog, pg.e_chunk, pg.v_chunk, shard)
    stats = Stats.zero(net.num_links, net.max_hops, len(prog.channels),
                       net.max_die_crossings, dev)
    zf = torch.zeros((), dtype=torch.float32, device=dev)
    kcomp = (zf, zf)
    peak = [torch.zeros(T, dtype=torch.int32, device=dev)
            for _ in prog.channels]
    prof_dev, prof_split, prof_count, prof_rounds = 0.0, {}, {}, 0
    r, pending, wall = 0, 1, 0.0
    while pending > 0 and r < cfg.max_rounds:
        profiled = args.profile_at <= r < args.profile_at + \
            args.profile_rounds
        if profiled and r == args.profile_at:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(args.profile_rounds):
                    st, stats, kcomp, p = rnd(st, stats, kcomp)
                    for i, q in enumerate(st.queues):
                        peak[i] = torch.maximum(peak[i], q.count)
                    pending = int(p)
                    r += 1
                    prof_rounds += 1
                    if pending == 0:
                        break
            prof_dev, prof_split, prof_count = device_us(prof)
            continue
        t0 = time.perf_counter()
        st, stats, kcomp, p = rnd(st, stats, kcomp)
        pending = int(p)
        wall += time.perf_counter() - t0
        for i, q in enumerate(st.queues):
            peak[i] = torch.maximum(peak[i], q.count)
        r += 1
        if r % args.every == 0:
            print(f"#   round {r}: pending {pending}, drops "
                  f"{int(stats.drops)}, edges {int(stats.edges_scanned)}, "
                  f"{1e3 * wall / (r - prof_rounds):.3f} ms/round",
                  flush=True)
    if pending > 0:
        ok = "not checked (stopped at --max-rounds)"
    elif args.app == "bfs":
        vals = alg.to_original(pg, st.value).astype(np.float64)
        vals[vals >= np.float32(INF)] = np.inf
        ok = bool(np.array_equal(vals, oracle))
    elif args.app == "kcore":
        ok = bool(np.array_equal(
            (alg.to_original(pg, st.acc) == 0.0).astype(np.int64), oracle))
    elif args.app == "triangles":
        ok = bool(np.array_equal(
            alg.to_original(pg, st.acc).astype(np.int64), oracle))
    else:
        vals = alg.to_original(pg, st.acc).astype(np.float64)
        want, bound = oracle
        err = np.abs(vals - want)
        tol = 2e-4 * np.abs(want) + 1e-4
        ok = bool((err <= tol + bound).all())
        print(f"  spmv: {int((err > tol).sum())} vertices outside rtol "
              f"2e-4 / atol 1e-4, max abs err {err.max():.3e}, max err / "
              f"(tolerance + float32 limit) {(err / (tol + bound)).max():.3e}")
    ms_round = 1e3 * wall / max(r - prof_rounds, 1)
    print(f"{args.app} cap_updq {cfg.cap_updq} edge_space {space} fuse "
          f"{fuse}: rounds {r}, drops "
          f"{int(stats.drops)}, matches the oracle {ok}, edges "
          f"scanned {int(stats.edges_scanned)}, peak queue occupancy "
          f"{[int(p.max()) for p in peak]} (tile "
          f"{[int(p.argmax()) for p in peak]}), wall {ms_round:.3f} "
          f"ms/round over {r - prof_rounds} unprofiled rounds", flush=True)
    if prof_rounds:
        dev_ms = prof_dev / 1e3 / prof_rounds
        print(f"  profile of rounds {args.profile_at}.."
              f"{args.profile_at + prof_rounds - 1}: device {dev_ms:.3f} "
              f"ms/round, busy share {dev_ms / ms_round:.3f}; per round "
              + ", ".join(f"{k} {v / prof_rounds:.1f}"
                          for k, v in prof_count.items()), flush=True)
        for name, us in sorted(prof_split.items(), key=lambda kv: -kv[1])[
                :args.top]:
            print(f"    {us / 1e3 / prof_rounds:8.4f} ms/round "
                  f"{100 * us / prof_dev:5.1f}%  {name[:100]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--app", choices=("bfs", "spmv", "kcore", "triangles"),
                    default="bfs")
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--k", type=int, default=16, help="k-core's k")
    ap.add_argument("--tiles", type=int, default=64)
    ap.add_argument("--cap-updq", type=int, nargs="+", default=[262144])
    ap.add_argument("--fuse", type=int, nargs="+", choices=(0, 1),
                    default=[0], help="one run per entry, in order")
    ap.add_argument("--edge-space", choices=("vmem", "hbm"), nargs="+",
                    default=["vmem"], help="one run per entry, in order")
    ap.add_argument("--max-rounds", type=int, default=100_000)
    ap.add_argument("--profile-at", type=int, default=3000)
    ap.add_argument("--profile-rounds", type=int, default=50)
    ap.add_argument("--every", type=int, default=5000)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--scan-at", type=int, default=-1,
                    help="report the unfused T2 scan of this round")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("port_round_profile: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    t0 = time.perf_counter()
    n, src, dst, val = rmat_edges(args.scale, edge_factor=10, seed=1)
    g = CSRGraph.from_edges(n, src, dst, val)
    if args.app in ("kcore", "triangles"):
        g = alg.symmetrize(g)
    prep = alg.prepare_triangles if args.app == "triangles" else alg.prepare
    pg = prep(g, args.tiles, device="cuda")
    if args.app == "bfs":
        oracle = bfs_ref(g, 0)
    elif args.app == "kcore":
        oracle = kcore_ref(g, args.k)
    elif args.app == "triangles":
        oracle = triangles_wedge_ref(g, key=pg.place)
    else:
        x = spmv_x(n).astype(np.float64)
        oracle = spmv_ref(g, x), spmv_f32_bound(g, x)
    print(f"R-MAT-{args.scale} T={args.tiles}: V={g.num_vertices} "
          f"E={g.num_edges}, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for cap in args.cap_updq:
        for space in args.edge_space:
            for fuse in args.fuse:
                run(pg, oracle, cap, space, bool(fuse), args)


if __name__ == "__main__":
    main()
