#!/usr/bin/env python3
"""Device times of the fused legs at the main paths' shapes, for one
checkout, so that two checkouts compare in one call on one card.

    python3 tools/leg_times.py [--src DIR] [--spin CYCLES]
        [--short-spin CYCLES] [--paths BFS,SpMV,BFS-hbm,k-core,triangles]
        [--variants DIR[,DIR...]] [--out FILE]

``--src`` is the root of a checkout (default: this one), e.g. a parent
unpacked by ``git archive`` under ``build/``.  The tool imports that
checkout's ``chip_smoke.py`` and drives its ``legs_at_main_shapes`` on the
main paths (BFS and SpMV on R-MAT-22, BFS with the shard streamed, k-core
on symmetrized R-MAT-20, triangles on symmetrized R-MAT-14, 64 tiles):
the first ``CHECK_ROUNDS`` rounds, each leg held against its plain stage
by that checkout's checks, with that checkout's bounds.  Then each leg is
timed on the operands of its last checked call by this tool, the same way
for every checkout: the CUDA-event median of REPS launches, the L2 cache
overwritten before each and the device then held by a spin while the host
enqueues the launch.  The kernel is timed under ``--spin`` clock cycles
(default 1,000,000, ~0.5 ms on an H100: longer than any leg wrapper's
host dispatch, so ``ms`` is device time) and under ``--short-spin``
(default 200,000, ~0.1 ms: ``short_spin_ms`` adds what is left of a host
dispatch that outlasts it); ``host_ms`` and ``short_host_ms`` are the
median host times of the wrapper's calls under each, ``host_loop_ms`` the
median over HOST_BATCHES batches of HOST_REPS calls back to back of the
host time a call (the device keeps up, so this is the wrapper's own host
work, with no spin between calls), and ``plain_ms`` the plain stage's
time under the long spin.  ``--variants`` names directories
that each hold another version of the checkout's ``csrc/fused_legs.cu``
beside copies of its headers (the same launchers, e.g. a leg with one of
its phases run twice, to read what that phase costs): each leg is then
also timed with the library built from each of them, on the same operands,
after its outputs are held against the plain stage as the checkout's
are (``variant`` names the directory).  Prints one JSON line a leg, call
and build (and appends them to ``--out``).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import threading
import time
from pathlib import Path


HOST_BATCHES, HOST_REPS = 7, 200


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--spin", type=int, default=1_000_000)
    ap.add_argument("--short-spin", type=int, default=200_000)
    ap.add_argument("--paths", default="BFS,SpMV,BFS-hbm,k-core,triangles")
    ap.add_argument("--variants", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    root = Path(args.src).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    cs = importlib.import_module("chip_smoke")
    assert Path(cs.__file__).resolve().parent == root, cs.__file__
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("leg_times: no CUDA device")
    dev = torch.device("cuda", 0)
    flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=dev)

    def reading(fn, spin):
        """(median device ms, median host ms) of ``fn`` over cs.REPS
        launches after 3 untimed, each after the L2 overwrite and a spin
        of ``spin`` cycles."""
        for _ in range(3):
            fn()
        times, host = [], []
        for _ in range(cs.REPS):
            flush.fill_(1)
            torch.cuda._sleep(spin)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            h0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - h0) * 1e3)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times)), float(np.median(host))

    def host_loop(fn):
        """Median host ms a call of ``fn`` over HOST_BATCHES batches of
        HOST_REPS calls back to back."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        per = []
        for _ in range(HOST_BATCHES):
            h0 = time.perf_counter()
            for _ in range(HOST_REPS):
                fn()
            per.append((time.perf_counter() - h0) * 1e3 / HOST_REPS)
            torch.cuda.synchronize()
        return float(np.median(per))

    class Untimed:
        """The checkout's Timer, replaced: its times are this tool's."""

        def ms(self, fn):
            return float("nan")

        def reading(self, fn, spin=None):
            return dict(ms=float("nan"), host_ms=float("nan"))

    from repro_torch.kernels.cuda_build import CudaLibrary
    F = cs.F
    variants = {}  # directory: the fused-leg library built from it
    for d in filter(None, args.variants.split(",")):
        d = Path(d).resolve()
        variants[str(d)] = CudaLibrary(
            d / F.SOURCE.name, F.LIBRARY.signatures,
            headers=tuple(d / h.name for h in F.LIBRARY.headers))
    builds = [threading.Thread(target=lib.get) for lib in variants.values()]
    for b in builds:  # one nvcc each, all started together
        b.start()
    for b in builds:
        b.join()
    checkout_time_legs = cs.time_legs

    def time_leg(c, leg):
        c["ms"], c["host_ms"] = reading(leg, args.spin)
        c["short_spin_ms"], c["short_host_ms"] = reading(leg,
                                                         args.short_spin)

    def time_legs(chk, _timer, where):
        calls = checkout_time_legs(chk, Untimed(), where)
        for c in list(calls):
            name = c["kernel"]
            real, tmpl, plain, ops, _ = chk.last[name]
            leg = lambda: real(tmpl, plain, *ops)  # noqa: E731
            time_leg(c, leg)
            c["host_loop_ms"] = host_loop(leg)
            c["plain_ms"] = reading(lambda: plain(*ops), args.spin)[0]
            for d, lib in variants.items():
                F._launch = lib.launch
                try:
                    cs.check_leg(name, tmpl, ops, leg(), plain(*ops),
                                 f"{d} {name}")
                    v = dict(c, variant=d)
                    time_leg(v, leg)
                    calls.append(v)
                finally:
                    F._launch = F.LIBRARY.launch
        return calls

    cs.time_legs = time_legs
    timer = Untimed()
    alg = cs.alg
    want = args.paths.split(",")
    calls = []
    t0 = time.perf_counter()
    if {"BFS", "SpMV", "BFS-hbm"} & set(want):
        g, pg = cs.build_graph(cs.MAIN_SCALE, cs.MAIN_T, dev)
        x = cs.spmv_x(g.num_vertices)
        for label, run, cfg in (
                ("BFS", lambda c: alg.bfs(pg, cs.MAIN_ROOT, c),
                 cs.MAIN_FUSED),
                ("SpMV", lambda c: alg.spmv(pg, x, c), cs.SPMV_FUSED),
                ("BFS-hbm", lambda c: alg.bfs(pg, cs.MAIN_ROOT, c),
                 cs.HBM_CFG)):
            if label in want:
                calls += cs.legs_at_main_shapes(label, run, cfg, timer)
        del pg
    if "k-core" in want:
        n, src, dst, val = cs.rmat_edges(cs.KCORE_SCALE, edge_factor=10,
                                         seed=1)
        gs = alg.symmetrize(cs.CSRGraph.from_edges(n, src, dst, val))
        pgs = alg.prepare(gs, cs.MAIN_T, device=dev)
        calls += cs.legs_at_main_shapes(
            "k-core", lambda c: alg.kcore(pgs, cs.KCORE_K, c), cs.KCORE_CFG,
            timer, cs.KCORE_SCALE, ("fused_leg1",))
        del pgs
    if "triangles" in want:
        n, src, dst, val = cs.rmat_edges(cs.TRI_SCALE, edge_factor=10,
                                         seed=1)
        gs = alg.symmetrize(cs.CSRGraph.from_edges(n, src, dst, val))
        pgt = alg.prepare_triangles(gs, cs.MAIN_T, device=dev)
        calls += cs.legs_at_main_shapes(
            "triangles", lambda c: alg.triangles(pgt, c), cs.TRI_CFG, timer,
            cs.TRI_SCALE, ())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    lines = [json.dumps(dict(src=str(root), spin=args.spin,
                             short_spin=args.short_spin, card=card,
                             **{k: v for k, v in c.items()
                                if not isinstance(v, np.ndarray)}))
             for c in calls]
    for line in lines:
        print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    print(f"# leg_times: {len(calls)} legs timed in "
          f"{time.perf_counter() - t0:.1f} s from {root}")


if __name__ == "__main__":
    main()
