#!/usr/bin/env python3
"""Device times of the port's redesigned kernels at ``chip_smoke.py``'s
shapes, for one checkout, so that two checkouts, or other builds of a
kernel's source, compare in one call on one card.

    python3 tools/kernel_times.py {legs,turn,fold,fold_add,ssd,wkv6}
        [--src DIR]
        [--runs N] [--variants DIR[,DIR...]] [--spin CYCLES]
        [--short-spin CYCLES] [--paths BFS,SpMV,BFS-hbm,k-core,triangles]
        [--out FILE]

``--src`` is the root of a checkout (default: this one), e.g. a parent
unpacked by ``git archive`` under ``build/``.  The tool imports that
checkout's ``repro_torch`` and ``chip_smoke.py`` and takes the operands,
the checks and the ``Timer`` from them.  The kernels:

- ``legs``: the fused legs on the main paths (BFS and SpMV on R-MAT-22,
  BFS with the shard streamed, k-core on symmetrized R-MAT-20, triangles
  on symmetrized R-MAT-14, 64 tiles; ``--paths`` picks), each held against
  its plain stage by the checkout's ``legs_at_main_shapes`` over its first
  ``CHECK_ROUNDS`` rounds and timed on the operands of its last checked
  call;
- ``turn``: the two ``queue_push_pop`` calls of a main-path round
  (``MAIN_CFG`` over 64 tiles: the range queue with ``f_pop`` fresh rows,
  70 % valid, and the update queue with one empty fresh row) on
  ``queue_inputs``' operands from seed 0 (counts uniform in [0, cap], the
  first tiles empty, full and two below full), held against ``fifo_turn``
  by the checkout's ``turn_contract`` (the turned queue below its count),
  or whole for a checkout older than the live-row turn, which writes the
  whole queue;
- ``fold``: ``scatter_segments`` add and min at the T3 shape (64 bins of
  65,536 slots, 4,096 updates each; ``seg_inputs`` "mixed", seed 0),
  bitwise against ``binned_scatter``, with ``library_ms``: the same
  function by ``scatter_add`` / ``scatter_reduce(amin)`` over the slots
  plus a trash column, and ``copy_ms``: one ``copy_`` of the slots, the
  floor of a fold that writes a new array;
- ``fold_add``: the unfused T3 add fold ``fold_scatter_add`` at
  ``check_fold_scatter_add``'s timed operands (64 tiles of 65,536 slots,
  4,096 rows each; ``add_fold_inputs`` "path", seed 0), bitwise against
  ``scatter_body(..., "add")``, with ``library_ms`` (``scatter_add`` of
  the masked rows over the slots plus a trash column: float atomics, not
  the same bits) and ``copy_ms`` (one ``copy_`` of the slots);
- ``ssd``: ``ssd_kernel`` at zamba2-2.7b's prefill shape (``SSD_MAIN``,
  seed 0), within ``SSD_REL_TOL`` of ``ssd_chunked``'s largest magnitude
  (``rel_err``);
- ``wkv6``: ``wkv6_kernel`` at rwkv6-1.6b's prefill shape (``WKV_MAIN``,
  seed 0), within ``WKV_REL_TOL`` of ``wkv6_chunked``'s largest magnitude
  (``rel_err``).

Each call is timed by the checkout's Timer (CUDA events, the median of
``REPS`` launches, the L2 cache overwritten and the device then held by a
spin while the host enqueues the launch): ``ms`` and ``host_ms`` (the
wrapper's host time a call) under ``--spin`` cycles (default ~0.5 ms on
an H100, longer than any wrapper's host dispatch, so ``ms`` is device
time), ``short_spin_ms`` and ``short_host_ms`` under ``--short-spin``
(default ~0.1 ms: it adds what is left of a host dispatch that outlasts
it), ``host_loop_ms`` the median over HOST_BATCHES batches of HOST_REPS
calls back to back of the host time a call, and ``plain_ms``.
``--variants`` names directories that each hold another version of the
kernel's source, with copies of the headers it includes at the paths it
includes them by (the same C interface: e.g. a phase skipped or run
twice, another block size): every call is also timed with the library
built from each, after the same check, whose verdict (``ok``, and
``rel_err`` for the SSD) is recorded rather than asserted, so that a
variant that skips some work reads what that work costs.  ``--runs``
times every build that many times.  Prints one JSON line a call, build
and run, with the card's name and power limit (and appends them to
``--out``).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import importlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HOST_BATCHES, HOST_REPS = 7, 200
MODULES = {"legs": "repro_torch.kernels.engine.fused",
           "turn": "repro_torch.kernels.engine.kernel",
           "fold": "repro_torch.kernels.scatter_update.kernel",
           "fold_add": "repro_torch.kernels.engine.kernel",
           "ssd": "repro_torch.kernels.mamba2.kernel",
           "wkv6": "repro_torch.kernels.rwkv6.kernel"}
TIMES = ("ms", "host_ms", "short_spin_ms", "plain_ms")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel", choices=sorted(MODULES))
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--variants", default="")
    ap.add_argument("--spin", type=int, default=None)
    ap.add_argument("--short-spin", type=int, default=None)
    ap.add_argument("--paths", default="BFS,SpMV,BFS-hbm,k-core,triangles")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    root = Path(args.src).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    cs = importlib.import_module("chip_smoke")
    assert Path(cs.__file__).resolve().parent == root, cs.__file__
    import numpy as np
    import torch
    from repro_torch.kernels.cuda_build import CudaLibrary

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    spin = cs.SPIN_CYCLES if args.spin is None else args.spin
    short_spin = (cs.SHORT_SPIN_CYCLES if args.short_spin is None
                  else args.short_spin)
    timer = cs.Timer(dev)
    mod = importlib.import_module(MODULES[args.kernel])
    own = mod.LIBRARY
    libs = {"checkout": own}
    for d in filter(None, args.variants.split(",")):
        d = Path(d).resolve()
        libs[str(d)] = CudaLibrary(
            d / own.source.name, own.signatures,
            headers=tuple(d / os.path.relpath(h, own.source.parent)
                          for h in own.headers))
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc a build
        list(pool.map(lambda lib: lib.get(), libs.values()))

    @contextlib.contextmanager
    def built_from(lib):
        """The kernel's wrappers launching ``lib``."""
        launch = getattr(mod, "_launch", None)
        mod.LIBRARY = lib
        if launch is not None:
            mod._launch = lib.launch
        try:
            yield
        finally:
            mod.LIBRARY = own
            if launch is not None:
                mod._launch = launch

    def host_loop(fn):
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

    records = []

    def measure(fields, fn, plain, check):
        """Check ``fn`` with every build (``check()`` -> a dict with
        ``ok``; the checkout's must be ok), then time it."""
        for label, lib in libs.items():
            with built_from(lib):
                verdict = check()
                assert verdict["ok"] or label != "checkout", (fields, verdict)
                for run in range(args.runs):
                    long, short = (timer.reading(fn, s)
                                   for s in (spin, short_spin))
                    rec = dict(src=str(root), kernel_times=args.kernel,
                               build=label, run=run, card=card, spin=spin,
                               short_spin=short_spin, **fields, **verdict,
                               ms=long["ms"], host_ms=long["host_ms"],
                               short_spin_ms=short["ms"],
                               short_host_ms=short["host_ms"],
                               host_loop_ms=host_loop(fn))
                    if label == "checkout":
                        rec["plain_ms"] = timer.ms(plain)
                    records.append(rec)
                    print(json.dumps(rec), flush=True)

    t0 = time.perf_counter()
    if args.kernel == "legs":
        legs(cs, args.paths.split(","), dev, measure)
    elif args.kernel == "turn":
        K, cfg = cs.K, cs.MAIN_CFG
        contract = getattr(K, "turn_contract", lambda out: out)
        rng = np.random.default_rng(0)
        for label, cap, w, m, max_n, fresh in (
                ("range", cfg.cap_rangeq, 3, cfg.f_pop, cfg.r_pop, True),
                ("update", cfg.cap_updq, 2, 1, cfg.u_pop, False)):
            ops = cs.queue_inputs(rng, cs.MAIN_T, cap, w, m, max_n, dev,
                                  fresh)
            want = contract(K.fifo_turn(*ops, max_n))
            got = functools.partial(K.queue_push_pop, *ops, max_n)
            measure(dict(call=label, shape=[cs.MAIN_T, cap, w],
                         live_share=float(want[3].sum()) / (cs.MAIN_T * cap)),
                    got, functools.partial(K.fifo_turn, *ops, max_n),
                    lambda: dict(ok=all(torch.equal(a, b) for a, b in
                                        zip(contract(got()), want))))
    elif args.kernel == "fold":
        SEG = cs.SEG
        nb, b, cap = cs.MAIN_T, cs.MAIN_V_CHUNK, cs.SEG_CAP
        base, idx, vals = ops = cs.seg_inputs(np.random.default_rng(0), nb,
                                              b, cap, dev, "mixed")
        ext = torch.cat([base, base.new_full((nb, 1), cs.INF32)], dim=1)
        slot = torch.where(idx < 0, b, idx).to(torch.int64)
        library = {"add": functools.partial(ext.scatter_add, 1, slot, vals),
                   "min": functools.partial(ext.scatter_reduce, 1, slot,
                                            vals, "amin")}
        copy = torch.empty_like(base)
        copy_ms = timer.ms(lambda: copy.copy_(base))
        for op in ("add", "min"):
            want = SEG.binned_scatter(*ops, op).view(torch.int32)
            got = functools.partial(SEG.scatter_segments, *ops, op=op)
            measure(dict(call=op, shape=[nb, b, cap],
                         library_ms=timer.ms(library[op]), copy_ms=copy_ms),
                    got, functools.partial(SEG.binned_scatter, *ops, op),
                    lambda: dict(ok=torch.equal(got().view(torch.int32),
                                                want)))
    elif args.kernel == "fold_add":
        K, T, v = cs.K, cs.MAIN_T, cs.MAIN_V_CHUNK
        R = T * cs.SPMV_CFG.cap_route_update
        tgt, lidx, vals, valid = ops = cs.add_fold_inputs(
            np.random.default_rng(0), T, v, R, dev, "path")
        ext = torch.cat([tgt, tgt.new_zeros((T, 1))], dim=1)
        masked = torch.where(valid, vals, 0.0)
        lidx64 = lidx.to(torch.int64)
        copy = torch.empty_like(tgt)
        want = K.scatter_body(*ops, "add").view(torch.int32)
        got = functools.partial(K.fold_scatter_add, *ops)
        measure(dict(call="add", shape=[T, v, R],
                     library_ms=timer.ms(functools.partial(
                         ext.scatter_add, 1, lidx64, masked)),
                     copy_ms=timer.ms(lambda: copy.copy_(tgt))),
                got, functools.partial(K.scatter_body, *ops, "add"),
                lambda: dict(ok=torch.equal(got().view(torch.int32), want)))
    elif args.kernel == "wkv6":
        W6 = cs.W6
        B, S, H, Kh, chunk, w_fixed, state = cs.WKV_MAIN
        ops = cs.wkv_inputs(torch.Generator(device=dev).manual_seed(0), B,
                            S, H, Kh, w_fixed, state, dev)
        want = W6.wkv6_chunked(*ops, chunk=chunk)
        got = functools.partial(W6.wkv6_kernel, *ops, chunk=chunk)

        def check():
            err = max(cs.rel_to_max(a, w) for a, w in zip(got(), want))
            return dict(ok=err <= cs.WKV_REL_TOL, rel_err=err)

        measure(dict(call="rwkv6-1.6b prefill", shape=[B, S, H, Kh, chunk]),
                got, functools.partial(W6.wkv6_chunked, *ops, chunk=chunk),
                check)
    else:
        SSD = cs.SSD
        B, S, H, P, N, chunk, a_log, dt, state = cs.SSD_MAIN
        ops = cs.ssd_inputs(torch.Generator(device=dev).manual_seed(0), B,
                            S, H, P, N, a_log, dt, state, dev)
        want = SSD.ssd_chunked(*ops, chunk=chunk)
        got = functools.partial(SSD.ssd_kernel, *ops, chunk=chunk)

        def check():
            err = max(cs.rel_to_max(a, w) for a, w in zip(got(), want))
            return dict(ok=err <= cs.SSD_REL_TOL, rel_err=err)

        measure(dict(call="zamba2-2.7b prefill",
                     shape=[B, S, H, P, N, chunk]),
                got, functools.partial(SSD.ssd_chunked, *ops, chunk=chunk),
                check)
    if args.out:
        with open(args.out, "a") as f:
            f.write("".join(json.dumps(r) + "\n" for r in records))
    print(f"# kernel_times {args.kernel}: {len(records)} records in "
          f"{time.perf_counter() - t0:.1f} s from {root}")


def legs(cs, want, dev, measure):
    """Drive the main paths in ``want`` through the checkout's
    ``legs_at_main_shapes``, its ``time_legs`` replaced by ``measure`` on
    each leg's last checked call."""
    import numpy as np

    class Untimed:
        """The checkout's Timer, replaced: its times are ``measure``'s."""

        def ms(self, fn):
            return float("nan")

        def reading(self, fn, spin=None):
            return dict(ms=float("nan"), host_ms=float("nan"))

    checkout_time_legs = cs.time_legs

    def time_legs(chk, _timer, where):
        calls = checkout_time_legs(chk, Untimed(), where)
        for c in calls:
            name = c["kernel"]
            real, tmpl, plain, ops, _ = chk.last[name]
            leg = functools.partial(real, tmpl, plain, *ops)

            def check():
                try:
                    cs.check_leg(name, tmpl, ops, leg(), plain(*ops), where)
                    return dict(ok=True)
                except AssertionError as e:
                    return dict(ok=False, why=str(e)[:300])

            measure({k: v for k, v in c.items() if k not in TIMES
                     and not isinstance(v, np.ndarray)},
                    leg, functools.partial(plain, *ops), check)
        return calls

    cs.time_legs = time_legs
    alg, timer = cs.alg, Untimed()
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
                cs.legs_at_main_shapes(label, run, cfg, timer)
        del pg
    if "k-core" in want:
        n, src, dst, val = cs.rmat_edges(cs.KCORE_SCALE, edge_factor=10,
                                         seed=1)
        gs = alg.symmetrize(cs.CSRGraph.from_edges(n, src, dst, val))
        pgs = alg.prepare(gs, cs.MAIN_T, device=dev)
        cs.legs_at_main_shapes(
            "k-core", lambda c: alg.kcore(pgs, cs.KCORE_K, c), cs.KCORE_CFG,
            timer, cs.KCORE_SCALE, ("fused_leg1",))
        del pgs
    if "triangles" in want:
        n, src, dst, val = cs.rmat_edges(cs.TRI_SCALE, edge_factor=10,
                                         seed=1)
        gs = alg.symmetrize(cs.CSRGraph.from_edges(n, src, dst, val))
        pgt = alg.prepare_triangles(gs, cs.MAIN_T, device=dev)
        cs.legs_at_main_shapes(
            "triangles", lambda c: alg.triangles(pgt, c), cs.TRI_CFG, timer,
            cs.TRI_SCALE, ())


if __name__ == "__main__":
    main()
