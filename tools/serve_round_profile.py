#!/usr/bin/env python3
"""Device time by kernel of one shared round of the serving lanes.

    python3 tools/serve_round_profile.py [--seed 0] [--at 300] [--rounds 10]

Builds ``chip_smoke.py``'s phase ``serve`` (a) batch on the main path
(R-MAT-22 over 64 tiles, ``MAIN_FUSED``: the main root, five sources
drawn from ``--seed``, the main root again and a padding lane) and the
solo run of the main root, runs each ``--at`` rounds unprofiled and 100
more timed, then ``--rounds`` under ``torch.profiler``.  Prints, for each,
the wall ms a round of the timed rounds, the device ms a round, the
kernels, copies and PyTorch operators a round, and the top kernels by
device time a round.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch import serve as SERVE  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core.program import BFS, as_program  # noqa: E402
from tools.port_round_profile import device_us  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--at", type=int, default=300)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    smi = C.phase_device()[0]
    t0 = time.perf_counter()
    g, pg = C.build_graph(C.MAIN_SCALE, C.MAIN_T, "cuda")
    print(f"# R-MAT-{C.MAIN_SCALE} over T={C.MAIN_T}: host build "
          f"{time.perf_counter() - t0:.1f} s; card {smi}")
    lanes = ([C.MAIN_ROOT] + C.serve_sources(g, args.seed, C.SERVE_RANDOM,
                                             [C.MAIN_ROOT])
             + [C.MAIN_ROOT, -1])
    prog = as_program(BFS)
    shard = E.GraphShard(pg.ptr_start, pg.deg, pg.edge_dst, pg.edge_val)

    def upto(carry, n):
        return SERVE.local_lanes_segment(
            prog, dataclasses.replace(C.MAIN_FUSED, max_rounds=n), pg.T,
            pg.e_chunk, pg.v_chunk, shard, carry, stop_on_finish=False)

    for label, sources in ((f"B={len(lanes)} lanes {lanes}", lanes),
                           ("solo", [C.MAIN_ROOT])):
        value, frontier = SERVE.batch_min_state(pg, sources)
        carry = SERVE.local_lanes_call(
            prog, dataclasses.replace(C.MAIN_FUSED, max_rounds=args.at),
            pg.T, pg.e_chunk, pg.v_chunk, shard, value, frontier)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry = upto(carry, args.at + 100)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 10
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            carry = upto(carry, args.at + 100 + args.rounds)
            torch.cuda.synchronize()
        total, by_name, counts = device_us(prof)
        n = args.rounds
        print(f"# {label}: wall {wall:.3f} ms a round (rounds {args.at}.."
              f"{args.at + 99}); device {total / n / 1e3:.3f} ms a round, "
              f"{counts['kernels'] / n:.1f} kernels, "
              f"{counts['copies'] / n:.1f} copies, "
              f"{counts['aten_ops'] / n:.1f} operators")
        for k, us in sorted(by_name.items(), key=lambda kv: -kv[1])[
                :args.top]:
            print(f"#   {us / n:9.1f} us  {k[:140]}")


if __name__ == "__main__":
    main()
