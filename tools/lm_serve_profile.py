#!/usr/bin/env python3
"""Where the time of the port's LM serving path goes, on one GPU.

    python3 tools/lm_serve_profile.py
        [--arch granite-3-2b|rwkv6-1.6b|zamba2-2.7b] [--dtype bfloat16]
        [--batch 4] [--prompt-len 2048] [--steps 8] [--kernels 1 0 0 1]
        [--top 8]

Builds the arch at full width and depth with random weights (seed 0, as
``chip_smoke.py`` phases ``lm``, ``rwkv`` and ``zamba``) and, once per
``--kernels`` entry in the order given (``1`` the prefill's kernels:
flash attention, WKV6, or the SSD scan and flash attention; ``0`` their
plain versions; ``1 0 0 1`` alternates them on one card),
runs a prefill of ``--batch`` random prompts
of ``--prompt-len`` tokens and ``--steps`` greedy ``serve_step``s, each
timed unprofiled (CUDA-synchronized wall clock), then the same again under
``torch.profiler``.  Prints, for the prefill and per decode step: wall
ms, device ms (the sum of the kernels', copies' and memsets' device time:
one stream, so they do not overlap), the device busy share (device over
unprofiled wall), the CUDA kernels launched and the top-level PyTorch
operators the host dispatched, and the kernels with the most device time.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from port_round_profile import device_us  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa
from repro_torch.kernels.mamba2 import ssd_kernel  # noqa: E402
from repro_torch.kernels.rwkv6 import wkv6_kernel  # noqa: E402
from repro_torch.models import transformer as TFM  # noqa: E402


def timed(fn, n: int = 1) -> float:
    """Wall ms per call of ``fn`` over ``n`` calls, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def profiled(fn, n: int = 1):
    """Device ms per call, split and counts per call, of ``n`` calls."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total, by_name, counts = device_us(prof)
    return (total / 1e3 / n, {k: v / 1e3 / n for k, v in by_name.items()},
            {k: v / n for k, v in counts.items()})


def report(what, wall_ms, dev_ms, split, counts, top):
    print(f"  {what}: wall {wall_ms:.3f} ms, device {dev_ms:.3f} ms, busy "
          f"share {dev_ms / wall_ms:.3f}; "
          + ", ".join(f"{k} {v:.1f}" for k, v in counts.items()),
          flush=True)
    for name, ms in sorted(split.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {ms:9.4f} ms {100 * ms / dev_ms:5.1f}%  {name[:100]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--kernels", type=int, nargs="+", default=[1, 0, 0, 1])
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lm_serve_profile: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config(args.arch), dtype=args.dtype)
    B, P, G = args.batch, args.prompt_len, args.steps
    params = TFM.init_params(torch.Generator(device=dev).manual_seed(0),
                             cfg, dev)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), dtype=torch.int32,
                            device=dev, generator=torch.Generator(
                                device=dev).manual_seed(1))
    print(f"# {cfg.name} {args.dtype}, {cfg.num_layers} layers, B {B}, "
          f"prompt {P}, {G} decode steps; card {smi}", flush=True)
    with torch.inference_mode():
        for use in args.kernels:
            use = bool(use)
            state = {}

            def do_prefill():
                cache = TFM.init_cache(cfg, B, P + 2 * G, dev)
                _, state["cache"] = TFM.prefill(
                    params, cfg, cache, {"tokens": prompts},
                    use_kernels=use)
                state["tok"] = prompts[:, -1:]

            def do_step():
                nxt, state["cache"] = TFM.serve_step(
                    params, cfg, state["cache"], state["tok"])
                state["tok"] = nxt[:, None]

            kernels = (flash_attention, wkv6_kernel, ssd_kernel)
            for k in kernels:
                k.launches = 0
            wall = timed(do_prefill)
            launches = {k.__name__: k.launches for k in kernels}
            dev_ms, split, counts = profiled(do_prefill)
            print(f"use_kernels={use}: kernel launches a prefill "
                  f"{launches}", flush=True)
            report("prefill", wall, dev_ms, split, counts, args.top)
            wall = timed(do_step, G)
            dev_ms, split, counts = profiled(do_step, G)
            report("decode step", wall, dev_ms, split, counts, args.top)


if __name__ == "__main__":
    main()
