#!/usr/bin/env python3
"""Device time of the binned segment scatter at the engine's T3 shape, for
the port in this checkout or in another one (a parent commit unpacked
with ``git archive``), beside the PyTorch calls that compute the same
function.

    python3 tools/fold_kernel_times.py [--src DIR/src]
        [--shape 64 65536 4096]

Imports ``repro_torch`` from ``--src`` (default: this checkout's
``src``), draws ``chip_smoke.py``'s "mixed" operands (seed 0: indices
uniform over -1, the empty slot, and the bin's slots), checks the kernel's
add and min bitwise against their plain versions, and prints for each the
kernel's time, ``scatter_add`` / ``scatter_reduce(amin)``'s on the slots
plus a trash column, and the bound (bytes moved over 3.35 TB/s), then the
time of one ``copy_`` of the slots alone (the floor of any fold that
writes a new array), with the card's name and power limit.  Times: CUDA
events, median of 25 launches, the L2 cache overwritten and the device
held by a spin before each, so a time is the device's, not the wrapper's
host dispatch.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import functools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--shape", type=int, nargs=3, default=[64, 65536, 4096],
                    metavar=("NB", "B", "CAP"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch
    from repro_torch.kernels import scatter_update as SEG

    if not torch.cuda.is_available():
        raise SystemExit("fold_kernel_times: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=dev)

    def ms(fn, reps=25):
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            flush.fill_(1)
            torch.cuda._sleep(200_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    nb, b, cap = args.shape
    rng = np.random.default_rng(0)
    base = rng.normal(0, 1, (nb, b)).astype(np.float32)
    idx = rng.integers(-1, b, (nb, cap)).astype(np.int32)
    vals = rng.normal(0, 1, (nb, cap)).astype(np.float32)
    ops = [torch.from_numpy(a).to(dev) for a in (base, idx, vals)]
    trash = ops[0].new_full((nb, 1), float(np.finfo(np.float32).max))
    ext = torch.cat([ops[0], trash], dim=1)
    slot = torch.where(ops[1] < 0, b, ops[1]).to(torch.int64)
    library = {"add": functools.partial(ext.scatter_add, 1, slot, ops[2]),
               "min": functools.partial(ext.scatter_reduce, 1, slot, ops[2],
                                        "amin")}
    moved = sum(t.numel() * t.element_size() for t in ops) + base.nbytes
    print(f"# {smi}; repro_torch from {Path(args.src).resolve()}")
    total = {"kernel": 0.0, "library": 0.0}
    for op in ("add", "min"):
        got = SEG.scatter_segments(*ops, op=op)
        want = SEG.binned_scatter(*ops, op)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        k_ms = ms(lambda: SEG.scatter_segments(*ops, op=op))
        l_ms = ms(library[op])
        total["kernel"] += k_ms
        total["library"] += l_ms
        print(f"scatter_segments {op} {[nb, b, cap]}: bitwise equal to its "
              f"plain version; kernel {k_ms:.4f} ms, library {l_ms:.4f} ms, "
              f"bound {moved / 3.35e12 * 1e3:.4f} ms")
    print(f"scatter_segments add + min: kernel {total['kernel']:.4f} ms, "
          f"library {total['library']:.4f} ms")
    # the floor of any out-of-place fold: one copy of the slots, timed alike
    out = torch.empty_like(ops[0])
    print(f"torch copy_ of the {base.nbytes} bytes of slots alone: "
          f"{ms(lambda: out.copy_(ops[0])):.4f} ms")


if __name__ == "__main__":
    main()
