#!/usr/bin/env python3
"""Time variants of the flash kernel's bfloat16 body against the body as
built, on one GPU.

    python3 tools/flash_variants.py [--variants single_p stages3 stages4]
        [--shapes granite zamba]

Each variant is the source as committed
(``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu``) with
one text edit, built into ``build/repro_torch/`` as a library of its own:

* ``single_p``: O += P V with P rounded once to bfloat16 (one wgmma a key
  step, ~2^-9 of relative precision on P) instead of its hi and lo halves;
* ``stages3``, ``stages4``: a K/V ring of 3 or 4 stages instead of 2.

For each shape (granite-3-2b's bfloat16 prefill attention, (4, 2048, 32 /
8, 64), and zamba2-2.7b's, (4, 2048, 32 / 32, 80)) it times the landed
kernel and each variant in turns (landed, variant, variant, landed; CUDA
events, median of 25 launches with the L2 cache flushed, as
``chip_smoke.py`` times), and prints each one's largest distance from the
bfloat16 plain version and its relative L2 distance from the float32 plain
version on the same inputs.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.kernels.cuda_build import BUILD_DIR, CudaLibrary  # noqa
from repro_torch.kernels.flash_attention import kernel as FAK  # noqa: E402

EDITS = {
    "single_p": ("          wgmma_rs<HD>(oacc, pl + 4 * kk, db);\n", ""),
    "stages3": ("constexpr int STAGES = 2;", "constexpr int STAGES = 3;"),
    "stages4": ("constexpr int STAGES = 2;", "constexpr int STAGES = 4;"),
}
SHAPES = {"granite": C.FLASH_MAIN, "zamba": C.FLASH80_MAIN}


def variant(name: str) -> CudaLibrary:
    src = FAK.LIBRARY.source.read_text()
    old, new = EDITS[name]
    assert src.count(old) == 1, f"{name}: the edit no longer applies"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"flash_attention_{name}.cu"
    path.write_text(src.replace(old, new))
    return CudaLibrary(path, FAK.LIBRARY.signatures)


@contextlib.contextmanager
def built_as(lib: CudaLibrary):
    """The flash wrapper launches ``lib`` inside the block."""
    landed, FAK.LIBRARY = FAK.LIBRARY, lib
    try:
        yield
    finally:
        FAK.LIBRARY = landed


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="+", choices=sorted(EDITS),
                    default=sorted(EDITS))
    ap.add_argument("--shapes", nargs="+", choices=sorted(SHAPES),
                    default=sorted(SHAPES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = {"landed": FAK.LIBRARY,
            **{name: variant(name) for name in args.variants}}
    for lib in libs.values():
        lib.get()
    dev = torch.device("cuda", 0)
    timer = C.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape in args.shapes:
        B, S, H, Hkv, hd, win, dtype = SHAPES[shape]
        q, k, v = C.flash_inputs(gen, B, S, H, Hkv, hd, dtype, dev)
        pos = torch.arange(S, dtype=torch.int32, device=dev)
        want = FAK.repeat_kv_attention(q, k, v, pos, win).float()
        want32 = FAK.repeat_kv_attention(q.float(), k.float(), v.float(),
                                         pos, win)
        for name in args.variants:
            ms = {"landed": [], name: []}
            for who in ("landed", name, name, "landed"):
                with built_as(libs[who]):
                    ms[who].append(timer.ms(
                        lambda: FAK.flash_attention(q, k, v, win)))
            for who in ("landed", name):
                with built_as(libs[who]):
                    out = FAK.flash_attention(q, k, v, win).float()
                err = float((out - want).abs().max())
                rel = float((out - want32).norm() / want32.norm())
                print(f"{shape} {SHAPES[shape]} {who}: "
                      + ", ".join(f"{t:.4f}" for t in ms[who])
                      + f" ms; max |err| from the bfloat16 plain version "
                      f"{err:.4g}, rel L2 from the float32 plain version "
                      f"{rel:.4g}", flush=True)


if __name__ == "__main__":
    main()
