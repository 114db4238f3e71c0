#!/usr/bin/env python3
"""Write copies of the WKV6 kernel's source, each with one text edit, for
``tools/kernel_times.py wkv6 --variants``.

    python3 tools/wkv6_variants.py [--out DIR] NAME [NAME ...]

Each variant is ``src/repro_torch/kernels/rwkv6/csrc/wkv6.cu`` as it is
in this checkout with one edit, written beside a copy of the header it
includes, at the path it includes it by (``DIR/NAME/kernels/rwkv6/csrc/
wkv6.cu`` and ``DIR/NAME/kernels/csrc/mma_tf32.cuh``; DIR defaults to
``build/wkv6_variants``).  Prints the variants' source directories joined
by commas, the form ``--variants`` takes.  The variants:

- ``chain_only``: the prep warps form the key side of the first chunk
  only, so a chunk costs what the chain warps take and the copies (y is
  wrong);
- ``prep_only``: the chain warps skip their products, so a chunk costs
  what the prep warps and the copies take (y is not written);
- ``skip_a``, ``skip_b``: the prep warps skip step A (L, the decays,
  the planes, the bonus) or step B (the scores) after the first chunk;
- ``no_wait``: the prep warps do not wait for a chunk's copies (a race:
  what the wait costs);
- ``fast_exp``: ``__expf`` for ``expf`` (what the accurate exponentials
  cost);
- ``segments``: each head's sequence in two segments, so that twice the
  chains run: a first launch carries the state through the first
  segment alone (no y, no scores), then a second launch of two blocks a
  head runs both segments in full, the second from the first's final
  state; two blocks an SM (``__launch_bounds__(NT, 2)``).  An odd chunk
  count takes one launch, as the kernel does.

All but ``segments`` are wrong by design:
``kernel_times.py`` records a variant's check instead of asserting it.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ROOT / "src" / "repro_torch" / "kernels"
SOURCE = KERNELS / "rwkv6" / "csrc" / "wkv6.cu"
HEADER = KERNELS / "csrc" / "mma_tf32.cuh"

# The segments variant: the kernel's `mode` 0 carries the state through
# the first half of the chunks (no y, no scores), mode 1 runs a half a
# block (blockIdx.z), the second from state_out, mode 2 the whole.
SEGMENTS = [
    ("const float* __restrict__ state0,", "const float* state0,", 1),
    ("float* __restrict__ state_out, int S,\n            int H, int C) {",
     "float* state_out, int S,\n            int H, int C, int mode) {", 1),
    ("__launch_bounds__(Layout<K, KT>::NT, 1)",
     "__launch_bounds__(Layout<K, KT>::NT, 2)", 1),
    ("  const int n_chunks = S / C;\n", """\
  const int nc_all = S / C, hc = nc_all / 2;
  const bool second = mode == 1 && blockIdx.z == 1;
  const int c_beg = second ? hc : 0;
  const int n_chunks = (mode == 2 || second ? nc_all : hc) - c_beg;
  const bool write_y = mode != 0, write_s = mode != 1 || second;
  const float* s_in = second ? state_out : state0;
""", 1),
    ("const size_t head = (size_t)b * S * row + (size_t)h * K;",
     "const size_t head = (size_t)b * S * row + (size_t)h * K +\n"
     "                      (size_t)c_beg * C * row;", 1),
    ("st[j][e] = state0 == nullptr\n                       ? 0.0f\n"
     "                       : state0[",
     "st[j][e] = s_in == nullptr\n                       ? 0.0f\n"
     "                       : s_in[", 1),
    ("      if (ch < n_chunks) step_b(ch);",
     "      if (write_y && ch < n_chunks) step_b(ch);", 1),
    ("      if (ch > 0) {\n        // chunk ch - 1",
     "      if (write_y && ch > 0) {\n        // chunk ch - 1", 1),
    ("            mma3(yi[i], a,", "            if (write_y) mma3(yi[i], a,",
     1),
    ("        state_out[o + (e & 1) * K + (e >> 1) * 8] = st[j][e];",
     "        if (write_s) state_out[o + (e & 1) * K + (e >> 1) * 8] = "
     "st[j][e];", 1),
    ("""\
  kern<<<dim3(H, B), Lay::NT, smem, stream>>>(r, k, v, w, u, s0, y, sT, S,
                                              H, C);
""", """\
  const int nc = S / C;
  if (nc >= 2 && nc % 2 == 0) {
    kern<<<dim3(H, B, 1), Lay::NT, smem, stream>>>(r, k, v, w, u, s0, y, sT,
                                                   S, H, C, 0);
    kern<<<dim3(H, B, 2), Lay::NT, smem, stream>>>(r, k, v, w, u, s0, y, sT,
                                                   S, H, C, 1);
  } else {
    kern<<<dim3(H, B, 1), Lay::NT, smem, stream>>>(r, k, v, w, u, s0, y, sT,
                                                   S, H, C, 2);
  }
""", 1),
]

# name -> [(text in the source, its replacement, how many times it
# occurs), ...]
EDITS = {
    "chain_only": [("      if (ch < n_chunks) step_b(ch);\n"
                    "      if (ch + 1 < n_chunks) step_a(ch + 1);",
                    "      if (ch == 0) step_b(ch);", 1)],
    "prep_only": [("    } else {\n      constexpr int ALO",
                   "    } else if (n_chunks < 0) {\n      constexpr int ALO",
                   1)],
    "skip_a": [("      if (ch + 1 < n_chunks) step_a(ch + 1);",
                "      if (ch + 1 < n_chunks && ch < 0) step_a(ch + 1);", 1)],
    "skip_b": [("      if (ch < n_chunks) step_b(ch);",
                "      if (ch < n_chunks && ch < 0) step_b(ch);", 1)],
    "no_wait": [("      cp_async_wait<0>();\n    } else {", "    } else {", 1)],
    "fast_exp": [(" expf(", " __expf(", 4)],
    "segments": SEGMENTS,
}


def write(name: str, out: Path) -> Path:
    """The variant's source directory, written under ``out``."""
    src = SOURCE.read_text()
    for old, new, times in EDITS[name]:
        if src.count(old) != times:
            raise SystemExit(f"wkv6_variants: {name}: {old!r} is not in "
                             f"{SOURCE} {times} times")
        src = src.replace(old, new)
    d = out / name / "kernels" / "rwkv6" / "csrc"
    d.mkdir(parents=True, exist_ok=True)
    (d / SOURCE.name).write_text(src)
    h = out / name / "kernels" / "csrc"
    h.mkdir(parents=True, exist_ok=True)
    (h / HEADER.name).write_text(HEADER.read_text())
    return d


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="+", choices=sorted(EDITS))
    ap.add_argument("--out", default=str(ROOT / "build" / "wkv6_variants"))
    args = ap.parse_args()
    dirs = [write(n, Path(args.out).resolve()) for n in args.names]
    print(",".join(str(d) for d in dirs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
