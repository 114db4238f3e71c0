#!/usr/bin/env python3
"""Write copies of the standalone engine kernels' source, each with one
text edit, for ``tools/kernel_times.py frontier|fold_min|scan
--variants``.

    python3 tools/engine_variants.py [--out DIR] NAME [NAME ...]

Each variant is ``src/repro_torch/kernels/engine/csrc/engine_kernels.cu``
as it is in this checkout with one edit, written beside copies of the
headers it includes (``DIR/NAME/engine_kernels.cu``,
``DIR/NAME/engine_device.cuh``, ``DIR/NAME/ordered_scatter.cuh``; DIR
defaults to ``build/engine_variants``).  Prints the variants' source
directories joined by commas, the form ``--variants`` takes.  The
variants:

- ``lookback``: the frontier pop's blocks take the count of set bits
  before their range by a decoupled look-back instead of counting the
  bytes themselves: each block counts its own range and publishes that
  count in a status word of its own, then walks back over the blocks
  before it, adding a published count where there is one and counting
  that block's bytes itself where there is none (so no block waits on
  another, whatever order the blocks run in), until the sum reaches k.
  The status words are a ``__device__`` array of the library, zero when
  it loads; the tile's last block to finish clears its tile's words, so
  no call needs a memset.  At most ``LB_MAX_TILES`` tiles of
  ``LB_MAX_RANGES`` ranges;
- ``pop_late_write``: the frontier pop writes every vector after the
  count before its range, none at once (what the early writes of vectors
  that hold no set bit buy);
- ``pop_count16``: the count before a range in passes of 64 KiB (16
  vectors a thread), not 32 KiB;
- ``pop_512``: the pop in blocks of 512 threads, not 256;
- ``min_beside``: the min fold always folds beside the copy
  (``min_fold_beside`` over the same (T, G) grid), what the staging in
  shared memory buys;
- ``min_scalar_rows``: the min fold loads its rows one at a time (three
  loads a row), not four a load;
- ``min_256``: the min fold in blocks of 256 threads holding 16 rows
  each, not 512 holding 8;
- ``min_red``: no staging: each block loads its rows into registers (four
  a load), copies its range of the target into the output (16-byte
  vectors, four in flight a thread), passes a barrier and folds the rows
  in range with global atomics (reductions in L2) onto what it has just
  written (no NaN tickets);
- ``nan_no_target_pass``: the staged min fold does not ticket the NaNs
  of the target's aligned part (no pass over the staged range, no
  barrier after it);
- ``nan_no_row_ticket``: the staged min fold folds each row's value as
  it is, not its ticket;
- ``nan_no_read_back``: the staged min fold writes its range out without
  reading tickets back, even where a NaN took part;
- ``scan_free_registers``: the T2 scans' kernels compiled without the
  register budget of ``SCAN_BLOCKS_PER_SM`` blocks a SM;
- ``scan_one_pass``: the scans' grid holds a team for every message (no
  grid-stride loop);
- ``scan_whole_rows``: the scans write every group of nb and w of a
  message that has a live lane (whole 128-byte rows at max_t2 = 32, no
  partly written sector);
- ``scan_no_nbw``: the scans write jvalid only (what writing nb and w
  costs; not the kernel's bits);
- ``scan_no_loads``: the scans read no shard word, every live lane's dst
  and val 0 (what the shard reads cost; not the kernel's bits).

All give the kernel's bits on NaN-free operands (the ``nan_*`` variants
are what the NaN rule costs): ``kernel_times.py`` records a variant's
check all the same.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "engine" / "csrc"
SOURCE = CSRC / "engine_kernels.cu"
HEADERS = (CSRC / "engine_device.cuh", CSRC / "ordered_scatter.cuh")

LOOK_BACK = r'''// The look-back variant's status words: (1 << 31) | count of a block's own
// set bits once it has published them, 0 before; and the tiles' counts of
// blocks done.
constexpr int LB_MAX_TILES = 4096, LB_MAX_RANGES = 256;
__device__ unsigned int lb_status[LB_MAX_TILES * LB_MAX_RANGES];
__device__ unsigned int lb_done[LB_MAX_TILES];

// all the set bits of m[a:b), by the whole block; block-uniform
__device__ inline int pop_count_range(const uint8_t* __restrict__ m, int v0,
                                      int a, int b, int* sm) {
  const int j_a = (a - v0) / repro::FT_BYTES;
  const int j_b = b > a ? (b - v0 + repro::FT_BYTES - 1) / repro::FT_BYTES
                        : j_a;
  int total = 0;
  for (int j0 = j_a; j0 < j_b; j0 += FP_THREADS * FP_COUNT_VECS) {
    int c = 0;
#pragma unroll
    for (int q = 0; q < FP_COUNT_VECS; ++q) {
      const int j = j0 + q * FP_THREADS + threadIdx.x;
      if (j < j_b) c += count_set(load_vec(m, v0 + repro::FT_BYTES * j, a,
                                           b).v);
    }
    total += repro::block_sum(c, sm);
  }
  return total;
}

__device__ inline int pop_look_back(const uint8_t* __restrict__ m, int v0,
                                    int lo, int hi, int step, int k,
                                    int* sm) {
  __shared__ unsigned int word;
  const int t = blockIdx.x, g = blockIdx.y, G = gridDim.y;
  if (t >= LB_MAX_TILES || G > LB_MAX_RANGES) __trap();
  unsigned int* st = lb_status + (size_t)t * LB_MAX_RANGES;
  const int own = pop_count_range(m, v0, lo, hi, sm);
  if (threadIdx.x == 0) {
    atomicExch(st + g, 0x80000000u | static_cast<unsigned>(own));
    __threadfence();
  }
  int seen = 0;
  for (int j = g - 1; j >= 0 && seen < k; --j) {
    if (threadIdx.x == 0) word = atomicAdd(st + j, 0u);
    __syncthreads();
    const unsigned int w = word;
    __syncthreads();
    seen += (w & 0x80000000u) != 0
                ? static_cast<int>(w & 0x7FFFFFFFu)
                : pop_count_range(m, v0, j * step, (j + 1) * step, sm);
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the tile's last block done clears its words
    __threadfence();
    if (atomicAdd(lb_done + t, 1u) == static_cast<unsigned>(G - 1)) {
      for (int j = 0; j < G; ++j) atomicExch(st + j, 0u);
      atomicExch(lb_done + t, 0u);
    }
  }
  return seen;
}

__global__ void __launch_bounds__(FP_THREADS)
frontier_pop_kernel('''

MIN_RED = r'''__global__ void __launch_bounds__(FM_THREADS)
fold_scatter_min_red_kernel(const float* __restrict__ target,
                            const int32_t* __restrict__ lidx,
                            const float* __restrict__ vals,
                            const uint8_t* __restrict__ valid,
                            float* __restrict__ out, int v_chunk, int R,
                            int step) {
  const int t = blockIdx.x;
  const int lo = blockIdx.y * step, hi = min(lo + step, v_chunk);
  const int32_t* li = lidx + (size_t)t * R;
  const float* vx = vals + (size_t)t * R;
  const uint8_t* vd = valid + (size_t)t * R;
  const bool vec = (R & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(li) |
                     reinterpret_cast<uintptr_t>(vx)) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(vd) & 3) == 0;
  float* o = out + (size_t)t * v_chunk;
  for (int r0 = 0;; r0 += FM_THREADS * FM_ROWS) {
    MinRow x[FM_ROWS];
#pragma unroll
    for (int u = 0; u < FM_ROWS; u += 4)
      load_min_rows(li, vx, vd, r0 + 4 * (u / 4 * FM_THREADS + threadIdx.x),
                    R, vec, x + u);
    if (r0 == 0) {
      repro::copy_range(target + (size_t)t * v_chunk, o, lo, hi,
                        repro::whole_block());
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < FM_ROWS; ++u)
      if (x[u].s >= lo && x[u].s < hi)
        repro::atomic_min_f32(o + x[u].s, x[u].v);
    if (r0 + FM_THREADS * FM_ROWS >= R) break;
  }
}

'''

# name -> [(text in the source, its replacement, how many times it
# occurs), ...]
EDITS = {
    "lookback": [
        ("__global__ void __launch_bounds__(FP_THREADS)\n"
         "frontier_pop_kernel(", LOOK_BACK, 1),
        ("if (jp == j_lo) seen = pop_count_before(m, v0, lo, k, sm);",
         "if (jp == j_lo) seen = pop_look_back(m, v0, lo, hi, step, k, sm);",
         1)],
    "pop_late_write": [
        ("      if (c[q] == 0 && jw + 32 * q < j_hi)  // not popped: written "
         "at once", "      if (false)", 1),
        ("      if (c[q] != 0)  // (a vector past j_hi holds no set bit)",
         "      if (jw + 32 * q < j_hi)", 1)],
    "pop_count16": [
        ("constexpr int FP_COUNT_VECS = 8;",
         "constexpr int FP_COUNT_VECS = 16;", 1)],
    "min_scalar_rows": [
        ("  const bool vec = (R & 3) == 0 &&\n                   ((reinterp",
         "  const bool vec = false && (R & 3) == 0 &&\n"
         "                   ((reinterp", 1)],
    "min_256": [
        ("constexpr int FM_THREADS = 512;", "constexpr int FM_THREADS = 256;",
         1),
        ("constexpr int FM_ROWS = 8;", "constexpr int FM_ROWS = 16;", 1)],
    "pop_512": [
        ("constexpr int FP_THREADS = 256;", "constexpr int FP_THREADS = 512;",
         1)],
    "min_red": [
        ("// The same fold past the staging: min_fold_beside over the same grid.",
         MIN_RED + "// The same fold past the staging: min_fold_beside over "
         "the same grid.", 1),
        ("    fold_scatter_min_kernel<<<grid, FM_THREADS, smem, st>>>(",
         "    fold_scatter_min_red_kernel<<<grid, FM_THREADS, 0, st>>>(", 1)],
    "min_beside": [
        ("const bool staged = (size_t)step * sizeof(float) <= "
         "repro::STAGE_SMEM_MAX;", "const bool staged = false;", 1)],
    "nan_no_target_pass": [
        ("      for (int i = threadIdx.x; 4 * i < b - a; i += FM_THREADS) {",
         "      for (int i = threadIdx.x; false; i += FM_THREADS) {", 1),
        ("      __syncthreads();\n    }\n#pragma unroll\n    for (int u = 0; "
         "u < FM_ROWS; ++u)\n      if (x[u].s >= lo && x[u].s < hi) {",
         "    }\n#pragma unroll\n    for (int u = 0; u < FM_ROWS; ++u)\n"
         "      if (x[u].s >= lo && x[u].s < hi) {", 1)],
    "nan_no_row_ticket": [
        ("            repro::row_ticket(\n"
         "                x[u].v, r0 + 4 * (u / 4 * FM_THREADS + threadIdx.x)"
         " + u % 4));", "            x[u].v);", 1)],
    "scan_free_registers": [
        ("__launch_bounds__(SCAN_THREADS, SCAN_BLOCKS_PER_SM)\n",
         "__launch_bounds__(SCAN_THREADS)\n", 2)],
    "scan_one_pass": [
        ("  const long long most = (long long)SCAN_BLOCKS_PER_SM * sms;",
         "  const long long most = need;", 1)],
    "scan_whole_rows": [
        ("        if (j0 < length) {\n          *reinterpret_cast<int4*>",
         "        if (length > 0) {\n          *reinterpret_cast<int4*>", 1)],
    "scan_no_nbw": [
        ("        if (j0 < length) {\n          *reinterpret_cast<int4*>",
         "        if (false) {\n          *reinterpret_cast<int4*>", 1)],
    "scan_no_loads": [
        ("        d[k] = live ? ed[ei] : 0;\n        v[k] = live ? ev[ei] : "
         "0.0f;", "        d[k] = 0 * ei;\n        v[k] = live ? 1.0f : "
         "0.0f;", 1)],
    "nan_no_read_back": [
        ("  if (ticketed)\n    write_out(", "  if (false)\n    write_out(",
         1)],
}


def write(name: str, out: Path) -> Path:
    """The variant's source directory, written under ``out``."""
    src = SOURCE.read_text()
    for old, new, times in EDITS[name]:
        if src.count(old) != times:
            raise SystemExit(f"engine_variants: {name}: {old!r} is not in "
                             f"{SOURCE} {times} times")
        src = src.replace(old, new)
    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    (d / SOURCE.name).write_text(src)
    for h in HEADERS:
        (d / h.name).write_text(h.read_text())
    return d


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="+", choices=sorted(EDITS))
    ap.add_argument("--out", default=str(ROOT / "build" / "engine_variants"))
    args = ap.parse_args()
    dirs = [write(n, Path(args.out).resolve()) for n in args.names]
    print(",".join(str(d) for d in dirs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
