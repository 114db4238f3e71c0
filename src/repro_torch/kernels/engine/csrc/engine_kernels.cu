// Hopper (sm_90a) kernels of the Dalorex engine round, one per TPU kernel of
// src/repro/kernels/engine/kernel.py on the unfused path.  Every kernel is
// batched over the T emulated tiles and writes every output element exactly
// as the reference's pure body does (including the don't-care slots), so a
// kernel's outputs are compared with its plain PyTorch version element for
// element; but for queue_push_pop's turned queue, which is written below its
// count only and compared there, and the scans' nb and w, written where a
// lane is live only and compared where jvalid holds.  Their bodies are the device functions of
// engine_device.cuh and ordered_scatter.cuh, which the fused legs
// (fused_legs.cu) share.
//
// Plain C interface (no torch headers): each launcher takes device pointers,
// sizes and the caller's cudaStream_t, launches on that stream without
// synchronising and returns cudaGetLastError().  Built by
// repro_torch/kernels/engine/kernel.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes.
//
// Bools are torch.bool tensors: one byte each, 0 or 1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "engine_device.cuh"
#include "ordered_scatter.cuh"

namespace {

// ---------------------------------------------------------------------------
// frontier_pop: replaces frontier_pop / frontier_take (kernel.py:371, :77).
// The first min(k, popcount) set bits of each tile's (n,) frontier bitmap, in
// position order: idx (k_max,) with 0 in the invalid slots, valid (k_max,),
// and the bitmap with exactly those bits cleared.
//
// Bound: bytes — the bitmap is read once and its cleared copy written once
// (2n bytes per tile); the ranking is a few integer ops per byte and k
// (the pop budget, f_pop = 32 on the main paths) bits at most a tile.
// Design: the taken bits are exactly the set bits at or before p_last, the
// position of the n_take-th set bit, so a block that owns a range of a
// tile's bitmap needs one number from the rest of it: how many set bits lie
// before its range, capped at k.  The grid is (T, G) of column-owning
// blocks, G and `step` from kernel.py device_split (320 blocks at 64 tiles
// of 65,536).  Block (t, g) owns the bytes [g * step, min((g + 1) * step,
// n)) and
//   1. loads its bytes, every 16-byte vector of a pass in flight at once;
//   2. writes at once its vectors that hold no set bit (the pop leaves
//      them as they are), so that most of a sparse bitmap's writes overlap
//      the next step;
//   3. counts the set bits before its range itself (pop_count_before), in
//      passes of 32 KiB that stop once the count reaches k: those bytes
//      are the blocks before it, read at the same time (L2 hits).  No
//      block waits on another: no scratch, no spin, no order among blocks;
//   4. if that count is >= k, copies its other vectors as they are; else
//      ranks its own set bits from that count (a warp owns a contiguous run
//      of vectors: one warp scan a vector and one block scan of the warps'
//      totals a pass), writes idx[rank] for rank < min(k, k_max), clears
//      those bytes and writes those vectors.
// The last range's count before plus its own, capped at k, is n_take: that
// block writes valid and the zeros of idx[n_take:k_max], disjoint from the
// other blocks' idx writes.  A byte is a set bit where it is not 0 (the
// parent kernel's and frontier_take_block's test; torch.bool bytes are 0
// or 1, but the test does not rely on it), counted four bytes a word by
// folding each byte onto its low bit.  The bitmap's 16-byte vectors are
// those of its address: a vector that a range boundary or the tile's ends
// cut is read and written byte by byte, and so is every vector where mask
// and rem differ in their alignment (an unaligned view).
// ---------------------------------------------------------------------------
constexpr int FP_THREADS = 256;
constexpr int FP_WARPS = FP_THREADS / 32;
constexpr int FP_VECS = 4;        // a thread's vectors of its range a pass
constexpr int FP_COUNT_VECS = 8;  // a thread's vectors a counting pass
static_assert(FP_WARPS <= 32, "one warp scans the warps' totals");

// each byte of w that is not 0, as the low bit of that byte
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  w |= w >> 4;
  w |= w >> 2;
  w |= w >> 1;
  return w & 0x01010101u;
}

__device__ __forceinline__ int count_set(const uint4& v) {
  return __popc(nonzero_bytes(v.x)) + __popc(nonzero_bytes(v.y)) +
         __popc(nonzero_bytes(v.z)) + __popc(nonzero_bytes(v.w));
}

// the set bytes of a vector as 16 bits, bit i for byte i
__device__ __forceinline__ uint32_t set_bits(const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t b = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t y = nonzero_bytes(w[q]);
    b |= ((y | (y >> 7) | (y >> 14) | (y >> 21)) & 0xFu) << (4 * q);
  }
  return b;
}

// w with the bytes whose bits are set in `clear` (4 bits) zeroed
__device__ __forceinline__ uint32_t clear_word(uint32_t w, uint32_t clear) {
  const uint32_t x =
      (clear | (clear << 7) | (clear << 14) | (clear << 21)) & 0x01010101u;
  return w & ~(x * 0xFFu);
}

// v with the bytes whose bits are set in `clear` (16 bits) zeroed
__device__ __forceinline__ uint4 clear_bytes(uint4 v, uint32_t clear) {
  return make_uint4(clear_word(v.x, clear & 0xFu),
                    clear_word(v.y, (clear >> 4) & 0xFu),
                    clear_word(v.z, (clear >> 8) & 0xFu),
                    clear_word(v.w, (clear >> 12) & 0xFu));
}

// The 16 bytes of m at positions p .. p + 15 (m + p 16-byte aligned where
// they all lie in [a, b)), 0 for the positions outside [a, b).
__device__ __forceinline__ repro::Bytes16 load_vec(const uint8_t* m, int p,
                                                   int a, int b) {
  repro::Bytes16 u;
  if (p >= a && p + repro::FT_BYTES <= b) {
    u.v = *reinterpret_cast<const uint4*>(m + p);
  } else {
#pragma unroll
    for (int i = 0; i < repro::FT_BYTES; ++i)
      u.b[i] = p + i >= a && p + i < b ? m[p + i] : 0;
  }
  return u;
}

// The bytes of u at positions p .. p + 15 of r that lie in [a, b), as one
// 16-byte vector where they all do and r + p is aligned (vec: r and the
// bitmap read share their alignment).
__device__ __forceinline__ void store_vec(uint8_t* r, int p, int a, int b,
                                          const repro::Bytes16& u, bool vec) {
  if (vec && p >= a && p + repro::FT_BYTES <= b) {
    *reinterpret_cast<uint4*>(r + p) = u.v;
  } else {
#pragma unroll
    for (int i = 0; i < repro::FT_BYTES; ++i)
      if (p + i >= a && p + i < b) r[p + i] = u.b[i];
  }
}

// The set bits of m[0:lo), counted by the whole block in passes of
// FP_THREADS * FP_COUNT_VECS whole 16-byte vectors, each pass's loads in
// flight together; the bytes that no whole vector holds (fewer than 16 at
// each end) by warp 0 in the first pass.  Stops after the pass that reaches
// k.  v0 (-15 .. 0) is the position of the first byte of m's first 16-byte
// vector.  Block-uniform.
__device__ inline int pop_count_before(const uint8_t* __restrict__ m, int v0,
                                       int lo, int k, int* sm) {
  if (lo <= 0 || k <= 0) return 0;
  // the whole vectors [jf0, jf1) hold the positions [f0, f1)
  const int jf0 = v0 < 0 ? 1 : 0;
  const int jf1 = max((lo - v0) / repro::FT_BYTES, jf0);
  const int f0 = min(v0 + repro::FT_BYTES * jf0, lo);
  const int f1 = max(v0 + repro::FT_BYTES * jf1, f0);
  int c = 0;
  if (threadIdx.x < 32) {  // the cut ends [0, f0) and [f1, lo)
    const int lane = threadIdx.x;
    const int q = lane < 16 ? lane : f1 + lane - 16;
    const bool set = (lane < 16 ? q < f0 : q < lo) && m[q] != 0;
    const unsigned votes = __ballot_sync(0xffffffffu, set);  // every lane
    c = lane == 0 ? __popc(votes) : 0;
  }
  int seen = 0;
  for (int j0 = jf0;; j0 += FP_THREADS * FP_COUNT_VECS) {
    uint4 u[FP_COUNT_VECS];
#pragma unroll
    for (int q = 0; q < FP_COUNT_VECS; ++q) {
      const int j = j0 + q * FP_THREADS + threadIdx.x;
      u[q] = j < jf1 ? *reinterpret_cast<const uint4*>(
                           m + v0 + repro::FT_BYTES * j)
                     : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int q = 0; q < FP_COUNT_VECS; ++q) c += count_set(u[q]);
    seen += repro::block_sum(c, sm);
    c = 0;
    if (seen >= k || j0 + FP_THREADS * FP_COUNT_VECS >= jf1) return seen;
  }
}

__global__ void __launch_bounds__(FP_THREADS)
frontier_pop_kernel(const uint8_t* __restrict__ mask,
                    const int32_t* __restrict__ kk, int32_t* __restrict__ idx,
                    uint8_t* __restrict__ valid, uint8_t* __restrict__ rem,
                    int n, int k_max, int step) {
  __shared__ int sm[33];
  const int t = blockIdx.x, g = blockIdx.y;
  const int lo = g * step, hi = min(lo + step, n);
  const uint8_t* m = mask + (size_t)t * n;
  uint8_t* r = rem + (size_t)t * n;
  int32_t* ix = idx + (size_t)t * k_max;
  const int k = kk[t];
  const int v0 = -static_cast<int>(reinterpret_cast<uintptr_t>(m) & 15);
  const bool vec_out = ((reinterpret_cast<uintptr_t>(m) ^
                         reinterpret_cast<uintptr_t>(r)) & 15) == 0;
  // this range's vectors [j_lo, j_hi), a warp owning 32 * FP_VECS of a pass
  const int j_lo = (lo - v0) / repro::FT_BYTES;
  const int j_hi = hi > lo ? (hi - v0 + repro::FT_BYTES - 1) / repro::FT_BYTES
                           : j_lo;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int seen = 0;  // set bits before this pass, once counted; block-uniform
  for (int jp = j_lo; jp < j_hi; jp += FP_THREADS * FP_VECS) {
    const int jw = jp + warp * 32 * FP_VECS + lane;  // vector q: jw + 32 q
    repro::Bytes16 u[FP_VECS];
#pragma unroll
    for (int q = 0; q < FP_VECS; ++q) {
      const int j = jw + 32 * q;
      if (j < j_hi)
        u[q] = load_vec(m, v0 + repro::FT_BYTES * j, lo, hi);
      else
        u[q].v = make_uint4(0, 0, 0, 0);
    }
    int c[FP_VECS];
#pragma unroll
    for (int q = 0; q < FP_VECS; ++q) {
      c[q] = count_set(u[q].v);
      if (c[q] == 0 && jw + 32 * q < j_hi)  // not popped: written at once
        store_vec(r, v0 + repro::FT_BYTES * (jw + 32 * q), lo, hi, u[q],
                  vec_out);
    }
    if (jp == j_lo) seen = pop_count_before(m, v0, lo, k, sm);
    if (seen < k) {  // block-uniform
      int excl[FP_VECS], wtot = 0;
#pragma unroll
      for (int q = 0; q < FP_VECS; ++q) {
        int x = c[q];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, o);
          if (lane >= o) x += y;
        }
        excl[q] = wtot + x - c[q];
        wtot += __shfl_sync(0xffffffffu, x, 31);
      }
      if (lane == 0) sm[warp] = wtot;
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < FP_WARPS; ++w) {
        before += w < warp ? sm[w] : 0;
        total += sm[w];
      }
#pragma unroll
      for (int q = 0; q < FP_VECS; ++q) {
        int rank = seen + before + excl[q];
        if (c[q] == 0 || rank >= k) continue;
        const int p = v0 + repro::FT_BYTES * (jw + 32 * q);
        uint32_t bits = set_bits(u[q].v), taken = 0;
        while (bits != 0 && rank < k) {
          const int i = __ffs(bits) - 1;
          bits &= bits - 1;
          if (rank < k_max) ix[rank] = p + i;
          taken |= 1u << i;
          ++rank;
        }
        u[q].v = clear_bytes(u[q].v, taken);
      }
      seen += total;
      __syncthreads();  // sm is read before the next pass writes it
    }
#pragma unroll
    for (int q = 0; q < FP_VECS; ++q)
      if (c[q] != 0)  // (a vector past j_hi holds no set bit)
        store_vec(r, v0 + repro::FT_BYTES * (jw + 32 * q), lo, hi, u[q],
                  vec_out);
  }
  if (g == gridDim.y - 1) {  // the last range: n_take is min(k, seen)
    if (lo >= hi) seen = pop_count_before(m, v0, lo, k, sm);
    int n_take = seen < k ? seen : k;
    if (n_take < 0) n_take = 0;
    for (int j = threadIdx.x; j < k_max; j += blockDim.x) {
      valid[(size_t)t * k_max + j] = j < n_take;
      if (j >= n_take) ix[j] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// queue_push_pop: replaces queue_push_pop / fifo_turn + queue_append
// (kernel.py:417, :95, :123).  One circular-FIFO turn per tile: append the
// valid fresh rows at the tail (slot claim by exclusive scan; rows past the
// capacity are drops), then pop n_pop = min(n, count') rows off the front.
// The turned queue ndata keeps the live rows only: old row i in [n_pop, c0)
// goes to slot i - n_pop, fresh row j to slot c0 + j - n_pop where that is
// >= 0, and the slots from the new count on are not written (fifo_turn
// makes them don't-care: "rows at or beyond the live count are
// unobservable garbage", src/repro/kernels/engine/kernel.py:424-427).
// taken is fifo_turn's, bitwise: the first max_n rows of the appended
// queue, the stale rows past its count included.
//
// Bound: bytes — the live rows read once and written once, the valid
// flags, the pushed rows, the taken rows and the counts, so the bytes
// follow the queue's occupancy, not its capacity.  Design: a grid (T,
// G + 1), G from the column split of the queue's capacity (kernel.py
// device_split).  Block (t, G) compacts the valid fresh rows' indices with
// a block scan into dynamic shared memory (into the tile's part of the
// wrapper's device-memory scratch, `scratch` != nullptr, where m indices
// do not fit) and writes the fresh rows that stay, taken, tvalid and the
// counts.  Blocks (t, g < G) move their share of the old live rows with
// fifo_live_turn (one 8- or 16-byte vector a row of 2 or 4 words, words
// otherwise).  They need no fresh-row count: where the pop budget n is
// below the old count c0 the pop is n, else no old row stays.
// ---------------------------------------------------------------------------
constexpr int QP_THREADS = 512;

// the rows [lo, hi) of the live-row turn of a queue of w words a row
__device__ inline void live_turn_any(const int32_t* __restrict__ d,
                                     int32_t* __restrict__ nd, int w,
                                     int n_pop, int lo, int hi) {
  switch (w) {
    case 2:
      repro::fifo_live_turn<2>(d, nd, n_pop, lo, hi, threadIdx.x, blockDim.x);
      return;
    case 3:
      repro::fifo_live_turn<3>(d, nd, n_pop, lo, hi, threadIdx.x, blockDim.x);
      return;
    case 4:
      repro::fifo_live_turn<4>(d, nd, n_pop, lo, hi, threadIdx.x, blockDim.x);
      return;
    default: {
      const int32_t* dw = d + (size_t)n_pop * w;
      for (size_t e = (size_t)lo * w + threadIdx.x; e < (size_t)hi * w;
           e += blockDim.x)
        nd[e] = dw[e];
    }
  }
}

__global__ void __launch_bounds__(QP_THREADS)
queue_push_pop_kernel(const int32_t* __restrict__ data,
                      const int32_t* __restrict__ count,
                      const int32_t* __restrict__ rows,
                      const uint8_t* __restrict__ pvalid,
                      const int32_t* __restrict__ npop,
                      int32_t* __restrict__ taken, uint8_t* __restrict__ tvalid,
                      int32_t* __restrict__ ndata,
                      int32_t* __restrict__ ncount,
                      int32_t* __restrict__ drops, int* scratch, int cap,
                      int w, int n, int max_n) {
  extern __shared__ int qp_smem[];
  __shared__ int sm[33];
  const int t = blockIdx.x, g = blockIdx.y, G = gridDim.y - 1;
  const int c0 = count[t];
  const int p = npop[t];
  const int32_t* d = data + (size_t)t * cap * w;
  int32_t* nd = ndata + (size_t)t * cap * w;
  if (g < G) {  // this block's share of the old rows past the pop
    if (p >= c0) return;
    const int L = c0 - p;
    live_turn_any(d, nd, w, p, (int)((long long)g * L / G),
                  (int)((long long)(g + 1) * L / G));
    return;
  }
  // source row of the j-th valid row
  int* src_row = scratch != nullptr ? scratch + (size_t)t * n : qp_smem;
  int nvalid = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < n ? pvalid[(size_t)t * n + i] != 0 : 0;
    int total;
    const int pos = nvalid + repro::block_excl_scan(v, &total, sm);
    if (v) src_row[pos] = i;
    nvalid += total;
  }
  __syncthreads();
  const int room = cap - c0 > 0 ? cap - c0 : 0;
  const int n_push = nvalid < room ? nvalid : room;
  const int n_pop = p < c0 + n_push ? p : c0 + n_push;
  const int32_t* rw = rows + (size_t)t * n * w;
  // the fresh rows that stay: row c0 + j of the appended queue is row
  // c0 + j - n_pop of the turned one
  const int j0 = n_pop - c0 > 0 ? n_pop - c0 : 0;
  for (int e = j0 * w + threadIdx.x; e < n_push * w; e += blockDim.x) {
    const int j = e / w, col = e - j * w;
    nd[(size_t)(c0 + j - n_pop) * w + col] =
        rw[(size_t)src_row[j] * w + col];
  }
  // the first max_n rows of the appended queue
  int32_t* tk = taken + (size_t)t * max_n * w;
  for (int e = threadIdx.x; e < max_n * w; e += blockDim.x) {
    const int i = e / w, col = e - i * w;
    tk[e] = i >= c0 && i < c0 + n_push ? rw[(size_t)src_row[i - c0] * w + col]
                                       : d[e];
  }
  for (int j = threadIdx.x; j < max_n; j += blockDim.x)
    tvalid[(size_t)t * max_n + j] = j < n_pop;
  if (threadIdx.x == 0) {
    ncount[t] = c0 + n_push - n_pop;
    drops[t] = nvalid - n_push;
  }
}

// ---------------------------------------------------------------------------
// edge_scan_gather and edge_scan_stream: replace edge_scan_gather /
// segment_gather (kernel.py:473, :141) and edge_scan_stream / segment_stream
// (kernel.py:519, :157).  For each of the R range messages of a tile, the
// max_t2 lanes edge_dst/edge_val[min(start % e_chunk + j, e_chunk - 1)], and
// jvalid = rv && j < stop - start && dst >= 0.  The stream gives the same
// bits with no staging: its wrapper asks window >= max_t2 (as the
// reference's resolve_window does), and then the two windows segment_stream
// stages hold every word a lane reads, at the offset the gather reads
// (off0 = local0 - base + j <= 2 * window - 2, so the clamp to the staging
// never bites, and min(base + off0, e_chunk - 1) = min(local0 + j,
// e_chunk - 1)).  The windows a streamed shard transfers are the engine's
// model (Stats.hbm_windows and hbm_edges), not the kernel's.
//
// Bound: bytes — each message's rv, start and stop (9 bytes) and jvalid
// (max_t2 bytes); for each live lane (j < length of a valid message) its shard
// word pair read and its nb and w written (16 bytes).  Design: a team of
// ceil(max_t2 / 4) threads a message, thread q owning the lanes 4q .. 4q + 3
// (a team is at most SCAN_THREADS threads, each then also taking every
// SCAN_THREADS-th group after its own), over a grid-stride loop on the rows *
// R messages, SCAN_BLOCKS_PER_SM blocks a SM (the register budget compiled for
// them).  The rows are the T tiles, or B * T lane-major rows of B serving
// lanes that share the shard: row r scans shard row r % T.  A team reads its message's rv, start and stop once (one address
// for the whole team), takes the message's bounds once (one floor modulo, no
// division a lane), issues the shard loads of its live lanes before any use,
// and writes jvalid whole as one 4-byte word and nb, w as one 16-byte vector
// each, only for the groups of four lanes that hold a live lane (one by one
// where a group is cut by max_t2 or the output is not aligned).  The lanes of
// nb and w it does not write are the reference's don't-care (masked by jvalid
// at every consumer: kernel.py scan_contract).  The shard reads set its time:
// on an H100 it took 0.0104 of its 0.0166 ms without them, and a team holding
// two messages at once gained 1-2 % (PERF.md).
// ---------------------------------------------------------------------------
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_BLOCKS_PER_SM = 8;

__device__ __forceinline__ void scan_messages(
    const int32_t* __restrict__ edge_dst, const float* __restrict__ edge_val,
    const int32_t* __restrict__ start, const int32_t* __restrict__ stop,
    const uint8_t* __restrict__ rv, int32_t* __restrict__ nb,
    float* __restrict__ wout, uint8_t* __restrict__ jvalid, int rows, int T,
    int e_chunk, int R, int max_t2) {
  const int groups = (max_t2 + 3) / 4;
  const int team = groups < SCAN_THREADS ? groups : SCAN_THREADS;
  const int teams = SCAN_THREADS / team;
  if (static_cast<int>(threadIdx.x) >= teams * team) return;
  const int q = threadIdx.x % team;
  const bool aligned = ((reinterpret_cast<uintptr_t>(nb) |
                         reinterpret_cast<uintptr_t>(wout)) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(jvalid) & 3) == 0;
  const int messages = rows * R;  // below 2^31: the entries check it
  for (int m = blockIdx.x * teams + threadIdx.x / team; m < messages;
       m += gridDim.x * teams) {
    int length, local0;
    repro::message_bounds(rv[m] != 0, start[m], stop[m], e_chunk, &length,
                          &local0);
    // state row m / R scans shard row (m / R) % T: the serving lanes'
    // rows share one shard
    const size_t shard_row = (size_t)((m / R) % T);
    const int32_t* ed = edge_dst + shard_row * e_chunk;
    const float* ev = edge_val + shard_row * e_chunk;
    for (int g = q; g < groups; g += team) {
      const int j0 = 4 * g;
      const size_t o = (size_t)m * max_t2 + j0;
      int32_t d[4];
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // every load before any use
        const int e = local0 + j0 + k;
        const int ei = e < e_chunk - 1 ? e : e_chunk - 1;
        const bool live = j0 + k < length;
        d[k] = live ? ed[ei] : 0;
        v[k] = live ? ev[ei] : 0.0f;
      }
      uint8_t f[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) f[k] = j0 + k < length && d[k] >= 0;
      if (aligned && j0 + 4 <= max_t2 && (o & 3) == 0) {
        *reinterpret_cast<uchar4*>(jvalid + o) =
            make_uchar4(f[0], f[1], f[2], f[3]);
        if (j0 < length) {
          *reinterpret_cast<int4*>(nb + o) =
              make_int4(d[0], d[1], d[2], d[3]);
          *reinterpret_cast<float4*>(wout + o) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (j0 + k >= max_t2) break;
          jvalid[o + k] = f[k];
          if (j0 + k < length) {
            nb[o + k] = d[k];
            wout[o + k] = v[k];
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(SCAN_THREADS, SCAN_BLOCKS_PER_SM)
edge_scan_gather_kernel(const int32_t* __restrict__ edge_dst,
                        const float* __restrict__ edge_val,
                        const int32_t* __restrict__ start,
                        const int32_t* __restrict__ stop,
                        const uint8_t* __restrict__ rv,
                        int32_t* __restrict__ nb, float* __restrict__ wout,
                        uint8_t* __restrict__ jvalid, int rows, int T,
                        int e_chunk, int R, int max_t2) {
  scan_messages(edge_dst, edge_val, start, stop, rv, nb, wout, jvalid, rows,
                T, e_chunk, R, max_t2);
}

__global__ void __launch_bounds__(SCAN_THREADS, SCAN_BLOCKS_PER_SM)
edge_scan_stream_kernel(const int32_t* __restrict__ edge_dst,
                        const float* __restrict__ edge_val,
                        const int32_t* __restrict__ start,
                        const int32_t* __restrict__ stop,
                        const uint8_t* __restrict__ rv,
                        int32_t* __restrict__ nb, float* __restrict__ wout,
                        uint8_t* __restrict__ jvalid, int rows, int T,
                        int e_chunk, int R, int max_t2) {
  scan_messages(edge_dst, edge_val, start, stop, rv, nb, wout, jvalid, rows,
                T, e_chunk, R, max_t2);
}

// The blocks of a scan of rows * R messages: as many as its teams need, at
// most SCAN_BLOCKS_PER_SM on each SM of the current device.
inline int scan_blocks(int T, int R, int max_t2) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int groups = (max_t2 + 3) / 4;
  const int teams = SCAN_THREADS / (groups < SCAN_THREADS ? groups
                                                          : SCAN_THREADS);
  const long long need = ((long long)T * R + teams - 1) / teams;
  const long long most = (long long)SCAN_BLOCKS_PER_SM * sms;
  return static_cast<int>(need < 1 ? 1 : need < most ? need : most);
}

// ---------------------------------------------------------------------------
// fold_scatter, op="min": replaces fold_scatter / scatter_body (kernel.py:557,
// :204).  out = target, then out[lidx[r]] = min(out[lidx[r]], vals[r]) for
// every valid row r whose lidx is a real slot (the v_chunk trash slot and
// invalid rows contribute the neutral element, i.e. nothing).  The min is
// the order of the floats' bits as fold_order_key gives it (kernel.py
// min_fold): -0.0 below +0.0, and a NaN by its place in the slot's
// sequence (ordered_scatter.cuh nan_ticket), as the reference's min folds
// them; a fold takes at most MIN_FOLD_MAX_ROWS rows a launch.
//
// Bound: bytes — the (v_chunk,) slice is read and written once (8 bytes per
// vertex) and each row is read once (9 bytes).  Design: a grid (T, G) of
// column-owning blocks, G and `step` from kernel.py device_split (as the
// add fold's), so that 64 tiles fill the card (320 blocks at 65,536 slots
// a tile).  Block (t, g) owns the slots [lo, hi) = [g * step, min((g + 1) *
// step, v_chunk)) of tile t:
//   1. one thread starts a bulk copy (cp.async.bulk, TMA) of the range's
//      16-byte-aligned part into shared memory, completing on an mbarrier
//      (a few threads load the cut ends);
//   2. meanwhile every thread loads FM_ROWS of the tile's rows into
//      registers, all in flight: four rows a load (an int4 of slots, a
//      float4 of values, a word of flags) where R is a multiple of 4 and
//      the rows are aligned, since every block of the tile reads all its
//      rows;
//   3. once the copy has landed, each NaN of it becomes its ticket, then
//      the rows whose slot lies in [lo, hi) fold with shared-memory
//      atomics in the integer order (ordered_scatter.cuh atomic_min_f32),
//      each NaN row as its ticket, the next rows likewise;
//   4. the range is written out once, in 16-byte vectors where out's
//      alignment matches the target's, a ticket read back as the NaN of
//      its place.
// The fold is exact in any order, so the atomics give the serial reference's
// bits.  Where step * 4 bytes pass STAGE_SMEM_MAX the same grid folds beside
// the copy instead (min_fold_beside: a copy part copies the range into out
// while the rest gathers the rows in range, then global atomics), with the
// same bits; the wrapper notes the path.  Staging the range in parts, each
// written out as soon as it had landed and been folded, was slower on an H100
// (PERF.md).
// ---------------------------------------------------------------------------
constexpr int FM_THREADS = 512;
constexpr int FM_ROWS = 8;  // rows a thread holds in registers at once
static_assert(FM_ROWS % 4 == 0, "rows come four at a time");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait for the phase of parity 0 of the mbarrier at `bar`; trap after ~1 s
// (a launch error, not a hang).
__device__ __forceinline__ void mbar_wait0(uint32_t bar) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(0u)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 2000000000LL) __trap();
  }
}

struct MinRow {
  int s;  // -1 for an invalid row
  float v;
};

__device__ __forceinline__ bool is_nan4(const float4& v) {
  return repro::is_nan_bits(__float_as_uint(v.x)) |
         repro::is_nan_bits(__float_as_uint(v.y)) |
         repro::is_nan_bits(__float_as_uint(v.z)) |
         repro::is_nan_bits(__float_as_uint(v.w));
}

// Rows r .. r + 3 of a tile (those below R), into x[0..3].
__device__ __forceinline__ void load_min_rows(const int32_t* __restrict__ li,
                                              const float* __restrict__ vx,
                                              const uint8_t* __restrict__ vd,
                                              int r, int R, bool vec,
                                              MinRow* x) {
  if (vec) {  // R % 4 == 0: all four or none
    if (r < R) {
      const int4 q = *reinterpret_cast<const int4*>(li + r);
      const float4 v = *reinterpret_cast<const float4*>(vx + r);
      const uint32_t f = *reinterpret_cast<const uint32_t*>(vd + r);
      x[0] = MinRow{(f & 0xFFu) ? q.x : -1, v.x};
      x[1] = MinRow{(f & 0xFF00u) ? q.y : -1, v.y};
      x[2] = MinRow{(f & 0xFF0000u) ? q.z : -1, v.z};
      x[3] = MinRow{(f & 0xFF000000u) ? q.w : -1, v.w};
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = MinRow{-1, 0.0f};
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    x[e] = r + e < R && vd[r + e] ? MinRow{li[r + e], vx[r + e]}
                                  : MinRow{-1, 0.0f};
}

__global__ void __launch_bounds__(FM_THREADS)
fold_scatter_min_kernel(const float* __restrict__ target,
                        const int32_t* __restrict__ lidx,
                        const float* __restrict__ vals,
                        const uint8_t* __restrict__ valid,
                        float* __restrict__ out, int v_chunk, int R,
                        int step) {
  extern __shared__ __align__(16) float fm_smem[];
  __shared__ __align__(8) unsigned long long bar;
  __shared__ int ticketed;  // a NaN took part: the range holds tickets
  const int t = blockIdx.x;
  const int lo = blockIdx.y * step, hi = min(lo + step, v_chunk);
  const float* tg = target + (size_t)t * v_chunk;
  float* o = out + (size_t)t * v_chunk;
  // slot lo + i is s[i]; s - pre is 16-byte aligned, so the range's
  // aligned part [a, b) lands on aligned shared memory
  const int pre = static_cast<int>((reinterpret_cast<uintptr_t>(tg + lo) &
                                    15) >> 2);
  float* s = fm_smem + pre;
  const int a = min(lo + ((4 - pre) & 3), hi);
  const int b = a + (hi - a) / 4 * 4;
  const uint32_t bytes = static_cast<uint32_t>(b - a) * 4u;
  const uint32_t bar_s = smem_u32(&bar);
  if (threadIdx.x == 0 && bytes > 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_s)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the cut ends [lo, a) and [b, hi): at most 3 slots each; a NaN of them
  // as its ticket (ordered_scatter.cuh)
  bool seen_nan = false;
  if (threadIdx.x < 8) {
    const int i = threadIdx.x < 4 ? lo + threadIdx.x : b + threadIdx.x - 4;
    if (i < (threadIdx.x < 4 ? a : hi)) {
      seen_nan = repro::is_nan_bits(__float_as_uint(tg[i]));
      s[i - lo] = repro::nan_ticket(tg[i], 0, repro::TARGET_NEG);
    }
  }
  if (threadIdx.x == 0) ticketed = 0;
  __syncthreads();  // the barrier's init, the flag and the ends
  if (threadIdx.x == 0 && bytes > 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            bar_s),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(s + (a - lo))),
        "l"(tg + a), "r"(bytes), "r"(bar_s)
        : "memory");
  }
  const int32_t* li = lidx + (size_t)t * R;
  const float* vx = vals + (size_t)t * R;
  const uint8_t* vd = valid + (size_t)t * R;
  const bool vec = (R & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(li) |
                     reinterpret_cast<uintptr_t>(vx)) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(vd) & 3) == 0;
  for (int r0 = 0;; r0 += FM_THREADS * FM_ROWS) {
    MinRow x[FM_ROWS];
#pragma unroll
    for (int u = 0; u < FM_ROWS; u += 4)
      load_min_rows(li, vx, vd, r0 + 4 * (u / 4 * FM_THREADS + threadIdx.x),
                    R, vec, x + u);
    if (r0 == 0) {
      if (bytes > 0) mbar_wait0(bar_s);  // the staging has landed
      // each NaN of the aligned part as its ticket, four slots a load
      float4* s4 = reinterpret_cast<float4*>(s + (a - lo));
      for (int i = threadIdx.x; 4 * i < b - a; i += FM_THREADS) {
        const float4 v = s4[i];
        if (is_nan4(v)) {
          seen_nan = true;
          s4[i] = make_float4(repro::nan_ticket(v.x, 0, repro::TARGET_NEG),
                              repro::nan_ticket(v.y, 0, repro::TARGET_NEG),
                              repro::nan_ticket(v.z, 0, repro::TARGET_NEG),
                              repro::nan_ticket(v.w, 0, repro::TARGET_NEG));
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < FM_ROWS; ++u)
      if (x[u].s >= lo && x[u].s < hi) {
        seen_nan |= repro::is_nan_bits(__float_as_uint(x[u].v));
        repro::atomic_min_f32(
            s + (x[u].s - lo),
            repro::row_ticket(
                x[u].v, r0 + 4 * (u / 4 * FM_THREADS + threadIdx.x) + u % 4));
      }
    if (r0 + FM_THREADS * FM_ROWS >= R) break;
  }
  if (seen_nan) ticketed = 1;
  __syncthreads();
  // out[lo:hi) = s: vectors where out + a is aligned as tg + a is; where a
  // NaN took part, each ticket read back as the NaN of its place
  const bool vec_out = (reinterpret_cast<uintptr_t>(o + a) & 15) == 0;
  const int v_lo = vec_out ? a : hi, v_hi = vec_out ? b : hi;
  const auto write_out = [&](auto slot) {
    for (int i = threadIdx.x; 4 * i < v_hi - v_lo; i += FM_THREADS) {
      const float4 v = reinterpret_cast<const float4*>(s + (v_lo - lo))[i];
      const int j = v_lo + 4 * i;
      reinterpret_cast<float4*>(o + v_lo)[i] =
          make_float4(slot(v.x, j), slot(v.y, j + 1), slot(v.z, j + 2),
                      slot(v.w, j + 3));
    }
    for (int i = lo + threadIdx.x; i < hi; i += FM_THREADS)
      if (i < v_lo || i >= v_hi) o[i] = slot(s[i - lo], i);
  };
  if (ticketed)
    write_out([&](float x, int i) {
      const int p = repro::ticket_place(x);
      return p < 0 ? x : p == 0 ? tg[i] : vx[p - 1];
    });
  else
    write_out([](float x, int) { return x; });
}

// The same fold past the staging: min_fold_beside over the same grid.
static_assert(FM_THREADS > repro::COPY_THREADS, "two parts a block");

__global__ void __launch_bounds__(FM_THREADS)
fold_scatter_min_beside_kernel(const float* __restrict__ target,
                               const int32_t* __restrict__ lidx,
                               const float* __restrict__ vals,
                               const uint8_t* __restrict__ valid,
                               float* __restrict__ out, int v_chunk, int R,
                               int step) {
  extern __shared__ __align__(16) unsigned char fmb_smem[];
  const int t = blockIdx.x;
  const int lo = blockIdx.y * step, hi = min(lo + step, v_chunk);
  float* o = out + (size_t)t * v_chunk;
  const float* tg = target + (size_t)t * v_chunk;
  const int32_t* li = lidx + (size_t)t * R;
  const float* vx = vals + (size_t)t * R;
  const uint8_t* vd = valid + (size_t)t * R;
  repro::min_fold_beside(o, tg, lo, hi, R, fmb_smem, [&](int r) {
    const float x = vx[r];  // read whatever the flag, beside it
    return repro::SlotValue{vd[r] ? li[r] : -1, x};
  });
}

// ---------------------------------------------------------------------------
// fold_scatter, op="add": replaces fold_scatter / scatter_body (kernel.py:557,
// :204) for the accumulations (SpMV, PageRank, k-core, triangles).  out =
// target, then every row r with a real slot lidx[r] adds (valid[r] ? vals[r]
// : 0) onto out[lidx[r]], each slot's rows in increasing r: the serial order
// of XLA's scatter, bit for bit (float addition is not associative, so an
// atomicAdd would change the bits from run to run).  An invalid row on a
// real slot still adds +0.0, as the reference's masked scatter does (a
// -0.0 target becomes +0.0); the trash slot v_chunk lies outside every
// block's range.
//
// Bound: bytes — as the min fold: the slice read and written once, each row
// read once.  Design: scatter_segments' (../../scatter_update/csrc/
// scatter_segments.cu), over a grid (T, G) of column-owning blocks, G and
// `step` from kernel.py device_split, so that 64 tiles still fill the
// card (G = 5 at 65,536 slots a tile: 320 blocks).  Block (t, g) owns the
// slots [g * step, min((g + 1) * step, v_chunk)) of tile t
// (add_fold_beside, ordered_scatter.cuh): its copy part copies that range
// of the target while the rest count the tile's rows in range a slot; then
// the whole block adds at once each row that is its slot's only one, and
// sorts the (slot, row) keys of the others and adds each slot's run in row
// order (past FOLD_ADD_MAX_ROWS rows, chunk by chunk in row order).  Every
// write lands in the block's own range.
// ---------------------------------------------------------------------------
constexpr int FA_THREADS = 512;
static_assert(FA_THREADS > repro::COPY_THREADS, "two parts a block");

__global__ void __launch_bounds__(FA_THREADS)
fold_scatter_add_kernel(const float* __restrict__ target,
                        const int32_t* __restrict__ lidx,
                        const float* __restrict__ vals,
                        const uint8_t* __restrict__ valid,
                        float* __restrict__ out, int v_chunk, int R,
                        int step) {
  extern __shared__ __align__(16) unsigned char fa_smem[];
  const int t = blockIdx.x;
  const int lo = blockIdx.y * step, hi = min(lo + step, v_chunk);
  float* o = out + (size_t)t * v_chunk;
  const float* tg = target + (size_t)t * v_chunk;
  const int32_t* li = lidx + (size_t)t * R;
  const float* vx = vals + (size_t)t * R;
  const uint8_t* vd = valid + (size_t)t * R;
  repro::add_fold_beside(
      o, lo, hi, step, R, fa_smem,
      [&](int r) {
        const float x = vx[r];  // read whatever the flag, beside it
        return repro::SlotValue{li[r], vd[r] ? x : 0.0f};
      },
      [&](const repro::Team& part) {
        repro::copy_range(tg, o, lo, hi, part);
      });
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// G column ranges of `step` bytes a tile (kernel.py device_split).
int repro_frontier_pop(const void* mask, const void* k, void* idx,
                       void* valid, void* rem, int T, int n, int k_max,
                       int G, int step, void* stream) {
  if (!repro::valid_split(n, G, step))
    return static_cast<int>(cudaErrorInvalidValue);
  frontier_pop_kernel<<<dim3(T, G), FP_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(k),
      static_cast<int32_t*>(idx), static_cast<uint8_t*>(valid),
      static_cast<uint8_t*>(rem), n, k_max, step);
  return static_cast<int>(cudaGetLastError());
}

// The fresh-row indices in dynamic shared memory, or past STAGE_SMEM_MAX
// bytes in `scratch`, n ints a tile; G blocks a tile move the old rows.
int repro_queue_push_pop(const void* data, const void* count, const void* rows,
                         const void* pvalid, const void* npop, void* taken,
                         void* tvalid, void* ndata, void* ncount, void* drops,
                         void* scratch, int T, int G, int cap, int w, int n,
                         int max_n, void* stream) {
  const bool in_scratch = (size_t)n * sizeof(int) > repro::STAGE_SMEM_MAX;
  const size_t smem = in_scratch ? 0 : (size_t)n * sizeof(int);
  if (n < 0 || G < 1 || (in_scratch && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        queue_push_pop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  queue_push_pop_kernel<<<dim3(T, G + 1), QP_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(data), static_cast<const int32_t*>(count),
      static_cast<const int32_t*>(rows), static_cast<const uint8_t*>(pvalid),
      static_cast<const int32_t*>(npop), static_cast<int32_t*>(taken),
      static_cast<uint8_t*>(tvalid), static_cast<int32_t*>(ndata),
      static_cast<int32_t*>(ncount), static_cast<int32_t*>(drops),
      in_scratch ? static_cast<int*>(scratch) : nullptr, cap, w, n, max_n);
  return static_cast<int>(cudaGetLastError());
}

int repro_edge_scan_gather(const void* edge_dst, const void* edge_val,
                           const void* start, const void* stop, const void* rv,
                           void* nb, void* w, void* jvalid, int rows, int T,
                           int e_chunk, int R, int max_t2, void* stream) {
  if (T < 1 || rows % T) return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)rows * R == 0 || max_t2 == 0)
    return static_cast<int>(cudaSuccess);
  if (e_chunk < 1 || max_t2 < 0 || (long long)rows * R >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  edge_scan_gather_kernel<<<scan_blocks(rows, R, max_t2), SCAN_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(edge_dst),
      static_cast<const float*>(edge_val), static_cast<const int32_t*>(start),
      static_cast<const int32_t*>(stop), static_cast<const uint8_t*>(rv),
      static_cast<int32_t*>(nb), static_cast<float*>(w),
      static_cast<uint8_t*>(jvalid), rows, T, e_chunk, R, max_t2);
  return static_cast<int>(cudaGetLastError());
}

// Any window of at least max_t2: the same lanes as the gather's.
int repro_edge_scan_stream(const void* edge_dst, const void* edge_val,
                           const void* start, const void* stop, const void* rv,
                           void* nb, void* w, void* jvalid, int rows, int T,
                           int e_chunk, int R, int max_t2, int window,
                           void* stream) {
  if (window < 1 || window < max_t2 || T < 1 || rows % T)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)rows * R == 0 || max_t2 == 0)
    return static_cast<int>(cudaSuccess);
  if (e_chunk < 1 || max_t2 < 0 || (long long)rows * R >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  edge_scan_stream_kernel<<<scan_blocks(rows, R, max_t2), SCAN_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(edge_dst),
      static_cast<const float*>(edge_val), static_cast<const int32_t*>(start),
      static_cast<const int32_t*>(stop), static_cast<const uint8_t*>(rv),
      static_cast<int32_t*>(nb), static_cast<float*>(w),
      static_cast<uint8_t*>(jvalid), rows, T, e_chunk, R, max_t2);
  return static_cast<int>(cudaGetLastError());
}

// The ordered add in row-order chunks of FOLD_ADD_MAX_ROWS rows, over G
// column ranges of `step` slots a tile.
int repro_fold_scatter_add(const void* target, const void* lidx,
                           const void* vals, const void* valid, void* out,
                           int T, int v_chunk, int R, int G, int step,
                           void* stream) {
  if (!repro::valid_split(v_chunk, G, step))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = repro::ordered_add_smem(R, step);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fold_scatter_add_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fold_scatter_add_kernel<<<dim3(T, G), FA_THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(target), static_cast<const int32_t*>(lidx),
      static_cast<const float*>(vals), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), v_chunk, R, step);
  return static_cast<int>(cudaGetLastError());
}

// G column ranges of `step` slots a tile, each staged in shared memory up
// to STAGE_SMEM_MAX bytes, else folded beside its copy.
int repro_fold_scatter_min(const void* target, const void* lidx,
                           const void* vals, const void* valid, void* out,
                           int T, int v_chunk, int R, int G, int step,
                           void* stream) {
  if (!repro::valid_split(v_chunk, G, step) || R > repro::MIN_FOLD_MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool staged = (size_t)step * sizeof(float) <= repro::STAGE_SMEM_MAX;
  const size_t smem = staged ? ((size_t)step + 4) * sizeof(float)
                             : repro::min_fold_smem(R);
  const void* fn = staged ? (const void*)fold_scatter_min_kernel
                          : (const void*)fold_scatter_min_beside_kernel;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(T, G);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* tg = static_cast<const float*>(target);
  const int32_t* li = static_cast<const int32_t*>(lidx);
  const float* vx = static_cast<const float*>(vals);
  const uint8_t* vd = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(out);
  if (staged)
    fold_scatter_min_kernel<<<grid, FM_THREADS, smem, st>>>(
        tg, li, vx, vd, o, v_chunk, R, step);
  else
    fold_scatter_min_beside_kernel<<<grid, FM_THREADS, smem, st>>>(
        tg, li, vx, vd, o, v_chunk, R, step);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
