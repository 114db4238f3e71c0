// Device code of the engine round's kernels, shared by the standalone
// kernels (engine_kernels.cu) and the fused legs (fused_legs.cu).  Each
// function is one pure body of src/repro/kernels/engine/kernel.py, run by
// one block (or one warp) for one tile, and writes what that body writes,
// don't-care slots included, but for fifo_live_turn, which writes a turned
// queue's live rows only (queue_push_pop and the fused legs turn their
// queues with it; no kernel shifts a whole queue).
//
// Integer arithmetic follows torch's on int32 tensors: // and % round
// toward negative infinity (floor_div, floor_mod) and + and * wrap (done
// in unsigned arithmetic, where C's signed overflow would be undefined).
// Float arithmetic uses the _rn intrinsics, so no contraction into an FMA
// can change a bit; bitcasts are __int_as_float / __float_as_int (the
// reference's f2i / i2f, src/repro/core/queues.py:29).
//
// Bools are torch.bool tensors: one byte each, 0 or 1.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// The thresholds between a kernel's two paths (kernels/engine/kernel.py
// reads them from here).  Fused leg 1 over a streamed shard stages a
// warp's 2 * window (dst, val) pairs in shared memory up to
// STREAM_MAX_WINDOW and reads a wider window from device memory (the
// standalone edge_scan_stream stages nothing).  queue_push_pop's fresh-row indices and the
// fused legs' popped rows take dynamic shared memory up to STAGE_SMEM_MAX
// bytes a block (of the 227 KiB a block may opt in to), and past it a
// device-memory scratch that the wrapper allocates.
constexpr int STREAM_MAX_WINDOW = 2048;
constexpr size_t STAGE_SMEM_MAX = 204800;

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// Block-wide exclusive prefix sum of one int per thread (blockDim.x a
// multiple of 32, at most 1024; every thread of the block calls it).
// Returns the thread's exclusive prefix and the block total in *total.
// `sm` is 33 ints of shared memory; the trailing barrier makes it safe to
// call again at once.
__device__ inline int block_excl_scan(int v, int* total, int* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sm[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nwarps ? sm[lane] : 0;
    int s = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    sm[lane] = s - w;        // exclusive offset of warp `lane`
    if (lane == 31) sm[32] = s;
  }
  __syncthreads();
  const int res = x - v + sm[warp];
  *total = sm[32];
  __syncthreads();
  return res;
}

__device__ inline int block_sum(int v, int* sm) {
  int total;
  block_excl_scan(v, &total, sm);
  return total;
}

// ---------------------------------------------------------------------------
// frontier_take (kernel.py:77): the first min(k, popcount) set bits of one
// tile's (n,) bitmap m, in position order.  ix[rank] = position for the
// taken bits and 0 in the slots from n_take to k_max; r = m with exactly the
// taken bits cleared.  Returns n_take (block-uniform); ix is complete once
// the caller has passed a barrier.  k <= k_max.
//
// The block walks the bitmap in passes of blockDim.x * FT_VECS * 16 bytes,
// each thread owning FT_VECS * 16 consecutive bytes, read together as
// FT_VECS 16-byte vectors before one block scan of the per-thread popcounts
// gives each thread the rank of its first set bit (so a pass costs one load
// latency and one scan: 64 KiB at 1024 threads).  Once k bits are ranked
// the block only copies.
// ---------------------------------------------------------------------------
constexpr int FT_BYTES = 16;
constexpr int FT_VECS = 4;

union Bytes16 {
  uint4 v;
  uint8_t b[FT_BYTES];
};

__device__ inline int frontier_take_block(const uint8_t* __restrict__ m,
                                          uint8_t* __restrict__ r, int n,
                                          int k, int k_max, int32_t* ix,
                                          int* sm) {
  constexpr int SPAN = FT_VECS * FT_BYTES;  // a thread's bytes a pass
  const bool vec =
      ((reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(r)) &
       (FT_BYTES - 1)) == 0;
  int seen = 0;  // set bits ranked so far; identical in every thread
  for (int base = 0; base < n; base += blockDim.x * SPAN) {
    const int p0 = base + threadIdx.x * SPAN;
    Bytes16 u[FT_VECS];
#pragma unroll
    for (int q = 0; q < FT_VECS; ++q) {
      const int p = p0 + q * FT_BYTES;
      if (vec && p + FT_BYTES <= n) {
        u[q].v = *reinterpret_cast<const uint4*>(m + p);
      } else {
#pragma unroll
        for (int i = 0; i < FT_BYTES; ++i) u[q].b[i] = p + i < n ? m[p + i] : 0;
      }
    }
    if (seen < k) {  // block-uniform branch
      int cnt = 0;
#pragma unroll
      for (int q = 0; q < FT_VECS; ++q)
#pragma unroll
        for (int i = 0; i < FT_BYTES; ++i) cnt += u[q].b[i] != 0;
      int total;
      int rank = seen + block_excl_scan(cnt, &total, sm);
#pragma unroll
      for (int q = 0; q < FT_VECS; ++q) {
        const uint32_t w[4] = {u[q].v.x, u[q].v.y, u[q].v.z, u[q].v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (w[j] == 0 || rank >= k) continue;
#pragma unroll
          for (int i = 4 * j; i < 4 * j + 4; ++i) {
            if (u[q].b[i]) {
              if (rank < k) {
                if (rank < k_max) ix[rank] = p0 + q * FT_BYTES + i;
                u[q].b[i] = 0;
              }
              ++rank;
            }
          }
        }
      }
      seen += total;
    }
#pragma unroll
    for (int q = 0; q < FT_VECS; ++q) {
      const int p = p0 + q * FT_BYTES;
      if (vec && p + FT_BYTES <= n) {
        *reinterpret_cast<uint4*>(r + p) = u[q].v;
      } else {
        for (int i = 0; i < FT_BYTES; ++i)
          if (p + i < n) r[p + i] = u[q].b[i];
      }
    }
  }
  int n_take = seen < k ? seen : k;
  if (n_take < 0) n_take = 0;
  for (int j = threadIdx.x; j < k_max; j += blockDim.x)
    if (j >= n_take) ix[j] = 0;  // disjoint from the ranked writes above
  return n_take;
}

// ---------------------------------------------------------------------------
// fifo_turn's live rows (kernel.py:95), without its whole-capacity shift:
// a pop of n_pop rows off the front of the (cap, W) queue d moves its
// live rows [n_pop, c) to [0, c - n_pop) of the turned queue nd, nd[i] =
// d[i + n_pop]; this call moves the rows i in [lo, hi) (hi + n_pop <= c),
// the caller splitting the live rows over blocks.  The slots from the new
// count on are not written: fifo_turn makes them don't-care, and every
// consumer reads a queue below its count (queue_append writes slots from
// the count on; a popped row past the count is an invalid message, and
// bin_by_owner sends invalid rows to its trash slot).  So the bytes follow
// the queue's occupancy, not its capacity.  Fresh rows appended before the
// pop are the caller's to place (they land at c - n_pop on).  d and nd are
// different buffers.  Rows of W = 2 or 4 words move as one 8- or 16-byte
// vector each (a queue's tiles lie at multiples of its row size), rows of 3
// words (the range queue) word by word; ROW_MOVES moves of a thread in
// flight together.
// ---------------------------------------------------------------------------
template <int W>
struct RowVec;
template <>
struct RowVec<2> {
  using T = int2;
};
template <>
struct RowVec<4> {
  using T = int4;
};
constexpr int ROW_MOVES = 4;

template <int W>
__device__ inline void fifo_live_turn(const int32_t* __restrict__ d,
                                      int32_t* __restrict__ nd, int n_pop,
                                      int lo, int hi, int tid, int nthreads) {
  using V = typename RowVec<W>::T;
  const V* dv = reinterpret_cast<const V*>(d) + n_pop;
  V* nv = reinterpret_cast<V*>(nd);
  for (int i0 = lo + tid; i0 < hi; i0 += ROW_MOVES * nthreads) {
    V x[ROW_MOVES];
#pragma unroll
    for (int u = 0; u < ROW_MOVES; ++u)
      if (i0 + u * nthreads < hi) x[u] = dv[i0 + u * nthreads];
#pragma unroll
    for (int u = 0; u < ROW_MOVES; ++u)
      if (i0 + u * nthreads < hi) nv[i0 + u * nthreads] = x[u];
  }
}

// rows of 3 words (the range queue): the words [3 lo, 3 hi) of the rows
// past the pop
template <>
__device__ inline void fifo_live_turn<3>(const int32_t* __restrict__ d,
                                         int32_t* __restrict__ nd, int n_pop,
                                         int lo, int hi, int tid,
                                         int nthreads) {
  const int32_t* dw = d + (size_t)n_pop * 3;
  for (int i0 = 3 * lo + tid; i0 < 3 * hi; i0 += ROW_MOVES * nthreads) {
    int32_t x[ROW_MOVES];
#pragma unroll
    for (int u = 0; u < ROW_MOVES; ++u)
      if (i0 + u * nthreads < 3 * hi) x[u] = dw[i0 + u * nthreads];
#pragma unroll
    for (int u = 0; u < ROW_MOVES; ++u)
      if (i0 + u * nthreads < 3 * hi) nd[i0 + u * nthreads] = x[u];
  }
}

// ---------------------------------------------------------------------------
// queue_append (kernel.py:123; the port's queue_push): the valid rows of
// rows (n, w), in row order, go to slots count, count + 1, ... of the
// (cap, w) queue q while the slot is < cap.  q may be the caller's queue
// itself (the fold legs append in place) or a copy that the block made
// (visible to it); only slots count .. cap - 1 are written.  Rows are at
// most APPEND_MAX_W words wide.  Each thread takes FT_BYTES consecutive rows
// a step (their flags one 16-byte vector where aligned), so a block scan
// ranks blockDim.x * FT_BYTES rows.
// Returns the number of valid rows (block-uniform); the caller's pushes are
// min(that, max(cap - count, 0)), the rest drops.
// ---------------------------------------------------------------------------
constexpr int APPEND_BATCH = 4;  // rows copied together
constexpr int APPEND_MAX_W = 4;  // the widest queue row

__device__ inline int queue_append_block(int32_t* q, int cap, int w,
                                         int count, const int32_t* rows,
                                         const uint8_t* valid, int n,
                                         int* sm) {
  const bool vec = (reinterpret_cast<uintptr_t>(valid) & (FT_BYTES - 1)) == 0;
  int nvalid = 0;
  for (int base = 0; base < n; base += blockDim.x * FT_BYTES) {
    const int r0 = base + threadIdx.x * FT_BYTES;
    Bytes16 u;
    if (vec && r0 + FT_BYTES <= n) {
      u.v = *reinterpret_cast<const uint4*>(valid + r0);
    } else {
#pragma unroll
      for (int i = 0; i < FT_BYTES; ++i)
        u.b[i] = r0 + i < n ? valid[r0 + i] : 0;
    }
    unsigned mask = 0;  // bit i: row r0 + i is valid
#pragma unroll
    for (int i = 0; i < FT_BYTES; ++i) mask |= (u.b[i] != 0 ? 1u : 0u) << i;
    int total;
    int pos = count + nvalid + block_excl_scan(__popc(mask), &total, sm);
    // the thread's valid rows, APPEND_BATCH at a time: their words read
    // together, then written
    while (mask != 0 && pos < cap) {
      int src[APPEND_BATCH];
      int k = 0;
#pragma unroll
      for (int j = 0; j < APPEND_BATCH; ++j) {
        src[j] = mask != 0 ? r0 + __ffs(mask) - 1 : -1;
        if (mask != 0) ++k;
        mask &= mask - 1;
      }
      int32_t x[APPEND_BATCH][APPEND_MAX_W];
#pragma unroll
      for (int j = 0; j < APPEND_BATCH; ++j)
#pragma unroll
        for (int c = 0; c < APPEND_MAX_W; ++c)
          if (src[j] >= 0 && c < w) x[j][c] = rows[(size_t)src[j] * w + c];
#pragma unroll
      for (int j = 0; j < APPEND_BATCH; ++j)
#pragma unroll
        for (int c = 0; c < APPEND_MAX_W; ++c)
          if (src[j] >= 0 && c < w && pos + j < cap)
            q[(size_t)(pos + j) * w + c] = x[j][c];
      pos += k;
    }
    nvalid += total;
  }
  return nvalid;
}

// ---------------------------------------------------------------------------
// segment_gather (kernel.py:141) and segment_stream (kernel.py:157): lane j
// of one range message [s, stop) of a tile.  An invalid message has length
// 0 and local offset 0; valid lanes are those with j < length and dst >= 0.
// ---------------------------------------------------------------------------
struct Lane {
  int32_t dst;
  float w;
  bool valid;
};

__device__ __forceinline__ void message_bounds(bool v, int s, int stop,
                                               int e_chunk, int* length,
                                               int* local0) {
  *length = v ? wrap_add(stop, -s) : 0;
  *local0 = v ? floor_mod(s, e_chunk) : 0;
}

// The resident gather: the shard word at min(local0 + j, e_chunk - 1).
__device__ __forceinline__ Lane gather_lane(const int32_t* __restrict__ ed,
                                            const float* __restrict__ ev,
                                            int e_chunk, int length,
                                            int local0, int j) {
  const int ei = local0 + j < e_chunk - 1 ? local0 + j : e_chunk - 1;
  const int32_t dst = ed[ei];
  return Lane{dst, ev[ei], j < length && dst >= 0};
}

// Fused leg 1's stream: one warp stages the two aligned windows that cover
// a message, sd/sv[k] = shard[min(base + k, e_chunk - 1)] for k < 2 *
// window, with base = local0 / window * window (local0 >= 0).  The caller
// __syncwarp()s before reading the staging buffer and again before
// restaging it.
__device__ __forceinline__ int stage_windows(const int32_t* __restrict__ ed,
                                             const float* __restrict__ ev,
                                             int e_chunk, int local0,
                                             int window, int32_t* sd,
                                             float* sv) {
  const int base = local0 / window * window;
  for (int k = threadIdx.x & 31; k < 2 * window; k += 32) {
    const int si = base + k < e_chunk - 1 ? base + k : e_chunk - 1;
    sd[k] = ed[si];
    sv[k] = ev[si];
  }
  return base;
}

// Lane j out of the staging buffer only, at min(local0 - base + j,
// 2 * window - 1).
__device__ __forceinline__ Lane stream_lane(const int32_t* sd, const float* sv,
                                            int window, int length,
                                            int local0, int base, int j) {
  const int off0 = local0 - base + j;
  const int off = off0 < 2 * window - 1 ? off0 : 2 * window - 1;
  const int32_t dst = sd[off];
  return Lane{dst, sv[off], j < length && dst >= 0};
}

// The same lane of a window too wide to stage: the shard word the staging
// buffer would hold at that offset, shard[min(base + off, e_chunk - 1)],
// read from device memory (base = local0 / window * window).
__device__ __forceinline__ Lane stream_lane_global(
    const int32_t* __restrict__ ed, const float* __restrict__ ev, int e_chunk,
    int window, int length, int local0, int j) {
  const int base = local0 / window * window;
  const int off0 = local0 - base + j;
  const int off = off0 < 2 * window - 1 ? off0 : 2 * window - 1;
  const int si = base + off < e_chunk - 1 ? base + off : e_chunk - 1;
  const int32_t dst = ed[si];
  return Lane{dst, ev[si], j < length && dst >= 0};
}

}  // namespace repro
