// Device code shared by the T3 folds (engine_kernels.cu, fused_legs.cu) and
// the binned segment scatter (../../scatter_update/csrc/scatter_segments.cu):
// one block folds R rows into a range [lo, hi) of one slice of float slots,
// the range lying in device memory and owned by that block alone (the whole
// slice, or one column range of it when a grid (slices, G) splits each
// slice over G blocks).
//
// The add keeps the serial order of the reference (XLA's scatter, and
// scatter_ref's loop): slot s ends as target[s] + v[r1] + v[r2] + ... over
// its rows r1 < r2 < ... .  The block gathers the (slot, row) pairs of the
// rows whose slot lies in its range into shared memory, one 64-bit key each
// (slot in the high word, row in the low word, so keys are unique and the
// sort needs no stability), sorts them, then the first thread of each run
// of one slot adds the run in row order.  The adds are __fadd_rn, so no
// contraction can change a bit.  Rows past what shared memory holds are
// taken in row-order chunks of FOLD_ADD_MAX_ROWS rows: chunk c is gathered,
// sorted and added before chunk c + 1, so each slot's adds keep row order
// across chunks too.
//
// The min folds with integer atomics in the order of the floats (-0.0
// below +0.0), a NaN ranked by its place in the slot's sequence (a
// ticket, below), so no order in which the atomics land changes a bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr unsigned long long kNoKey = ~0ull;  // padding: sorts last

__host__ __device__ inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// A fold block whose range holds at most SINGLE_MAX_SLOTS slots counts the
// rows of each slot of a chunk first (16-bit counters, two a word: a chunk
// has at most FOLD_ADD_MAX_ROWS rows), and adds the rows of a slot that has one
// in the chunk at once, sorting only the others (add_fold_beside).
constexpr int SINGLE_MAX_SLOTS = 16384;
// The most rows one chunk of an ordered add sorts in shared memory: 12
// bytes a row, beside the counters of SINGLE_MAX_SLOTS slots, in the 227
// KiB a block may opt in to.  kernels/engine/kernel.py reads it from here.
constexpr int FOLD_ADD_MAX_ROWS = 16384;

// The rows of one chunk of an ordered add of R rows.
__host__ __device__ inline int chunk_rows(int R) {
  return R < FOLD_ADD_MAX_ROWS ? R : FOLD_ADD_MAX_ROWS;
}

// Shared memory an ordered add of R rows needs: a
// chunk's padded keys, its values and the count of its rows in range; and,
// for a fold block of `slots` slots (at most SINGLE_MAX_SLOTS), their
// counters.  All of it is dynamic shared memory, so that the callers' test
// of its size against the default 48 KiB is the whole test.
__host__ __device__ inline size_t ordered_add_smem(int R, int slots) {
  const int C = chunk_rows(R);
  const int P = next_pow2(C > 0 ? C : 1);
  const size_t counters =
      slots <= SINGLE_MAX_SLOTS ? (size_t)(slots + 1) / 2 * 4 : 0;
  return (size_t)P * sizeof(unsigned long long) + (size_t)P * sizeof(float) +
         16 + counters;
}

// The min fold gathers its rows in range MIN_CHUNK at a time, one 8-byte
// entry each, then their count.
constexpr int MIN_CHUNK = 4096;

__host__ __device__ inline size_t min_fold_smem(int R) {
  const int C = R < MIN_CHUNK ? (R > 0 ? R : 1) : MIN_CHUNK;
  return (size_t)C * sizeof(unsigned long long) + 16;
}

// A split of n slots into G column ranges of `step` slots, block g owning
// [g * step, min((g + 1) * step, n)) (kernels/engine/kernel.py
// column_split): step a multiple of 4 when G > 1 (the ranges start on
// 16-byte vectors), and no range empty.
inline bool valid_split(int n, int G, int step) {
  return G >= 1 && step >= 1 && (G == 1 || step % 4 == 0) &&
         (long long)(G - 1) * step < (n > 0 ? n : 1);
}

// Some warps of the block: the whole block, or one of two parts of it,
// with the thread's index in the team, the team's size and its barrier
// (0: __syncthreads; a part syncs on a named barrier of its own).
struct Team {
  int tid, size, bar;
  __device__ void sync() const {
    if (bar == 0)
      __syncthreads();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(size) : "memory");
  }
};

__device__ inline Team whole_block() {
  return Team{static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x), 0};
}

// The folds split a block in two parts that work at once: the first
// COPY_THREADS threads copy the block's range of the target (a stream of
// device memory), the rest gather and sort the rows in range (reads of the
// rows and work in shared memory).  blockDim.x must exceed COPY_THREADS.
constexpr int COPY_THREADS = 256;

__device__ inline Team block_part() {
  const int t = static_cast<int>(threadIdx.x);
  return t < COPY_THREADS
             ? Team{t, COPY_THREADS, 1}
             : Team{t - COPY_THREADS,
                    static_cast<int>(blockDim.x) - COPY_THREADS, 2};
}

// out[i] = map(src[i]) for lo <= i < hi, by the threads of team `tm`, with
// 16-byte vectors when src + lo and out + lo are aligned (the last
// (hi - lo) % 4 elements one by one), each thread keeping COPY_UNROLL loads
// in flight.  Returns whether map changed the bits of an element that this
// thread copied.
constexpr int COPY_UNROLL = 4;

struct Same {
  __device__ float operator()(float x) const { return x; }
};

template <class Map = Same>
__device__ inline bool copy_range(const float* __restrict__ src,
                                  float* __restrict__ out, int lo, int hi,
                                  const Team& tm, Map map = Map()) {
  const float* s = src + lo;
  float* o = out + lo;
  const int n = hi - lo;
  const bool vec = ((reinterpret_cast<uintptr_t>(s) |
                     reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  const int n4 = vec ? n / 4 : 0;
  const float4* s4 = reinterpret_cast<const float4*>(s);
  float4* o4 = reinterpret_cast<float4*>(o);
  bool changed = false;
  const auto put = [&](float x) {
    const float y = map(x);
    changed |= __float_as_uint(y) != __float_as_uint(x);
    return y;
  };
  for (int base = tm.tid; base < n4; base += COPY_UNROLL * tm.size) {
    float4 v[COPY_UNROLL];
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) {
      const int i = base + u * tm.size;
      if (i < n4) v[u] = s4[i];
    }
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) {
      const int i = base + u * tm.size;
      if (i < n4)
        o4[i] = make_float4(put(v[u].x), put(v[u].y), put(v[u].z),
                            put(v[u].w));
    }
  }
  for (int i = 4 * n4 + tm.tid; i < n; i += tm.size) o[i] = put(s[i]);
  return changed;
}

// The min folds' integer order: a set sign bit ranks above a clear one,
// then a larger unsigned value (a more negative float) above a smaller
// one; a clear sign bit, a smaller int above a larger one.  So -0.0 folds
// below +0.0, as the JAX package's min does.
__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  const int bits = __float_as_int(v);
  if (bits >= 0)
    atomicMin(reinterpret_cast<int*>(addr), bits);
  else
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

// NaN, as the JAX package folds it (kernels/engine/kernel.py
// fold_order_key): a slot ends as the first NaN with a clear sign bit of
// its sequence (the target, then the rows in row order), else as the last
// NaN with a set one, else as the least number.  The fold folds, for a
// NaN, its ticket t instead: the bits 0xffffffff - t, a NaN with a set
// sign bit that the order above ranks over every number (those lie at or
// below -inf, 0xff800000) and over every larger t:
//   t = 0                              the target's NaN, sign clear;
//   t = 1 + r                          row r's NaN, sign clear;
//   t = 2 * MIN_FOLD_MAX_ROWS - r      row r's NaN, sign set;
//   t = 2 * MIN_FOLD_MAX_ROWS + 1      the target's NaN, sign set.
// So the least t wins, whatever order the atomics land in.  The target is
// ticketed as it is staged or copied (nan_ticket(v, 0, TARGET_NEG)), each
// row as it folds, and a slot's ticket is read back as the NaN of its
// place when the slot is written (ticket_place).  A fold takes at most
// MIN_FOLD_MAX_ROWS rows, so that every t lies above -inf's bits.
constexpr int MIN_FOLD_MAX_ROWS = 4194302;  // 2^22 - 2
constexpr int TARGET_NEG = 2 * MIN_FOLD_MAX_ROWS + 1;

__device__ __forceinline__ bool is_nan_bits(unsigned u) {
  return (u & 0x7fffffffu) > 0x7f800000u;
}

// v, or the ticket of a NaN v: pos if its sign bit is clear, else neg.
__device__ __forceinline__ float nan_ticket(float v, int pos, int neg) {
  const unsigned u = __float_as_uint(v);
  if (!is_nan_bits(u)) return v;
  return __uint_as_float(0xffffffffu -
                         static_cast<unsigned>(static_cast<int>(u) >= 0
                                                   ? pos
                                                   : neg));
}

// Row r's value as it folds.
__device__ __forceinline__ float row_ticket(float v, int r) {
  return nan_ticket(v, 1 + r, 2 * MIN_FOLD_MAX_ROWS - r);
}

// The place a folded slot's ticket names: -1 for a number, 0 for the
// target, 1 + r for row r.
__device__ __forceinline__ int ticket_place(float x) {
  const unsigned u = __float_as_uint(x);
  if (!is_nan_bits(u)) return -1;
  const int t = static_cast<int>(0xffffffffu - u);
  if (t == 0 || t == TARGET_NEG) return 0;
  return t <= MIN_FOLD_MAX_ROWS ? t : 2 * MIN_FOLD_MAX_ROWS - t + 1;
}

// Ascending bitonic sort of n keys in shared memory (n a power of two) by
// team `tm`: each step compares n / 2 pairs (i, i | j), i without bit j,
// every thread taking whole pairs.
__device__ inline void block_sort(unsigned long long* key, int n,
                                  const Team& tm) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = tm.tid; q < n / 2; q += tm.size) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int p = i | j;
        const unsigned long long a = key[i], b = key[p];
        if ((a > b) == ((i & k) == 0)) {
          key[i] = b;
          key[p] = a;
        }
      }
      tm.sync();
    }
  }
}

// For the rows i < R, ROW_UNROLL of them a thread of team `tm` at a time:
// load(i) for all of them first, so that their reads are in flight
// together, then apply(i, i < R, loaded) in every thread of the team (the
// rows of one step are uniform over the team, so apply may vote over a
// warp).
constexpr int ROW_UNROLL = 4;

template <class Load, class Apply>
__device__ inline void for_rows(int R, Load load, Apply apply,
                                const Team& tm) {
  using Loaded = decltype(load(0));
  for (int b0 = 0; b0 < R; b0 += ROW_UNROLL * tm.size) {
    Loaded x[ROW_UNROLL];
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) {
      const int i = b0 + u * tm.size + tm.tid;
      if (i < R) x[u] = load(i);
    }
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) {
      const int i = b0 + u * tm.size + tm.tid;
      apply(i, i < R, x[u]);
    }
  }
}

struct SlotValue {
  int s;
  float v;
};

// Team `tm` gathers the rows i < R whose slot load(i).s lies in [lo, hi)
// into shared memory, in no order: entry[j] = make(i, load(i)) for the j-th
// of them.  Each warp takes its places with one shared atomic on *count.
// Returns their count (team-uniform).
template <class Load, class Make>
__device__ inline int gather_rows(int lo, int hi, int R, Load load,
                                  Make make, unsigned long long* entry,
                                  int* count, const Team& tm) {
  if (tm.tid == 0) *count = 0;
  tm.sync();
  const unsigned lane = threadIdx.x & 31;
  for_rows(
      R, load,
      [&](int i, bool live, const SlotValue& x) {
        const bool in = live && x.s >= lo && x.s < hi;
        const unsigned m = __ballot_sync(0xffffffffu, in);
        int base = 0;
        if (lane == 0 && m != 0) base = atomicAdd(count, __popc(m));
        base = __shfl_sync(0xffffffffu, base, 0);
        if (in) entry[base + __popc(m & ((1u << lane) - 1))] = make(i, x);
      },
      tm);
  tm.sync();
  return *count;
}

// The ordered add of one chunk in two steps, over ordered_add_smem(R, .)
// bytes of shared memory (R at most FOLD_ADD_MAX_ROWS): ordered_add_sort
// gathers the rows r < R with lo <= s_r < hi, where load(r) reads row r's
// SlotValue (once, whatever its slot), and sorts their (slot, row) keys,
// returning their count; ordered_add_fold then adds each slot's rows in
// increasing r: out[s_r] += v_r.  A barrier of the whole block between the
// two makes the sort, and the writes of out[lo:hi) that any team made,
// visible to the fold's team.
struct OrderedSmem {
  unsigned long long* key;
  float* sval;  // by row
  int* count;   // rows in range
};

__device__ inline OrderedSmem ordered_smem(unsigned char* smem, int R) {
  const int P = next_pow2(R > 0 ? R : 1);
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem);
  float* sval = reinterpret_cast<float*>(key + P);
  return OrderedSmem{key, sval, reinterpret_cast<int*>(sval + P)};
}

template <class Load>
__device__ inline int ordered_add_sort(int lo, int hi, int R,
                                       unsigned char* smem, Load load,
                                       const Team& tm) {
  const OrderedSmem m = ordered_smem(smem, R);
  const int n = gather_rows(
      lo, hi, R, load,
      [&](int i, const SlotValue& x) {
        m.sval[i] = x.v;
        return (static_cast<unsigned long long>(x.s) << 32) |
               static_cast<unsigned int>(i);
      },
      m.key, m.count, tm);
  const int Pn = next_pow2(n > 0 ? n : 1);
  for (int i = n + tm.tid; i < Pn; i += tm.size) m.key[i] = kNoKey;
  tm.sync();
  block_sort(m.key, Pn, tm);
  return n;
}

__device__ inline void ordered_add_fold(float* __restrict__ out, int n,
                                        unsigned char* smem, int R,
                                        const Team& tm) {
  const OrderedSmem m = ordered_smem(smem, R);
  for (int i = tm.tid; i < n; i += tm.size) {
    const unsigned int s = static_cast<unsigned int>(m.key[i] >> 32);
    if (i > 0 && static_cast<unsigned int>(m.key[i - 1] >> 32) == s)
      continue;
    float acc = out[s];  // this thread owns slot s: the head of its run
    for (int j = i; j < n && static_cast<unsigned int>(m.key[j] >> 32) == s;
         ++j)
      acc = __fadd_rn(acc, m.sval[static_cast<unsigned int>(m.key[j])]);
    out[s] = acc;
  }
}

// A fold of the rows r < R into out[lo:hi) while the block's copy part
// copies the range that the fold reads (block_part).  add (the copy part
// runs copy(part)): out[s_r] += v_r in row order, chunk by chunk:
// for each chunk, the block counts the rows of each slot (ranges of `step`
// <= SINGLE_MAX_SLOTS slots; for the first chunk only the rest of the block,
// as the copy runs), then the whole block adds the rows of the slots that
// have one in the chunk and sorts the others; min (the copy part copies
// src[lo:hi) into out, each NaN as its ticket): out[s_r] = min(out[s_r],
// v_r), the rest of the block gathering the first MIN_CHUNK rows' (slot,
// value) pairs, each NaN as its ticket, as the copy runs, then the whole
// block applying them with atomic_min_f32 (then the next MIN_CHUNK rows,
// gathered by the whole block), and, if a NaN took part, reading each
// slot's ticket back.  load(r) returns row r's SlotValue; rows outside [lo,
// hi) are skipped; the min takes at most MIN_FOLD_MAX_ROWS rows.  Ends with
// a barrier of the whole block; `smem` holds ordered_add_smem(R, step) (add)
// or min_fold_smem(R) (min) bytes.
// One chunk of add_fold_beside: the rows [c0, c0 + m), the first chunk
// (first) beside the copy.
template <class Load, class Copy>
__device__ __forceinline__ void add_fold_chunk(float* __restrict__ out,
                                               int lo, int hi, bool counts,
                                               int c0, int m, bool first,
                                               unsigned char* smem,
                                               Load load, Copy copy) {
  const auto ld = [&](int i) { return load(c0 + i); };
  unsigned* cnt =
      reinterpret_cast<unsigned*>(ordered_smem(smem, m).count + 4);
  const auto count_rows = [&](const Team& tm) {
    for (int i = tm.tid; i < (hi - lo + 1) / 2; i += tm.size) cnt[i] = 0;
    tm.sync();
    for_rows(
        m, ld,
        [&](int, bool live, const SlotValue& x) {
          if (live && x.s >= lo && x.s < hi)
            atomicAdd(&cnt[(x.s - lo) >> 1], 1u << (16 * ((x.s - lo) & 1)));
        },
        tm);
  };
  if (first) {
    const Team part = block_part();
    if (threadIdx.x < COPY_THREADS)
      copy(part);
    else if (counts)
      count_rows(part);
  } else if (counts) {
    count_rows(whole_block());
  }
  __syncthreads();
  // a slot's only row in the chunk is added at once (re-read from L2); the
  // rest sorted
  const int n = ordered_add_sort(
      lo, hi, m, smem,
      [&](int i) {
        SlotValue x = ld(i);
        if (counts && x.s >= lo && x.s < hi &&
            ((cnt[(x.s - lo) >> 1] >> (16 * ((x.s - lo) & 1))) & 0xffffu) ==
                1) {
          out[x.s] = __fadd_rn(out[x.s], x.v);
          x.s = lo - 1;
        }
        return x;
      },
      whole_block());
  ordered_add_fold(out, n, smem, m, whole_block());
  __syncthreads();
}

template <class Load, class Copy>
__device__ inline void add_fold_beside(float* __restrict__ out, int lo,
                                       int hi, int step, int R,
                                       unsigned char* smem, Load load,
                                       Copy copy) {
  const bool counts = step <= SINGLE_MAX_SLOTS;
  // One chunk takes a straight line of its own: on an H100, SpMV's leg 2
  // took 4 % longer through the loop alone, and 8 % with the first chunk
  // peeled off in front of it, in paired runs (tools/leg_times.py).
  if (R <= FOLD_ADD_MAX_ROWS) {
    add_fold_chunk(out, lo, hi, counts, 0, R, true, smem, load, copy);
    return;
  }
  for (int c0 = 0; c0 < R; c0 += FOLD_ADD_MAX_ROWS)
    add_fold_chunk(out, lo, hi, counts, c0, chunk_rows(R - c0), c0 == 0,
                   smem, load, copy);
}

template <class Load>
__device__ inline void min_fold_beside(float* __restrict__ out,
                                       const float* __restrict__ src, int lo,
                                       int hi, int R, unsigned char* smem,
                                       Load load) {
  const int C = R < MIN_CHUNK ? R : MIN_CHUNK;
  unsigned long long* entry = reinterpret_cast<unsigned long long*>(smem);
  int* count = reinterpret_cast<int*>(entry + (C > 0 ? C : 1));
  int* ticketed = count + 1;  // some slot of the range may hold a ticket
  // rows c0 .. c0 + m - 1, each value ticketed by its row as its entry is
  // made (after the loads: ticketing a row as it loads held the next loads
  // back, 18 % of scatter_segments' min on an H100)
  const auto rows = [&](int c0) {
    return [&, c0](int i) { return load(c0 + i); };
  };
  const auto make = [](int c0) {
    return [c0](int i, const SlotValue& x) {
      return (static_cast<unsigned long long>(static_cast<unsigned>(x.s))
              << 32) |
             __float_as_uint(row_ticket(x.v, c0 + i));
    };
  };
  if (threadIdx.x == 0) *ticketed = 0;
  __syncthreads();
  const Team part = block_part();
  // a NaN of the target or a row, seen in a register
  bool seen_nan = false;
  if (threadIdx.x < COPY_THREADS)
    seen_nan = copy_range(src, out, lo, hi, part, [](float v) {
      return nan_ticket(v, 0, TARGET_NEG);
    });
  else
    gather_rows(lo, hi, C, rows(0), make(0), entry, count, part);
  for (int c0 = 0;;) {
    __syncthreads();  // the copy, and this chunk's entries
    const int n = *count;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const unsigned long long e = entry[j];
      const float v = __uint_as_float(static_cast<unsigned>(e));
      seen_nan |= is_nan_bits(__float_as_uint(v));  // a row's ticket
      atomic_min_f32(out + static_cast<unsigned>(e >> 32), v);
    }
    c0 += C;
    if (c0 >= R) break;
    __syncthreads();  // every thread has read this chunk
    const int m = R - c0 < C ? R - c0 : C;
    gather_rows(lo, hi, m, rows(c0), make(c0), entry, count,
                whole_block());
  }
  if (seen_nan) *ticketed = 1;
  __syncthreads();
  if (*ticketed) {  // a NaN took part: read each ticket back
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const int p = ticket_place(__ldcg(out + i));
      if (p >= 0) out[i] = p == 0 ? src[i] : load(p - 1).v;
    }
    __syncthreads();
  }
}

}  // namespace repro
