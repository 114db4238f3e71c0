// Hopper (sm_90a) kernels of the Dalorex engine round, one per TPU kernel of
// src/repro/kernels/engine/kernel.py on the unfused path.  Every kernel is
// batched over the T emulated tiles and writes every output element exactly
// as the reference's pure body does (including the don't-care slots), so a
// kernel's outputs are compared with its plain PyTorch version element for
// element.
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

namespace {

// Block-wide exclusive prefix sum of one int per thread (blockDim.x a
// multiple of 32, at most 1024).  Returns the thread's exclusive prefix and
// the block total in *total.  `sm` is 33 ints of shared memory; the trailing
// barrier makes it safe to call again at once.
__device__ int block_excl_scan(int v, int* total, int* sm) {
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

// ---------------------------------------------------------------------------
// frontier_pop: replaces frontier_pop / frontier_take (kernel.py:371, :77).
// The first min(k, popcount) set bits of each tile's (n,) frontier bitmap, in
// position order: idx (k_max,) with 0 in the invalid slots, valid (k_max,),
// and the bitmap with exactly those bits cleared.
//
// Bound: bytes — the bitmap is read once and its cleared copy written once
// (2n bytes per tile); the ranking is a few integer ops per byte.  Design:
// one block per tile walks the bitmap in 8 KiB steps, each thread owning 16
// consecutive bytes read and written as one 16-byte vector; a block scan of
// the per-thread popcounts gives each thread the rank of its first set bit.
// Once k bits are ranked the block only copies.  Occupancy: T blocks (64 on
// the main path, under half of the 132 SMs).
// ---------------------------------------------------------------------------
constexpr int FP_THREADS = 512;
constexpr int FP_BYTES = 16;

union Bytes16 {
  uint4 v;
  uint8_t b[FP_BYTES];
};

__global__ void __launch_bounds__(FP_THREADS)
frontier_pop_kernel(const uint8_t* __restrict__ mask,
                    const int32_t* __restrict__ kk, int32_t* __restrict__ idx,
                    uint8_t* __restrict__ valid, uint8_t* __restrict__ rem,
                    int n, int k_max) {
  __shared__ int sm[33];
  const int t = blockIdx.x;
  const uint8_t* m = mask + (size_t)t * n;
  uint8_t* r = rem + (size_t)t * n;
  int32_t* ix = idx + (size_t)t * k_max;
  const int k = kk[t];
  const bool vec =
      ((reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(r)) &
       (FP_BYTES - 1)) == 0;
  int seen = 0;  // set bits ranked so far; identical in every thread
  for (int base = 0; base < n; base += FP_THREADS * FP_BYTES) {
    const int p0 = base + threadIdx.x * FP_BYTES;
    const bool full = vec && p0 + FP_BYTES <= n;
    Bytes16 u;
    if (full) {
      u.v = *reinterpret_cast<const uint4*>(m + p0);
    } else {
#pragma unroll
      for (int i = 0; i < FP_BYTES; ++i) u.b[i] = p0 + i < n ? m[p0 + i] : 0;
    }
    if (seen < k) {  // block-uniform branch
      int cnt = 0;
#pragma unroll
      for (int i = 0; i < FP_BYTES; ++i) cnt += u.b[i] != 0;
      int total;
      int rank = seen + block_excl_scan(cnt, &total, sm);
#pragma unroll
      for (int i = 0; i < FP_BYTES; ++i) {
        if (u.b[i]) {
          if (rank < k) {
            if (rank < k_max) ix[rank] = p0 + i;
            u.b[i] = 0;
          }
          ++rank;
        }
      }
      seen += total;
    }
    if (full) {
      *reinterpret_cast<uint4*>(r + p0) = u.v;
    } else {
      for (int i = 0; i < FP_BYTES; ++i)
        if (p0 + i < n) r[p0 + i] = u.b[i];
    }
  }
  int n_take = seen < k ? seen : k;
  if (n_take < 0) n_take = 0;
  for (int j = threadIdx.x; j < k_max; j += blockDim.x) {
    if (j >= n_take) ix[j] = 0;  // disjoint from the ranked writes above
    valid[(size_t)t * k_max + j] = j < n_take;
  }
}

// ---------------------------------------------------------------------------
// queue_push_pop: replaces queue_push_pop / fifo_turn + queue_append
// (kernel.py:417, :95, :123).  One circular-FIFO turn per tile: append the
// valid fresh rows at the tail (slot claim by exclusive scan; rows past the
// capacity are drops), then pop min(n, count') rows off the front by
// shifting the whole (cap, w) buffer: new[i] = data'[min(i + n_pop, cap-1)].
//
// Bound: bytes — the shift reads and writes the whole buffer (stale rows
// included, as the reference body does), 2*cap*w*4 bytes per tile; the
// update channel's (65536, 2) buffer makes this the largest byte mover of
// the round.  Design: one block per tile compacts the valid-row indices into
// shared memory with a block scan, then streams the shift with coalesced
// 4-byte accesses, reading each element of data' from either the old
// buffer or the fresh rows; the shifted buffer is a second allocation
// because the shift overlaps itself.
// ---------------------------------------------------------------------------
constexpr int QP_THREADS = 1024;

__global__ void __launch_bounds__(QP_THREADS)
queue_push_pop_kernel(const int32_t* __restrict__ data,
                      const int32_t* __restrict__ count,
                      const int32_t* __restrict__ rows,
                      const uint8_t* __restrict__ pvalid,
                      const int32_t* __restrict__ npop,
                      int32_t* __restrict__ taken, uint8_t* __restrict__ tvalid,
                      int32_t* __restrict__ ndata,
                      int32_t* __restrict__ ncount,
                      int32_t* __restrict__ drops, int cap, int w, int n,
                      int max_n) {
  extern __shared__ int src_row[];  // source row of the j-th valid row
  __shared__ int sm[33];
  const int t = blockIdx.x;
  int nvalid = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < n ? pvalid[(size_t)t * n + i] != 0 : 0;
    int total;
    const int pos = nvalid + block_excl_scan(v, &total, sm);
    if (v) src_row[pos] = i;
    nvalid += total;
  }
  __syncthreads();
  const int c0 = count[t];
  const int room = cap - c0 > 0 ? cap - c0 : 0;
  const int n_push = nvalid < room ? nvalid : room;
  const int c2 = c0 + n_push;
  const int p = npop[t];
  const int n_pop = p < c2 ? p : c2;
  const int32_t* d = data + (size_t)t * cap * w;
  const int32_t* rw = rows + (size_t)t * n * w;
  // element (row, col) of the post-append buffer data'
  auto appended = [&](int row, int col) -> int32_t {
    return (row >= c0 && row < c2) ? rw[(size_t)src_row[row - c0] * w + col]
                                   : d[(size_t)row * w + col];
  };
  int32_t* nd = ndata + (size_t)t * cap * w;
  const int ne = cap * w;
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    const int i = e / w, col = e - i * w;
    const int row = i + n_pop < cap - 1 ? i + n_pop : cap - 1;
    nd[e] = appended(row, col);
  }
  int32_t* tk = taken + (size_t)t * max_n * w;
  for (int e = threadIdx.x; e < max_n * w; e += blockDim.x) {
    const int i = e / w;
    tk[e] = appended(i, e - i * w);
  }
  for (int j = threadIdx.x; j < max_n; j += blockDim.x)
    tvalid[(size_t)t * max_n + j] = j < n_pop;
  if (threadIdx.x == 0) {
    ncount[t] = c2 - n_pop;
    drops[t] = nvalid - n_push;
  }
}

// ---------------------------------------------------------------------------
// edge_scan_gather: replaces edge_scan_gather / segment_gather (kernel.py:473,
// :141).  For each of R range messages of a tile, the max_t2 lanes
// edge_dst/edge_val[min(start % e_chunk + j, e_chunk - 1)], and jvalid =
// rv && j < stop - start && dst >= 0.
//
// Bound: bytes — each lane reads one (dst, val) word pair and writes 9 bytes.
// Design: one thread per lane on a (T, lanes/256) grid; consecutive lanes of
// a message read consecutive shard words, so a warp covers one 128-byte line
// per array.  start % e_chunk is a floor modulo taken only for valid rows
// (C's % truncates, and invalid rows may carry -1).
// ---------------------------------------------------------------------------
constexpr int ES_THREADS = 256;

__global__ void __launch_bounds__(ES_THREADS)
edge_scan_gather_kernel(const int32_t* __restrict__ edge_dst,
                        const float* __restrict__ edge_val,
                        const int32_t* __restrict__ start,
                        const int32_t* __restrict__ stop,
                        const uint8_t* __restrict__ rv,
                        int32_t* __restrict__ nb, float* __restrict__ wout,
                        uint8_t* __restrict__ jvalid, int e_chunk, int R,
                        int max_t2) {
  const int t = blockIdx.x;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= R * max_t2) return;
  const int r = e / max_t2, j = e - r * max_t2;
  const size_t row = (size_t)t * R + r;
  const bool v = rv[row] != 0;
  int length = 0, local0 = 0;
  if (v) {
    const int s = start[row];
    length = stop[row] - s;
    local0 = s % e_chunk;
    if (local0 < 0) local0 += e_chunk;
  }
  const int ei = local0 + j < e_chunk - 1 ? local0 + j : e_chunk - 1;
  const size_t src = (size_t)t * e_chunk + ei;
  const int32_t dst = edge_dst[src];
  const size_t o = (size_t)t * R * max_t2 + e;
  nb[o] = dst;
  wout[o] = edge_val[src];
  jvalid[o] = v && j < length && dst >= 0;
}

// ---------------------------------------------------------------------------
// fold_scatter, op="min": replaces fold_scatter / scatter_body (kernel.py:557,
// :204).  out = target, then out[lidx[r]] = min(out[lidx[r]], vals[r]) for
// every valid row r whose lidx is a real slot (the v_chunk trash slot and
// invalid rows contribute the neutral element, i.e. nothing).
//
// Bound: bytes — the (v_chunk,) slice is read and written once (8 bytes per
// vertex) and each row is read once (9 bytes).  Design: one block per tile
// copies its slice with 16-byte vectors, synchronises, then folds its rows
// with float atomicMin through the integer-order trick (signed atomicMin on
// the bits of a non-negative value, unsigned atomicMax on the bits of a
// negative one).  Min is exact in any order, so the atomics stay bitwise
// equal to the serial reference; every write stays inside the tile's own
// slice.  The add fold needs an order-keeping reduction and is not here.
// ---------------------------------------------------------------------------
constexpr int FS_THREADS = 1024;

__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  const int bits = __float_as_int(v);
  if (bits >= 0)
    atomicMin(reinterpret_cast<int*>(addr), bits);
  else
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__global__ void __launch_bounds__(FS_THREADS)
fold_scatter_min_kernel(const float* __restrict__ target,
                        const int32_t* __restrict__ lidx,
                        const float* __restrict__ vals,
                        const uint8_t* __restrict__ valid,
                        float* __restrict__ out, int v_chunk, int R) {
  const int t = blockIdx.x;
  const float* tg = target + (size_t)t * v_chunk;
  float* o = out + (size_t)t * v_chunk;
  const bool vec = (v_chunk % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(tg) |
                     reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(tg);
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int i = threadIdx.x; i < v_chunk / 4; i += blockDim.x) o4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < v_chunk; i += blockDim.x) o[i] = tg[i];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const size_t q = (size_t)t * R + r;
    const int li = lidx[q];
    if (valid[q] && li >= 0 && li < v_chunk) atomic_min_f32(o + li, vals[q]);
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_frontier_pop(const void* mask, const void* k, void* idx,
                       void* valid, void* rem, int T, int n, int k_max,
                       void* stream) {
  frontier_pop_kernel<<<T, FP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(k),
      static_cast<int32_t*>(idx), static_cast<uint8_t*>(valid),
      static_cast<uint8_t*>(rem), n, k_max);
  return static_cast<int>(cudaGetLastError());
}

int repro_queue_push_pop(const void* data, const void* count, const void* rows,
                         const void* pvalid, const void* npop, void* taken,
                         void* tvalid, void* ndata, void* ncount, void* drops,
                         int T, int cap, int w, int n, int max_n,
                         void* stream) {
  queue_push_pop_kernel<<<T, QP_THREADS, n * sizeof(int),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(data), static_cast<const int32_t*>(count),
      static_cast<const int32_t*>(rows), static_cast<const uint8_t*>(pvalid),
      static_cast<const int32_t*>(npop), static_cast<int32_t*>(taken),
      static_cast<uint8_t*>(tvalid), static_cast<int32_t*>(ndata),
      static_cast<int32_t*>(ncount), static_cast<int32_t*>(drops), cap, w, n,
      max_n);
  return static_cast<int>(cudaGetLastError());
}

int repro_edge_scan_gather(const void* edge_dst, const void* edge_val,
                           const void* start, const void* stop, const void* rv,
                           void* nb, void* w, void* jvalid, int T, int e_chunk,
                           int R, int max_t2, void* stream) {
  const dim3 grid(T, (R * max_t2 + ES_THREADS - 1) / ES_THREADS);
  edge_scan_gather_kernel<<<grid, ES_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(edge_dst),
      static_cast<const float*>(edge_val), static_cast<const int32_t*>(start),
      static_cast<const int32_t*>(stop), static_cast<const uint8_t*>(rv),
      static_cast<int32_t*>(nb), static_cast<float*>(w),
      static_cast<uint8_t*>(jvalid), e_chunk, R, max_t2);
  return static_cast<int>(cudaGetLastError());
}

int repro_fold_scatter_min(const void* target, const void* lidx,
                           const void* vals, const void* valid, void* out,
                           int T, int v_chunk, int R, void* stream) {
  fold_scatter_min_kernel<<<T, FS_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(target), static_cast<const int32_t*>(lidx),
      static_cast<const float*>(vals), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), v_chunk, R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
