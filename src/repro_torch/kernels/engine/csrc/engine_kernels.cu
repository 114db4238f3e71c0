// Hopper (sm_90a) kernels of the Dalorex engine round, one per TPU kernel of
// src/repro/kernels/engine/kernel.py on the unfused path.  Every kernel is
// batched over the T emulated tiles and writes every output element exactly
// as the reference's pure body does (including the don't-care slots), so a
// kernel's outputs are compared with its plain PyTorch version element for
// element; but for queue_push_pop's turned queue, which is written below its
// count only and compared there.  Their bodies are the device functions of
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
// (2n bytes per tile); the ranking is a few integer ops per byte.  Design:
// one block per tile walks the bitmap in 32 KiB passes, each thread owning
// 64 consecutive bytes read and written as four 16-byte vectors; a block
// scan of the per-thread popcounts gives each thread the rank of its first
// set bit.  Once k bits are ranked the block only copies.  Occupancy: T
// blocks (64 on the main path, under half of the 132 SMs).
// ---------------------------------------------------------------------------
constexpr int FP_THREADS = 512;

__global__ void __launch_bounds__(FP_THREADS)
frontier_pop_kernel(const uint8_t* __restrict__ mask,
                    const int32_t* __restrict__ kk, int32_t* __restrict__ idx,
                    uint8_t* __restrict__ valid, uint8_t* __restrict__ rem,
                    int n, int k_max) {
  __shared__ int sm[33];
  const int t = blockIdx.x;
  const int n_take = repro::frontier_take_block(
      mask + (size_t)t * n, rem + (size_t)t * n, n, kk[t], k_max,
      idx + (size_t)t * k_max, sm);
  for (int j = threadIdx.x; j < k_max; j += blockDim.x)
    valid[(size_t)t * k_max + j] = j < n_take;
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
  int length, local0;
  repro::message_bounds(rv[row] != 0, start[row], stop[row], e_chunk,
                        &length, &local0);
  const repro::Lane l =
      repro::gather_lane(edge_dst + (size_t)t * e_chunk,
                         edge_val + (size_t)t * e_chunk, e_chunk, length,
                         local0, j);
  const size_t o = (size_t)t * R * max_t2 + e;
  nb[o] = l.dst;
  wout[o] = l.w;
  jvalid[o] = l.valid;
}

// ---------------------------------------------------------------------------
// edge_scan_stream: replaces edge_scan_stream / segment_stream
// (kernel.py:519, :157).  T2 over an HBM-declared edge shard: one warp per
// range message stages the two aligned `window`-sized windows that cover it
// (2 * window (dst, val) pairs, indices clamped to the shard) in shared
// memory, then its lanes gather from the staging buffer only.  Every valid
// lane reads the word edge_scan_gather reads (window >= max_t2); invalid
// lanes read the staging buffer, as segment_stream's do.
//
// Bound: bytes — what the streamed tile transfers is 2 * window words per
// message (hbm_edges), against max_t2 for the resident gather; the staging
// reads are coalesced 128-byte lines.  Design: a (T, R / warps) grid of
// blocks of `warps` warps, each warp with its own 16 * window bytes of
// shared memory (warps = 48 KiB / that, at most 8).  A window wider than
// STREAM_MAX_WINDOW (engine_device.cuh) is not staged:
// edge_scan_stream_global_kernel reads each lane's word where the staging
// buffer would hold it, one thread a lane as the resident gather.
// ---------------------------------------------------------------------------
constexpr int STAGE_SMEM = 48 * 1024;

__host__ __device__ inline int stage_warps(int window, int most) {
  const int w = STAGE_SMEM / (16 * window);
  return w < 1 ? 1 : (w > most ? most : w);
}

__global__ void edge_scan_stream_kernel(
    const int32_t* __restrict__ edge_dst, const float* __restrict__ edge_val,
    const int32_t* __restrict__ start, const int32_t* __restrict__ stop,
    const uint8_t* __restrict__ rv, int32_t* __restrict__ nb,
    float* __restrict__ wout, uint8_t* __restrict__ jvalid, int e_chunk,
    int R, int max_t2, int window) {
  extern __shared__ __align__(16) unsigned char es_smem[];
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.y * (blockDim.x >> 5) + warp;
  if (r >= R) return;  // whole warps leave; no block barrier follows
  int32_t* sd = reinterpret_cast<int32_t*>(es_smem) + warp * 4 * window;
  float* sv = reinterpret_cast<float*>(sd + 2 * window);
  const size_t row = (size_t)t * R + r;
  int length, local0;
  repro::message_bounds(rv[row] != 0, start[row], stop[row], e_chunk,
                        &length, &local0);
  const int base = repro::stage_windows(
      edge_dst + (size_t)t * e_chunk, edge_val + (size_t)t * e_chunk,
      e_chunk, local0, window, sd, sv);
  __syncwarp();
  for (int j = threadIdx.x & 31; j < max_t2; j += 32) {
    const repro::Lane l =
        repro::stream_lane(sd, sv, window, length, local0, base, j);
    const size_t o = row * max_t2 + j;
    nb[o] = l.dst;
    wout[o] = l.w;
    jvalid[o] = l.valid;
  }
}

__global__ void __launch_bounds__(ES_THREADS)
edge_scan_stream_global_kernel(const int32_t* __restrict__ edge_dst,
                               const float* __restrict__ edge_val,
                               const int32_t* __restrict__ start,
                               const int32_t* __restrict__ stop,
                               const uint8_t* __restrict__ rv,
                               int32_t* __restrict__ nb,
                               float* __restrict__ wout,
                               uint8_t* __restrict__ jvalid, int e_chunk, int R,
                               int max_t2, int window) {
  const int t = blockIdx.x;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= R * max_t2) return;
  const int r = e / max_t2, j = e - r * max_t2;
  const size_t row = (size_t)t * R + r;
  int length, local0;
  repro::message_bounds(rv[row] != 0, start[row], stop[row], e_chunk,
                        &length, &local0);
  const repro::Lane l = repro::stream_lane_global(
      edge_dst + (size_t)t * e_chunk, edge_val + (size_t)t * e_chunk,
      e_chunk, window, length, local0, j);
  const size_t o = (size_t)t * R * max_t2 + e;
  nb[o] = l.dst;
  wout[o] = l.w;
  jvalid[o] = l.valid;
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
// with float atomicMin through the integer-order trick (ordered_scatter.cuh).
// Min is exact in any order, so the atomics stay bitwise equal to the serial
// reference; every write stays inside the tile's own slice.
// ---------------------------------------------------------------------------
constexpr int FS_THREADS = 1024;

__global__ void __launch_bounds__(FS_THREADS)
fold_scatter_min_kernel(const float* __restrict__ target,
                        const int32_t* __restrict__ lidx,
                        const float* __restrict__ vals,
                        const uint8_t* __restrict__ valid,
                        float* __restrict__ out, int v_chunk, int R) {
  const int t = blockIdx.x;
  float* o = out + (size_t)t * v_chunk;
  repro::copy_slice(target + (size_t)t * v_chunk, o, v_chunk);
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const size_t q = (size_t)t * R + r;
    const int li = lidx[q];
    if (valid[q] && li >= 0 && li < v_chunk)
      repro::atomic_min_f32(o + li, vals[q]);
  }
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

int repro_frontier_pop(const void* mask, const void* k, void* idx,
                       void* valid, void* rem, int T, int n, int k_max,
                       void* stream) {
  frontier_pop_kernel<<<T, FP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(k),
      static_cast<int32_t*>(idx), static_cast<uint8_t*>(valid),
      static_cast<uint8_t*>(rem), n, k_max);
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

// The windows staged in shared memory up to STREAM_MAX_WINDOW, wider ones
// read from device memory.
int repro_edge_scan_stream(const void* edge_dst, const void* edge_val,
                           const void* start, const void* stop, const void* rv,
                           void* nb, void* w, void* jvalid, int T, int e_chunk,
                           int R, int max_t2, int window, void* stream) {
  static_assert(16 * repro::STREAM_MAX_WINDOW <= STAGE_SMEM,
                "a staged window fits the staging");
  if (window < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (window > repro::STREAM_MAX_WINDOW) {
    const dim3 grid(T, (R * max_t2 + ES_THREADS - 1) / ES_THREADS);
    edge_scan_stream_global_kernel<<<grid, ES_THREADS, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(edge_dst),
        static_cast<const float*>(edge_val),
        static_cast<const int32_t*>(start), static_cast<const int32_t*>(stop),
        static_cast<const uint8_t*>(rv), static_cast<int32_t*>(nb),
        static_cast<float*>(w), static_cast<uint8_t*>(jvalid), e_chunk, R,
        max_t2, window);
    return static_cast<int>(cudaGetLastError());
  }
  const int warps = stage_warps(window, 8);
  const dim3 grid(T, (R + warps - 1) / warps);
  edge_scan_stream_kernel<<<grid, 32 * warps, (size_t)warps * 16 * window,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(edge_dst),
      static_cast<const float*>(edge_val), static_cast<const int32_t*>(start),
      static_cast<const int32_t*>(stop), static_cast<const uint8_t*>(rv),
      static_cast<int32_t*>(nb), static_cast<float*>(w),
      static_cast<uint8_t*>(jvalid), e_chunk, R, max_t2, window);
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
