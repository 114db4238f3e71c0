// Hopper (sm_90a) fused legs of the Dalorex round: each replaces one launch
// of fused_leg_call (src/repro/kernels/engine/kernel.py:241), whose body is
// the engine's per-tile stage (src/repro/core/engine.py:500; stages :601,
// :610, :626).  One block per tile runs the whole leg (the classic and
// k-core leg 2: G blocks per tile, one column range each); its phases are
// the device functions the standalone kernels use (engine_device.cuh,
// ordered_scatter.cuh), separated by block barriers, so each output element
// is what the plain stage writes, don't-care slots included.
//
// Classic program (and k-core, which has its shape), 2 channels, 3 legs:
//   leg 0  TSU budgets; T4 frontier pop + payload; range-queue turn; T1
//          range split; remainder re-push           (template: payload, policy)
//   leg 1  range-spill re-queue; T2 scan, resident gather or streamed
//          windows, and emit; update-queue replay turn; replay rows ahead of
//          the fresh rows in the messages           (template: emit, stream)
//   leg 2  update-spill re-queue (in place); T3 min fold + re-arm of the
//          flags the wrapper passes (async: frontier, BSP: next_frontier),
//          ordered add fold, or k-core's threshold fold (ordered add of the
//          decrements, then the newly removed vertices' flags), G blocks
//          a tile on its column ranges, one on its append (template: fold)
// Triangles (src/repro/core/program.py:698), 4 channels, 5 legs:
//   leg 0  leg 0 above with the placed-id payload and the TSU over 4 queues
//   leg 1  leg 1 above, emitting wedges (nb, v) valid iff nb > v
//   leg 2  wedge-spill re-queue; wedge_to_range; range2-queue turn of the
//          width-4 rows; T1 range split; remainder re-push   (wedge leg)
//   leg 3  leg 1 above on width-4 messages, emitting (v, nb) valid iff nb > u
//   leg 4  close-spill re-queue; bounded binary search of the closing edge
//          in the sorted local segment; ordered add of found into acc
//                                                           (close leg)
//
// Bound: bytes.  Each leg reads its inputs once and writes its outputs once;
// the largest are the spill-only queues (the scan leg shifts one, the wedge
// and close legs copy one before appending: cap * 8 bytes a tile each way),
// the scan leg's messages (9 bytes a lane) and the (v_chunk,) slices of
// legs 0 and of the fold legs.  Design: outputs are fresh buffers (a queue
// shifted in place would need a read-barrier-write per element), but for
// the classic and k-core leg 2, which appends its spills in place onto the
// update queue that leg 1 of the same round made fresh, so it moves only
// the rows it appends; data that fits stays in shared memory: leg 0's
// popped tasks and rows (at most LEG0_MAX_ROWS), the scan leg's staging
// windows, the wedge leg's compacted fresh rows and popped tasks, the fold
// legs' sort keys.  The messages of the scan leg (T * cap_route_range *
// max_t2 rows) and the queues go to device memory, as in the standalone
// kernels.  Occupancy: T blocks (64 on the main path), but for the classic
// and k-core leg 2, whose grid (T, G + 1) gives each of G blocks one column
// range of a tile's slice and one block its spill append (G = 5 on the
// main path: 384 blocks of 512 threads, kernels/engine/kernel.py
// column_split).  The close leg's binary search
// reads the shard word-random, at most bit_length(e_chunk) + 1 words a row.
//
// Plain C interface, as engine_kernels.cu: device pointers, sizes, template
// codes and the caller's cudaStream_t in, cudaGetLastError() out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "engine_device.cuh"
#include "ordered_scatter.cuh"

namespace {

constexpr int LEG_THREADS = 1024;
constexpr int FOLD_THREADS = 512;    // the fold legs' (T, G + 1) blocks
static_assert(FOLD_THREADS > repro::COPY_THREADS, "two parts a block");
constexpr int LEG0_MAX_ROWS = 256;   // kernels/engine/fused.py LEG0_MAX_ROWS
constexpr int STAGE_SMEM = 48 * 1024;  // leg 1's staging windows
constexpr int32_t ONE_BITS = 0x3f800000;  // the bits of 1.0f

// template codes (kernels/engine/fused.py PAYLOADS, EMITS, FOLDS, POLICIES)
enum { PAY_VALUE = 0, PAY_VALUE_OVER_DEG = 1, PAY_ONE = 2, PAY_PLACED = 3 };
enum {
  EMIT_PLUS1 = 0, EMIT_PLUS_W = 1, EMIT_COPY = 2, EMIT_TIMES_W = 3,
  EMIT_ONE = 4, EMIT_WEDGE = 5, EMIT_CLOSE = 6
};
enum { FOLD_MIN = 0, FOLD_ADD = 1, FOLD_KCORE = 2 };
enum { POLICY_TRAFFIC = 0, POLICY_STATIC = 1 };

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// program.py _emit: T2's payload for a neighbour
template <int EMIT>
__device__ __forceinline__ float emit(float parent, float w) {
  if (EMIT == EMIT_PLUS1) return __fadd_rn(parent, 1.0f);
  if (EMIT == EMIT_PLUS_W) return __fadd_rn(parent, w);
  if (EMIT == EMIT_COPY) return parent;
  return __fmul_rn(parent, w);
}

// T1 (program.py range_split): the stop of a popped range task
__device__ __forceinline__ int range_stop(int ts, int te, int e_chunk,
                                          int max_t2) {
  const int boundary =
      repro::wrap_mul(repro::floor_div(ts, e_chunk) + 1, e_chunk);
  return imin(imin(te, boundary), repro::wrap_add(ts, max_t2));
}

// The TSU's view of the channels downstream of channel 0 (1 .. K-1): each
// one's queue count, capacity and pop budget.
struct Downstream {
  const int32_t* count[3];
  int cap[3];
  int pop[3];
};

// ---------------------------------------------------------------------------
// Leg 0.  Budgets as core/engine.py _budgets for K channels (integer math of
// one thread; a throttled producer gets pop / 4 when K == 2 and 0 on deeper
// chains); frontier_take into shared memory; the source rows (start, start +
// deg, payload) of the popped vertices, valid where deg > 0; fifo_turn of the
// range queue with them; range_split of the popped tasks into the messages;
// queue_append of the remainders onto the shifted queue.
// ---------------------------------------------------------------------------
template <int PAYLOAD, int POLICY, int K>
__global__ void __launch_bounds__(LEG_THREADS)
fused_leg0_kernel(const uint8_t* __restrict__ frontier,
                  const float* __restrict__ value,
                  const int32_t* __restrict__ deg,
                  const int32_t* __restrict__ ptr_start,
                  const int32_t* __restrict__ rq,
                  const int32_t* __restrict__ rq_count, Downstream down,
                  const int32_t* __restrict__ pressure,
                  uint8_t* __restrict__ frontier_out,
                  int32_t* __restrict__ rq_out,
                  int32_t* __restrict__ rq_count_out,
                  int32_t* __restrict__ msgs, uint8_t* __restrict__ mvalid,
                  int32_t* __restrict__ drops, int32_t* __restrict__ dyn_pops,
                  int32_t* __restrict__ npop_out,
                  int32_t* __restrict__ npush_out, int v_chunk, int e_chunk,
                  int cap_r, int f_pop, int r_pop, int max_t2, int plimit) {
  __shared__ int sm[33];
  __shared__ int s_budget[2];  // frontier budget, range-channel pops
  __shared__ int32_t s_idx[LEG0_MAX_ROWS];
  __shared__ int32_t s_rows[LEG0_MAX_ROWS * 3];  // source rows, then rem
  __shared__ uint8_t s_valid[LEG0_MAX_ROWS];     // their validity
  __shared__ int s_src[LEG0_MAX_ROWS];           // compacted source rows
  __shared__ int32_t s_taken[LEG0_MAX_ROWS * 3];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid == 0) {
    const long long occ0 = rq_count[t];
    const long long free0 = cap_r - occ0;
    long long fp;
    int pops[K];
    pops[0] = r_pop;
    for (int i = 1; i < K; ++i) pops[i] = down.pop[i - 1];
    if (POLICY == POLICY_STATIC) {
      fp = free0 < 0 ? 0 : free0;
    } else {
      const bool hot = pressure[t] > imax(plimit, 1);
      bool below = false;  // a congested queue downstream of channel i
      for (int i = K - 1; i >= 1; --i) {
        if (i < K - 1 && (below || hot)) pops[i] = K == 2 ? pops[i] / 4 : 0;
        below = below || down.count[i - 1][t] > (3LL * down.cap[i - 1]) / 4;
      }
      if (below || hot) pops[0] = K == 2 ? r_pop / 4 : 0;
      const bool half0 = occ0 > cap_r / 2;
      fp = free0 - 2LL * f_pop;
      if (fp < 0 || half0 || hot || below) fp = 0;
    }
    if (fp > f_pop) fp = f_pop;
    s_budget[0] = static_cast<int>(fp);
    s_budget[1] = pops[0];
    for (int i = 0; i < K; ++i) dyn_pops[K * t + i] = pops[i];
  }
  __syncthreads();
  const size_t vt = (size_t)t * v_chunk;
  const int n_take =
      repro::frontier_take_block(frontier + vt, frontier_out + vt, v_chunk,
                                 s_budget[0], f_pop, s_idx, sm);
  __syncthreads();
  // T4: the popped vertices' tasks (invalid slots read vertex 0)
  if (tid < f_pop) {
    const size_t o = vt + s_idx[tid];
    const int dg = deg[o], st = ptr_start[o];
    int32_t pay;
    if (PAYLOAD == PAY_ONE) {
      pay = ONE_BITS;
    } else if (PAYLOAD == PAY_PLACED) {  // me * v_chunk + vidx
      pay = repro::wrap_add(repro::wrap_mul(t, v_chunk), s_idx[tid]);
    } else {
      float p = value[o];
      if (PAYLOAD == PAY_VALUE_OVER_DEG)
        p = __fdiv_rn(p, __int2float_rn(imax(dg, 1)));
      pay = __float_as_int(p);
    }
    s_rows[3 * tid] = st;
    s_rows[3 * tid + 1] = repro::wrap_add(st, dg);
    s_rows[3 * tid + 2] = pay;
    s_valid[tid] = tid < n_take && dg > 0;
  }
  __syncthreads();
  // fifo_turn: compact the valid rows, append, pop, shift
  int nvalid;
  {
    const int v = tid < f_pop ? s_valid[tid] : 0;
    const int pos = repro::block_excl_scan(v, &nvalid, sm);
    if (v) s_src[pos] = tid;
  }
  __syncthreads();
  const int c0 = rq_count[t];
  const int n_push0 = imin(nvalid, imax(cap_r - c0, 0));
  const int c2 = c0 + n_push0;
  const int n_pop = imin(s_budget[1], c2);
  const int eff = imin(r_pop, cap_r);
  int32_t* rqo = rq_out + (size_t)t * cap_r * 3;
  repro::fifo_shift(rq + (size_t)t * cap_r * 3, rqo, s_taken, cap_r, 3, c0,
                    n_push0, n_pop, eff, [&](int j, int col) {
                      return s_rows[3 * s_src[j] + col];
                    });
  __syncthreads();
  // T1: range split of the popped tasks; the remainders replace the rows
  for (int i = tid; i < eff; i += blockDim.x) {
    const int ts = s_taken[3 * i], te = s_taken[3 * i + 1];
    const int pay = s_taken[3 * i + 2];
    const int stop = range_stop(ts, te, e_chunk, max_t2);
    const bool tv = i < n_pop;
    int32_t* m = msgs + ((size_t)t * eff + i) * 3;
    m[0] = ts;
    m[1] = stop;
    m[2] = pay;
    mvalid[(size_t)t * eff + i] = tv;
    s_rows[3 * i] = stop;
    s_rows[3 * i + 1] = te;
    s_rows[3 * i + 2] = pay;
    s_valid[i] = tv && stop < te;
  }
  __syncthreads();
  const int c3 = c2 - n_pop;
  const int nrem =
      repro::queue_append_block(rqo, cap_r, 3, c3, s_rows, s_valid, eff, sm);
  if (tid == 0) {
    const int n_push1 = imin(nrem, imax(cap_r - c3, 0));
    rq_count_out[t] = c3 + n_push1;
    drops[t] = (nvalid - n_push0) + (nrem - n_push1);
    npop_out[t] = n_pop;
    npush_out[t] = nvalid + nrem;
  }
}

// ---------------------------------------------------------------------------
// Leg 1 (the scan leg).  queue_append of the range spills onto a copy of the
// range queue (rows of W = 3 or 4 words); T2 for the R delivered messages,
// one warp per message (STREAM: the warp first stages its two windows in
// shared memory), each lane emitting a width-2 row into message row eff +
// r * max_t2 + j; then fifo_turn of the spill-only queue of channel `chan`
// (its pop is dyn_pops[nchan * t + chan]) with no fresh rows, its popped
// rows being message rows [0, eff).  The emit:
//   EMIT_PLUS1 .. EMIT_TIMES_W  (dst, f2i(emit(i2f(recv[2]), w)))
//   EMIT_ONE    (dst, bits of 1.0f)                    k-core's decrement
//   EMIT_WEDGE  (dst, recv[2]), valid iff dst > recv[2]  triangles' wedge
//   EMIT_CLOSE  (recv[2], dst), valid iff dst > recv[3]  triangles' close
// The edge count is the scanned lanes, before the wedge/close narrowing.
// ---------------------------------------------------------------------------
template <int EMIT, bool STREAM, int W>
__global__ void __launch_bounds__(LEG_THREADS)
fused_leg1_kernel(const int32_t* __restrict__ rq,
                  const int32_t* __restrict__ rq_count,
                  const int32_t* __restrict__ sp,
                  const uint8_t* __restrict__ spv,
                  const int32_t* __restrict__ recv,
                  const uint8_t* __restrict__ rv,
                  const int32_t* __restrict__ edge_dst,
                  const float* __restrict__ edge_val,
                  const int32_t* __restrict__ uq,
                  const int32_t* __restrict__ uq_count,
                  const int32_t* __restrict__ dyn_pops,
                  int32_t* __restrict__ rq_out,
                  int32_t* __restrict__ rq_count_out,
                  int32_t* __restrict__ uq_out,
                  int32_t* __restrict__ uq_count_out,
                  int32_t* __restrict__ msgs, uint8_t* __restrict__ mvalid,
                  int32_t* __restrict__ drops, int32_t* __restrict__ edges,
                  int32_t* __restrict__ npop_out,
                  int32_t* __restrict__ npush_out,
                  int32_t* __restrict__ nspill_out, int cap_r, int S, int R,
                  int e_chunk, int max_t2, int window, int cap_u, int u_pop,
                  int scan_warps, int nchan, int chan) {
  extern __shared__ __align__(16) unsigned char stage_smem[];
  __shared__ int sm[33];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  // range-spill re-queue
  const int32_t* rqt = rq + (size_t)t * cap_r * W;
  int32_t* rqo = rq_out + (size_t)t * cap_r * W;
  for (int e = tid; e < cap_r * W; e += blockDim.x) rqo[e] = rqt[e];
  __syncthreads();
  const int c0 = rq_count[t];
  const int nsp = repro::queue_append_block(
      rqo, cap_r, W, c0, sp + (size_t)t * S * W, spv + (size_t)t * S, S, sm);
  // T2 and emit
  const int eff = imin(u_pop, cap_u);
  const size_t n_msgs = eff + (size_t)R * max_t2;
  int32_t* mt = msgs + (size_t)t * n_msgs * 2;
  uint8_t* mvt = mvalid + (size_t)t * n_msgs;
  const int32_t* ed = edge_dst + (size_t)t * e_chunk;
  const float* ev = edge_val + (size_t)t * e_chunk;
  const int warp = tid >> 5, lane = tid & 31;
  int my_edges = 0;
  if (warp < scan_warps) {
    int32_t* sd = reinterpret_cast<int32_t*>(stage_smem) + warp * 4 * window;
    float* sv = reinterpret_cast<float*>(sd + 2 * window);
    for (int r = warp; r < R; r += scan_warps) {
      const size_t q = (size_t)t * R + r;
      const int32_t* m = recv + q * W;
      int length, local0;
      repro::message_bounds(rv[q] != 0, m[0], m[1], e_chunk, &length,
                            &local0);
      const int32_t p2 = m[2];
      const int32_t p3 = W > 3 ? m[3] : 0;
      const float parent = __int_as_float(p2);
      int base = 0;
      if (STREAM) {
        base = repro::stage_windows(ed, ev, e_chunk, local0, window, sd, sv);
        __syncwarp();
      }
      for (int j = lane; j < max_t2; j += 32) {
        const repro::Lane l =
            STREAM ? repro::stream_lane(sd, sv, window, length, local0, base,
                                        j)
                   : repro::gather_lane(ed, ev, e_chunk, length, local0, j);
        const size_t o = eff + (size_t)r * max_t2 + j;
        int32_t a = l.dst, b;
        bool ok = l.valid;
        if (EMIT == EMIT_ONE) {
          b = ONE_BITS;
        } else if (EMIT == EMIT_WEDGE) {
          b = p2;
          ok = ok && l.dst > p2;
        } else if (EMIT == EMIT_CLOSE) {
          a = p2;
          b = l.dst;
          ok = ok && l.dst > p3;
        } else {
          b = __float_as_int(emit<EMIT>(parent, l.w));
        }
        mt[2 * o] = a;
        mt[2 * o + 1] = b;
        mvt[o] = ok;
        my_edges += l.valid;
      }
      if (STREAM) __syncwarp();
    }
  }
  // spill-only queue's replay turn (no fresh rows)
  const int cu = uq_count[t];
  const int n_pop = imin(dyn_pops[nchan * t + chan], cu);
  repro::fifo_shift(uq + (size_t)t * cap_u * 2, uq_out + (size_t)t * cap_u * 2,
                    mt, cap_u, 2, cu, 0, n_pop, eff,
                    [](int, int) { return 0; });
  for (int i = tid; i < eff; i += blockDim.x) mvt[i] = i < n_pop;
  const int n_edges = repro::block_sum(my_edges, sm);
  if (tid == 0) {
    const int n_push = imin(nsp, imax(cap_r - c0, 0));
    rq_count_out[t] = c0 + n_push;
    uq_count_out[t] = cu - n_pop;
    drops[t] = nsp - n_push;
    edges[t] = n_edges;
    npop_out[t] = n_pop;
    npush_out[t] = 0;
    nspill_out[t] = nsp;
  }
}

// ---------------------------------------------------------------------------
// Leg 2 (the fold leg), over a grid (T, G + 1): block (t, g < G) owns the
// columns [lo, hi) = [g * step, min((g + 1) * step, v_chunk)) of tile t's
// slice.  It copies that range of `target` to `out`, then folds the tile's
// R delivered (vertex, value) rows whose slot lies in it: min (float
// atomics by integer order, exact in any order) and the re-arm flags |
// (out < target); the ordered add (ordered_scatter.cuh, over the in-range
// rows only); or k-core's threshold fold: the ordered add of -value, then
// newly = (acc == 0) & (out < k), acc_out = newly ? 1 : acc and flags |
// newly.  Invalid rows go
// to the v_chunk trash slot, which no range holds.  Block (t, G) appends
// the update spills onto the update queue uq in place, at its count (what
// the plain stage's copy-and-append gives; leg 1 of the round made that
// queue, and nothing else reads it), and writes the tile's four counts: a
// block of its own, since the append's block scans over S spill rows
// (32,832 on the main path) take as long as a range's fold.  Every write
// lies in the block's own range, its own tile's queue slots or its own
// tile's counts, so no block waits on another.
// ---------------------------------------------------------------------------
template <int FOLD>
__global__ void __launch_bounds__(FOLD_THREADS)
fused_leg2_kernel(int32_t* uq, const int32_t* __restrict__ uq_count,
                  const int32_t* __restrict__ sp,
                  const uint8_t* __restrict__ spv,
                  const int32_t* __restrict__ recv,
                  const uint8_t* __restrict__ rv,
                  const float* __restrict__ target,
                  const uint8_t* __restrict__ flags,
                  const float* __restrict__ acc,
                  int32_t* __restrict__ uq_count_out,
                  float* __restrict__ out, uint8_t* __restrict__ flags_out,
                  float* __restrict__ acc_out, int32_t* __restrict__ drops,
                  int32_t* __restrict__ applied,
                  int32_t* __restrict__ nspill_out, int cap_u, int S, int R,
                  int v_chunk, int step, int k) {
  extern __shared__ __align__(16) unsigned char fold_smem[];
  __shared__ int sm[33];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int32_t* rc = recv + (size_t)t * R * 2;
  const uint8_t* rvt = rv + (size_t)t * R;
  if (blockIdx.y == gridDim.y - 1) {
    // the tile's update-spill re-queue, in place, and its counts
    const int c0 = uq_count[t];
    const int nsp = repro::queue_append_block(
        uq + (size_t)t * cap_u * 2, cap_u, 2, c0, sp + (size_t)t * S * 2,
        spv + (size_t)t * S, S, sm);
    int my_applied = 0;
    for (int r = tid; r < R; r += blockDim.x) my_applied += rvt[r] != 0;
    const int n_applied = repro::block_sum(my_applied, sm);
    if (tid == 0) {
      const int n_push = imin(nsp, imax(cap_u - c0, 0));
      uq_count_out[t] = c0 + n_push;
      drops[t] = nsp - n_push;
      applied[t] = n_applied;
      nspill_out[t] = nsp;
    }
    return;
  }
  // T3 on the rows of this block's range, while half the block copies the
  // range of the target (ordered_scatter.cuh *_fold_beside)
  const int lo = blockIdx.y * step, hi = imin(lo + step, v_chunk);
  const size_t vt = (size_t)t * v_chunk;
  // the flag passes read 4 slots a thread, as vectors where the tile's
  // slices are aligned (then lo and hi are multiples of 4)
  const uintptr_t f32s = reinterpret_cast<uintptr_t>(target) |
                         reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(acc) |
                         reinterpret_cast<uintptr_t>(acc_out);
  const uintptr_t u8s = reinterpret_cast<uintptr_t>(flags) |
                        reinterpret_cast<uintptr_t>(flags_out);
  const bool vec = v_chunk % 4 == 0 && (f32s & 15) == 0 && (u8s & 3) == 0;
  const bool rc_vec = (reinterpret_cast<uintptr_t>(rc) & 7) == 0;
  const auto load = [&](int r) {
    const int2 m = rc_vec ? reinterpret_cast<const int2*>(rc)[r]
                          : make_int2(rc[2 * r], rc[2 * r + 1]);
    const float x = __int_as_float(m.y);
    return repro::SlotValue{rvt[r] ? repro::floor_mod(m.x, v_chunk) : v_chunk,
                            FOLD == FOLD_KCORE ? -x : x};
  };
  const auto copy = [&](const repro::Team& part) {
    repro::copy_range(target + vt, out + vt, lo, hi, part);
  };
  if (FOLD == FOLD_MIN) {
    repro::min_fold_beside(out + vt, lo, hi, R, fold_smem, load, copy);
    for (int i = lo + 4 * tid; i < hi; i += 4 * blockDim.x) {
      const size_t o = vt + i;
      if (vec) {  // out after the atomics: read past L1
        const float4 x = __ldcg(reinterpret_cast<const float4*>(out + o));
        const float4 y = *reinterpret_cast<const float4*>(target + o);
        uchar4 f = *reinterpret_cast<const uchar4*>(flags + o);
        f.x |= x.x < y.x;
        f.y |= x.y < y.y;
        f.z |= x.z < y.z;
        f.w |= x.w < y.w;
        *reinterpret_cast<uchar4*>(flags_out + o) = f;
      } else {
        for (int j = 0; j < 4 && i + j < hi; ++j)
          flags_out[o + j] =
              flags[o + j] | (__ldcg(out + o + j) < target[o + j]);
      }
    }
  } else {
    repro::add_fold_beside(out + vt, lo, hi, step, R, fold_smem, load,
                           copy);
    if (FOLD == FOLD_KCORE) {
      const float kf = __int2float_rn(k);
      for (int i = lo + 4 * tid; i < hi; i += 4 * blockDim.x) {
        const size_t o = vt + i;
        float a[4] = {}, x[4] = {};
        uint8_t f[4] = {};
        const int m = imin(4, hi - i);
        if (vec) {
          const float4 av = *reinterpret_cast<const float4*>(acc + o);
          const float4 xv = __ldcg(reinterpret_cast<const float4*>(out + o));
          const uchar4 fv = *reinterpret_cast<const uchar4*>(flags + o);
          a[0] = av.x, a[1] = av.y, a[2] = av.z, a[3] = av.w;
          x[0] = xv.x, x[1] = xv.y, x[2] = xv.z, x[3] = xv.w;
          f[0] = fv.x, f[1] = fv.y, f[2] = fv.z, f[3] = fv.w;
        } else {
          for (int j = 0; j < m; ++j) {
            a[j] = acc[o + j];
            x[j] = __ldcg(out + o + j);
            f[j] = flags[o + j];
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool newly = a[j] == 0.0f && x[j] < kf;
          a[j] = newly ? 1.0f : a[j];
          f[j] |= newly;
        }
        if (vec) {
          *reinterpret_cast<float4*>(acc_out + o) =
              make_float4(a[0], a[1], a[2], a[3]);
          *reinterpret_cast<uchar4*>(flags_out + o) =
              make_uchar4(f[0], f[1], f[2], f[3]);
        } else {
          for (int j = 0; j < m; ++j) {
            acc_out[o + j] = a[j];
            flags_out[o + j] = f[j];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Triangles leg 2 (the wedge leg).  queue_append of the wedge spills onto a
// copy of the wedge queue; wedge_to_range of the R delivered wedges (u, v):
// rows (start, start + deg, v, u) of u's adjacency, valid iff the wedge is
// valid and deg > 0, compacted in row order into shared memory (only the
// rows that fit the range2 queue are kept; the others drop); fifo_turn of
// the width-4 range2 queue with them (pop dyn_pops[nchan * t + chan]);
// range_split of the popped tasks into the messages; queue_append of the
// remainders.  Work is 0 (the wedge channel counts none).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(LEG_THREADS)
fused_wedge_leg_kernel(const int32_t* __restrict__ wq,
                       const int32_t* __restrict__ wq_count,
                       const int32_t* __restrict__ sp,
                       const uint8_t* __restrict__ spv,
                       const int32_t* __restrict__ recv,
                       const uint8_t* __restrict__ rv,
                       const int32_t* __restrict__ ptr_start,
                       const int32_t* __restrict__ deg,
                       const int32_t* __restrict__ rq,
                       const int32_t* __restrict__ rq_count,
                       const int32_t* __restrict__ dyn_pops,
                       int32_t* __restrict__ wq_out,
                       int32_t* __restrict__ wq_count_out,
                       int32_t* __restrict__ rq_out,
                       int32_t* __restrict__ rq_count_out,
                       int32_t* __restrict__ msgs,
                       uint8_t* __restrict__ mvalid,
                       int32_t* __restrict__ drops,
                       int32_t* __restrict__ work,
                       int32_t* __restrict__ npop_out,
                       int32_t* __restrict__ npush_out,
                       int32_t* __restrict__ nspill_out, int cap_w, int S,
                       int R, int v_chunk, int e_chunk, int cap_r, int r_pop,
                       int max_t2, int nchan, int chan) {
  extern __shared__ __align__(16) unsigned char wedge_smem[];
  int32_t* s_fresh = reinterpret_cast<int32_t*>(wedge_smem);  // rows of 4
  __shared__ int sm[33];
  __shared__ int32_t s_taken[LEG0_MAX_ROWS * 4];  // popped tasks, then rem
  __shared__ uint8_t s_remv[LEG0_MAX_ROWS];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  // wedge-spill re-queue
  const int32_t* wqt = wq + (size_t)t * cap_w * 2;
  int32_t* wqo = wq_out + (size_t)t * cap_w * 2;
  for (int e = tid; e < cap_w * 2; e += blockDim.x) wqo[e] = wqt[e];
  __syncthreads();
  const int cw = wq_count[t];
  const int nsp = repro::queue_append_block(
      wqo, cap_w, 2, cw, sp + (size_t)t * S * 2, spv + (size_t)t * S, S, sm);
  // wedge_to_range, compacted: row pos of s_fresh for pos < room
  const int c0 = rq_count[t];
  const int room = imax(cap_r - c0, 0);
  const int32_t* rc = recv + (size_t)t * R * 2;
  const uint8_t* rvt = rv + (size_t)t * R;
  const size_t vt = (size_t)t * v_chunk;
  int nvalid = 0;  // block-uniform
  for (int base = 0; base < R; base += blockDim.x) {
    const int r = base + tid;
    int st = 0, dg = 0, u = 0, v = 0;
    if (r < R && rvt[r]) {
      u = rc[2 * r];
      v = rc[2 * r + 1];
      const size_t o = vt + repro::floor_mod(u, v_chunk);
      st = ptr_start[o];
      dg = deg[o];
    }
    const int ok = dg > 0;
    int total;
    const int pos = nvalid + repro::block_excl_scan(ok, &total, sm);
    if (ok && pos < room) {
      int32_t* f = s_fresh + 4 * (size_t)pos;
      f[0] = st;
      f[1] = repro::wrap_add(st, dg);
      f[2] = v;
      f[3] = u;
    }
    nvalid += total;
  }
  __syncthreads();
  const int n_push0 = imin(nvalid, room);
  const int c2 = c0 + n_push0;
  const int n_pop = imin(dyn_pops[nchan * t + chan], c2);
  const int eff = imin(r_pop, cap_r);
  int32_t* rqo = rq_out + (size_t)t * cap_r * 4;
  repro::fifo_shift(rq + (size_t)t * cap_r * 4, rqo, s_taken, cap_r, 4, c0,
                    n_push0, n_pop, eff, [&](int j, int col) {
                      return s_fresh[4 * (size_t)j + col];
                    });
  __syncthreads();
  // T1 on the popped tasks; the remainders replace them
  for (int i = tid; i < eff; i += blockDim.x) {
    int32_t* tk = s_taken + 4 * i;
    const int ts = tk[0], te = tk[1];
    const int stop = range_stop(ts, te, e_chunk, max_t2);
    const bool tv = i < n_pop;
    int32_t* m = msgs + ((size_t)t * eff + i) * 4;
    m[0] = ts;
    m[1] = stop;
    m[2] = tk[2];
    m[3] = tk[3];
    mvalid[(size_t)t * eff + i] = tv;
    tk[0] = stop;
    tk[1] = te;
    s_remv[i] = tv && stop < te;
  }
  __syncthreads();
  const int c3 = c2 - n_pop;
  const int nrem =
      repro::queue_append_block(rqo, cap_r, 4, c3, s_taken, s_remv, eff, sm);
  if (tid == 0) {
    const int n_wpush = imin(nsp, imax(cap_w - cw, 0));
    const int n_push1 = imin(nrem, imax(cap_r - c3, 0));
    wq_count_out[t] = cw + n_wpush;
    rq_count_out[t] = c3 + n_push1;
    drops[t] = (nsp - n_wpush) + (nvalid - n_push0) + (nrem - n_push1);
    work[t] = 0;
    npop_out[t] = n_pop;
    npush_out[t] = nvalid + nrem;
    nspill_out[t] = nsp;
  }
}

// program.py _segment_contains: is `target` in the sorted segment
// ed[lo : lo + dg]?  The bounded binary search of `steps` =
// max(1, bit_length(e_chunk)) steps, every probe clamped to the shard.  Once
// left >= right no step changes anything, so the loop may stop there.
__device__ __forceinline__ bool segment_contains(const int32_t* __restrict__ ed,
                                                 int e_chunk, int lo, int dg,
                                                 int target, int steps) {
  const int end = repro::wrap_add(lo, dg);
  int left = lo, right = end;
  for (int s = 0; s < steps && left < right; ++s) {
    const int mid = repro::floor_div(repro::wrap_add(left, right), 2);
    const int at = ed[imin(imax(mid, 0), e_chunk - 1)];
    if (at < target)
      left = repro::wrap_add(mid, 1);
    else
      right = mid;
  }
  return left < end && ed[imin(imax(left, 0), e_chunk - 1)] == target;
}

// ---------------------------------------------------------------------------
// Triangles leg 4 (the close leg).  queue_append of the close spills onto a
// copy of the close queue; for each delivered (v, w): found = the closing
// edge (v, w) is in v's sorted local segment; the ordered add of found (0 or
// 1) into acc at v's slot (invalid rows: the trash slot); work = the found
// count.  acc holds integers below 2^24, so the adds are exact in any order;
// the ordered add keeps the plain version's order all the same.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(LEG_THREADS)
fused_close_leg_kernel(const int32_t* __restrict__ cq,
                       const int32_t* __restrict__ cq_count,
                       const int32_t* __restrict__ sp,
                       const uint8_t* __restrict__ spv,
                       const int32_t* __restrict__ recv,
                       const uint8_t* __restrict__ rv,
                       const int32_t* __restrict__ ptr_start,
                       const int32_t* __restrict__ deg,
                       const int32_t* __restrict__ edge_dst,
                       const float* __restrict__ acc,
                       int32_t* __restrict__ cq_out,
                       int32_t* __restrict__ cq_count_out,
                       float* __restrict__ acc_out,
                       int32_t* __restrict__ drops,
                       int32_t* __restrict__ found_out,
                       int32_t* __restrict__ nspill_out, int cap_c, int S,
                       int R, int v_chunk, int e_chunk, int steps) {
  extern __shared__ __align__(16) unsigned char fold_smem[];
  __shared__ int sm[33];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  // close-spill re-queue
  const int32_t* cqt = cq + (size_t)t * cap_c * 2;
  int32_t* cqo = cq_out + (size_t)t * cap_c * 2;
  for (int e = tid; e < cap_c * 2; e += blockDim.x) cqo[e] = cqt[e];
  const size_t vt = (size_t)t * v_chunk;
  repro::copy_slice(acc + vt, acc_out + vt, v_chunk);
  __syncthreads();
  const int c0 = cq_count[t];
  const int nsp = repro::queue_append_block(
      cqo, cap_c, 2, c0, sp + (size_t)t * S * 2, spv + (size_t)t * S, S, sm);
  // the search of each row, inside the ordered add's row reader
  const int32_t* rc = recv + (size_t)t * R * 2;
  const uint8_t* rvt = rv + (size_t)t * R;
  const int32_t* ed = edge_dst + (size_t)t * e_chunk;
  int my_found = 0;
  repro::ordered_add_rows_by(
      acc_out + vt, 0, v_chunk, R, fold_smem, [&](int i, int* s, float* v) {
        int slot = v_chunk;
        bool found = false;
        if (rvt[i]) {
          slot = repro::floor_mod(rc[2 * i], v_chunk);
          const int lo = repro::floor_mod(ptr_start[vt + slot], e_chunk);
          found = segment_contains(ed, e_chunk, lo, deg[vt + slot],
                                   rc[2 * i + 1], steps);
        }
        my_found += found;
        *s = slot;
        *v = found ? 1.0f : 0.0f;
      });
  const int n_found = repro::block_sum(my_found, sm);
  if (tid == 0) {
    const int n_push = imin(nsp, imax(cap_c - c0, 0));
    cq_count_out[t] = c0 + n_push;
    drops[t] = nsp - n_push;
    found_out[t] = n_found;
    nspill_out[t] = nsp;
  }
}

// Dynamic shared memory beside the kernels' static arrays: above 48 KiB in
// all it needs the opt-in, so every launch that takes some sets it.
template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem == 0) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Every instantiation of a leg kernel has the same signature.
using Leg0Kernel = decltype(&fused_leg0_kernel<PAY_VALUE, POLICY_TRAFFIC, 2>);

cudaError_t launch_leg0(Leg0Kernel kernel, int T, cudaStream_t stream,
                        const void* frontier, const void* value,
                        const void* deg, const void* ptr_start, const void* rq,
                        const void* rq_count, const Downstream& down,
                        const void* pressure, void* frontier_out, void* rq_out,
                        void* rq_count_out, void* msgs, void* mvalid,
                        void* drops, void* dyn_pops, void* npop, void* npush,
                        int v_chunk, int e_chunk, int cap_r, int f_pop,
                        int r_pop, int max_t2, int plimit) {
  kernel<<<T, LEG_THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(frontier), static_cast<const float*>(value),
      static_cast<const int32_t*>(deg), static_cast<const int32_t*>(ptr_start),
      static_cast<const int32_t*>(rq), static_cast<const int32_t*>(rq_count),
      down, static_cast<const int32_t*>(pressure),
      static_cast<uint8_t*>(frontier_out), static_cast<int32_t*>(rq_out),
      static_cast<int32_t*>(rq_count_out), static_cast<int32_t*>(msgs),
      static_cast<uint8_t*>(mvalid), static_cast<int32_t*>(drops),
      static_cast<int32_t*>(dyn_pops), static_cast<int32_t*>(npop),
      static_cast<int32_t*>(npush), v_chunk, e_chunk, cap_r, f_pop, r_pop,
      max_t2, plimit);
  return cudaGetLastError();
}

using Leg1Kernel = decltype(&fused_leg1_kernel<EMIT_PLUS1, false, 3>);

cudaError_t launch_leg1(Leg1Kernel kernel, int T, size_t smem,
                        cudaStream_t stream, const void* rq,
                        const void* rq_count, const void* sp, const void* spv,
                        const void* recv, const void* rv, const void* edge_dst,
                        const void* edge_val, const void* uq,
                        const void* uq_count, const void* dyn_pops,
                        void* rq_out, void* rq_count_out, void* uq_out,
                        void* uq_count_out, void* msgs, void* mvalid,
                        void* drops, void* edges, void* npop, void* npush,
                        void* nspill, int cap_r, int S, int R, int e_chunk,
                        int max_t2, int window, int cap_u, int u_pop,
                        int warps, int nchan, int chan) {
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<T, LEG_THREADS, smem, stream>>>(
      static_cast<const int32_t*>(rq), static_cast<const int32_t*>(rq_count),
      static_cast<const int32_t*>(sp), static_cast<const uint8_t*>(spv),
      static_cast<const int32_t*>(recv), static_cast<const uint8_t*>(rv),
      static_cast<const int32_t*>(edge_dst),
      static_cast<const float*>(edge_val), static_cast<const int32_t*>(uq),
      static_cast<const int32_t*>(uq_count),
      static_cast<const int32_t*>(dyn_pops), static_cast<int32_t*>(rq_out),
      static_cast<int32_t*>(rq_count_out), static_cast<int32_t*>(uq_out),
      static_cast<int32_t*>(uq_count_out), static_cast<int32_t*>(msgs),
      static_cast<uint8_t*>(mvalid), static_cast<int32_t*>(drops),
      static_cast<int32_t*>(edges), static_cast<int32_t*>(npop),
      static_cast<int32_t*>(npush), static_cast<int32_t*>(nspill), cap_r, S,
      R, e_chunk, max_t2, window, cap_u, u_pop, warps, nchan, chan);
  return cudaGetLastError();
}

using Leg2Kernel = decltype(&fused_leg2_kernel<FOLD_MIN>);

cudaError_t launch_leg2(Leg2Kernel kernel, int T, int G, size_t smem,
                        cudaStream_t stream, void* uq, const void* uq_count,
                        const void* sp, const void* spv, const void* recv,
                        const void* rv, const void* target, const void* flags,
                        const void* acc, void* uq_count_out, void* out,
                        void* flags_out, void* acc_out, void* drops,
                        void* applied, void* nspill, int cap_u, int S, int R,
                        int v_chunk, int step, int k) {
  if (!repro::valid_split(v_chunk, G, step)) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(T, G + 1), FOLD_THREADS, smem, stream>>>(
      static_cast<int32_t*>(uq), static_cast<const int32_t*>(uq_count),
      static_cast<const int32_t*>(sp), static_cast<const uint8_t*>(spv),
      static_cast<const int32_t*>(recv), static_cast<const uint8_t*>(rv),
      static_cast<const float*>(target), static_cast<const uint8_t*>(flags),
      static_cast<const float*>(acc), static_cast<int32_t*>(uq_count_out),
      static_cast<float*>(out), static_cast<uint8_t*>(flags_out),
      static_cast<float*>(acc_out), static_cast<int32_t*>(drops),
      static_cast<int32_t*>(applied), static_cast<int32_t*>(nspill), cap_u,
      S, R, v_chunk, step, k);
  return cudaGetLastError();
}

int scan_warps(int window) {  // warps of the scan leg; 0: window too wide
  const int warps = LEG_THREADS / 32;
  if (window == 0) return warps;
  const int fit = STAGE_SMEM / (16 * window);
  return fit < warps ? fit : warps;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Leg 0 of the 2-channel programs (classic, k-core).
int repro_fused_leg0(const void* frontier, const void* value, const void* deg,
                     const void* ptr_start, const void* rq,
                     const void* rq_count, const void* uq_count,
                     const void* pressure, void* frontier_out, void* rq_out,
                     void* rq_count_out, void* msgs, void* mvalid, void* drops,
                     void* dyn_pops, void* npop, void* npush, int T,
                     int v_chunk, int e_chunk, int cap_r, int cap_u, int f_pop,
                     int r_pop, int u_pop, int max_t2, int plimit, int payload,
                     int policy, void* stream) {
  if (f_pop > LEG0_MAX_ROWS || r_pop > LEG0_MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  Leg0Kernel kernel = nullptr;
  const bool traffic = policy == POLICY_TRAFFIC;
  switch (payload) {
    case PAY_VALUE:
      kernel = traffic ? fused_leg0_kernel<PAY_VALUE, POLICY_TRAFFIC, 2>
                       : fused_leg0_kernel<PAY_VALUE, POLICY_STATIC, 2>;
      break;
    case PAY_VALUE_OVER_DEG:
      kernel = traffic
                   ? fused_leg0_kernel<PAY_VALUE_OVER_DEG, POLICY_TRAFFIC, 2>
                   : fused_leg0_kernel<PAY_VALUE_OVER_DEG, POLICY_STATIC, 2>;
      break;
    case PAY_ONE:
      kernel = traffic ? fused_leg0_kernel<PAY_ONE, POLICY_TRAFFIC, 2>
                       : fused_leg0_kernel<PAY_ONE, POLICY_STATIC, 2>;
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const Downstream down{{static_cast<const int32_t*>(uq_count)},
                        {cap_u},
                        {u_pop}};
  return static_cast<int>(launch_leg0(
      kernel, T, static_cast<cudaStream_t>(stream), frontier, value, deg,
      ptr_start, rq, rq_count, down, pressure, frontier_out, rq_out,
      rq_count_out, msgs, mvalid, drops, dyn_pops, npop, npush, v_chunk,
      e_chunk, cap_r, f_pop, r_pop, max_t2, plimit));
}

// Leg 0 of the 4-channel triangles chain (placed-id payload).
int repro_fused_leg0_chain(
    const void* frontier, const void* value, const void* deg,
    const void* ptr_start, const void* rq, const void* rq_count,
    const void* count1, const void* count2, const void* count3,
    const void* pressure, void* frontier_out, void* rq_out,
    void* rq_count_out, void* msgs, void* mvalid, void* drops, void* dyn_pops,
    void* npop, void* npush, int T, int v_chunk, int e_chunk, int cap_r,
    int cap1, int cap2, int cap3, int f_pop, int r_pop, int pop1, int pop2,
    int pop3, int max_t2, int plimit, int payload, int policy, void* stream) {
  if (f_pop > LEG0_MAX_ROWS || r_pop > LEG0_MAX_ROWS || payload != PAY_PLACED)
    return static_cast<int>(cudaErrorInvalidValue);
  const Leg0Kernel kernel =
      policy == POLICY_TRAFFIC
          ? fused_leg0_kernel<PAY_PLACED, POLICY_TRAFFIC, 4>
          : fused_leg0_kernel<PAY_PLACED, POLICY_STATIC, 4>;
  const Downstream down{{static_cast<const int32_t*>(count1),
                         static_cast<const int32_t*>(count2),
                         static_cast<const int32_t*>(count3)},
                        {cap1, cap2, cap3},
                        {pop1, pop2, pop3}};
  return static_cast<int>(launch_leg0(
      kernel, T, static_cast<cudaStream_t>(stream), frontier, value, deg,
      ptr_start, rq, rq_count, down, pressure, frontier_out, rq_out,
      rq_count_out, msgs, mvalid, drops, dyn_pops, npop, npush, v_chunk,
      e_chunk, cap_r, f_pop, r_pop, max_t2, plimit));
}

// Leg 1 of the 2-channel programs: resident or streamed (window > 0).
int repro_fused_leg1(const void* rq, const void* rq_count, const void* sp,
                     const void* spv, const void* recv, const void* rv,
                     const void* edge_dst, const void* edge_val,
                     const void* uq, const void* uq_count,
                     const void* dyn_pops, void* rq_out, void* rq_count_out,
                     void* uq_out, void* uq_count_out, void* msgs,
                     void* mvalid, void* drops, void* edges, void* npop,
                     void* npush, void* nspill, int T, int cap_r, int S, int R,
                     int e_chunk, int max_t2, int window, int cap_u,
                     int u_pop, int emit_code, void* stream) {
  const bool streamed = window > 0;
  const int warps = scan_warps(window);
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = streamed ? (size_t)warps * 16 * window : 0;
  Leg1Kernel kernel = nullptr;
  switch (2 * emit_code + (streamed ? 1 : 0)) {
    case 0: kernel = fused_leg1_kernel<EMIT_PLUS1, false, 3>; break;
    case 1: kernel = fused_leg1_kernel<EMIT_PLUS1, true, 3>; break;
    case 2: kernel = fused_leg1_kernel<EMIT_PLUS_W, false, 3>; break;
    case 3: kernel = fused_leg1_kernel<EMIT_PLUS_W, true, 3>; break;
    case 4: kernel = fused_leg1_kernel<EMIT_COPY, false, 3>; break;
    case 5: kernel = fused_leg1_kernel<EMIT_COPY, true, 3>; break;
    case 6: kernel = fused_leg1_kernel<EMIT_TIMES_W, false, 3>; break;
    case 7: kernel = fused_leg1_kernel<EMIT_TIMES_W, true, 3>; break;
    case 8: kernel = fused_leg1_kernel<EMIT_ONE, false, 3>; break;
    case 9: kernel = fused_leg1_kernel<EMIT_ONE, true, 3>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_leg1(
      kernel, T, smem, static_cast<cudaStream_t>(stream), rq, rq_count, sp,
      spv, recv, rv, edge_dst, edge_val, uq, uq_count, dyn_pops, rq_out,
      rq_count_out, uq_out, uq_count_out, msgs, mvalid, drops, edges, npop,
      npush, nspill, cap_r, S, R, e_chunk, max_t2, window, cap_u, u_pop,
      warps, 2, 1));
}

// Legs 1 and 3 of the triangles chain (resident shard): the range channel
// chan - 1 of width 3 (wedge emit) or 4 (close emit), the spill-only
// channel chan.
int repro_fused_leg1_chain(
    const void* rq, const void* rq_count, const void* sp, const void* spv,
    const void* recv, const void* rv, const void* edge_dst,
    const void* edge_val, const void* uq, const void* uq_count,
    const void* dyn_pops, void* rq_out, void* rq_count_out, void* uq_out,
    void* uq_count_out, void* msgs, void* mvalid, void* drops, void* edges,
    void* npop, void* npush, void* nspill, int T, int cap_r, int S, int R,
    int e_chunk, int max_t2, int cap_u, int u_pop, int nchan, int chan,
    int emit_code, void* stream) {
  Leg1Kernel kernel = nullptr;
  if (emit_code == EMIT_WEDGE)
    kernel = fused_leg1_kernel<EMIT_WEDGE, false, 3>;
  else if (emit_code == EMIT_CLOSE)
    kernel = fused_leg1_kernel<EMIT_CLOSE, false, 4>;
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_leg1(
      kernel, T, 0, static_cast<cudaStream_t>(stream), rq, rq_count, sp, spv,
      recv, rv, edge_dst, edge_val, uq, uq_count, dyn_pops, rq_out,
      rq_count_out, uq_out, uq_count_out, msgs, mvalid, drops, edges, npop,
      npush, nspill, cap_r, S, R, e_chunk, max_t2, 0, cap_u, u_pop,
      scan_warps(0), nchan, chan));
}

// Leg 2 of the classic program: the min or the add fold, over a grid (T, G)
// of column ranges of `step` slots; the spills append to uq in place.
int repro_fused_leg2(void* uq, const void* uq_count, const void* sp,
                     const void* spv, const void* recv, const void* rv,
                     const void* target, const void* flags,
                     void* uq_count_out, void* out, void* flags_out,
                     void* drops, void* applied, void* nspill, int T,
                     int cap_u, int S, int R, int v_chunk, int G, int step,
                     int fold, void* stream) {
  Leg2Kernel kernel = fused_leg2_kernel<FOLD_MIN>;
  size_t smem = repro::min_fold_smem(R);
  if (fold == FOLD_ADD) {
    kernel = fused_leg2_kernel<FOLD_ADD>;
    smem = repro::ordered_add_smem(R, step);
  } else if (fold != FOLD_MIN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_leg2(
      kernel, T, G, smem, static_cast<cudaStream_t>(stream), uq, uq_count,
      sp, spv, recv, rv, target, flags, nullptr, uq_count_out, out,
      flags_out, nullptr, drops, applied, nspill, cap_u, S, R, v_chunk, step,
      0));
}

// Leg 2 of k-core: the threshold fold into value, acc and the flags, over
// the same grid; the spills append to uq in place.
int repro_fused_kcore_leg2(void* uq, const void* uq_count, const void* sp,
                           const void* spv, const void* recv, const void* rv,
                           const void* value, const void* flags,
                           const void* acc, void* uq_count_out,
                           void* value_out, void* flags_out, void* acc_out,
                           void* drops, void* applied, void* nspill, int T,
                           int cap_u, int S, int R, int v_chunk, int G,
                           int step, int k, void* stream) {
  return static_cast<int>(launch_leg2(
      fused_leg2_kernel<FOLD_KCORE>, T, G, repro::ordered_add_smem(R, step),
      static_cast<cudaStream_t>(stream), uq, uq_count, sp, spv, recv, rv,
      value, flags, acc, uq_count_out, value_out, flags_out, acc_out, drops,
      applied, nspill, cap_u, S, R, v_chunk, step, k));
}

// Leg 2 of triangles: wedge re-queue, wedge_to_range, range2 turn and split.
int repro_fused_wedge_leg(
    const void* wq, const void* wq_count, const void* sp, const void* spv,
    const void* recv, const void* rv, const void* ptr_start, const void* deg,
    const void* rq, const void* rq_count, const void* dyn_pops, void* wq_out,
    void* wq_count_out, void* rq_out, void* rq_count_out, void* msgs,
    void* mvalid, void* drops, void* work, void* npop, void* npush,
    void* nspill, int T, int cap_w, int S, int R, int v_chunk, int e_chunk,
    int cap_r, int r_pop, int max_t2, int nchan, int chan, int fresh_rows,
    void* stream) {
  if (r_pop > LEG0_MAX_ROWS || fresh_rows < (R < cap_r ? R : cap_r))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)fresh_rows * 16;
  const cudaError_t e = allow_smem(fused_wedge_leg_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_wedge_leg_kernel<<<T, LEG_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(wq), static_cast<const int32_t*>(wq_count),
      static_cast<const int32_t*>(sp), static_cast<const uint8_t*>(spv),
      static_cast<const int32_t*>(recv), static_cast<const uint8_t*>(rv),
      static_cast<const int32_t*>(ptr_start),
      static_cast<const int32_t*>(deg), static_cast<const int32_t*>(rq),
      static_cast<const int32_t*>(rq_count),
      static_cast<const int32_t*>(dyn_pops), static_cast<int32_t*>(wq_out),
      static_cast<int32_t*>(wq_count_out), static_cast<int32_t*>(rq_out),
      static_cast<int32_t*>(rq_count_out), static_cast<int32_t*>(msgs),
      static_cast<uint8_t*>(mvalid), static_cast<int32_t*>(drops),
      static_cast<int32_t*>(work), static_cast<int32_t*>(npop),
      static_cast<int32_t*>(npush), static_cast<int32_t*>(nspill), cap_w, S,
      R, v_chunk, e_chunk, cap_r, r_pop, max_t2, nchan, chan);
  return static_cast<int>(cudaGetLastError());
}

// Leg 4 of triangles: close re-queue, the search and the ordered add.
int repro_fused_close_leg(
    const void* cq, const void* cq_count, const void* sp, const void* spv,
    const void* recv, const void* rv, const void* ptr_start, const void* deg,
    const void* edge_dst, const void* acc, void* cq_out, void* cq_count_out,
    void* acc_out, void* drops, void* found, void* nspill, int T, int cap_c,
    int S, int R, int v_chunk, int e_chunk, int steps, void* stream) {
  const size_t smem = repro::ordered_add_smem(R);
  const cudaError_t e = allow_smem(fused_close_leg_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_close_leg_kernel<<<T, LEG_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cq), static_cast<const int32_t*>(cq_count),
      static_cast<const int32_t*>(sp), static_cast<const uint8_t*>(spv),
      static_cast<const int32_t*>(recv), static_cast<const uint8_t*>(rv),
      static_cast<const int32_t*>(ptr_start),
      static_cast<const int32_t*>(deg),
      static_cast<const int32_t*>(edge_dst), static_cast<const float*>(acc),
      static_cast<int32_t*>(cq_out), static_cast<int32_t*>(cq_count_out),
      static_cast<float*>(acc_out), static_cast<int32_t*>(drops),
      static_cast<int32_t*>(found), static_cast<int32_t*>(nspill), cap_c, S,
      R, v_chunk, e_chunk, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
