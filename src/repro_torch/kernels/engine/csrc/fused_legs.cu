// Hopper (sm_90a) fused legs of the classic Dalorex round: each replaces one
// launch of fused_leg_call (src/repro/kernels/engine/kernel.py:241), whose
// body is the engine's per-tile stage (src/repro/core/engine.py:500; stages
// :601, :610, :626).  One block per tile runs the whole leg; its phases are
// the device functions the standalone kernels use (engine_device.cuh,
// ordered_scatter.cuh), separated by block barriers, so each output element
// is what the plain stage writes, don't-care slots included.
//
//   leg 0  TSU budgets; T4 frontier pop + payload; range-queue turn; T1
//          range split; remainder re-push           (template: payload, policy)
//   leg 1  range-spill re-queue; T2 scan, resident gather or streamed
//          windows, and emit; update-queue replay turn; replay rows ahead of
//          the fresh rows in the messages           (template: emit, stream)
//   leg 2  update-spill re-queue; T3 min fold + re-arm of the flags the
//          wrapper passes (async: frontier, BSP: next_frontier) or ordered
//          add fold                                 (template: fold)
//
// Bound: bytes.  Each leg reads its inputs once and writes its outputs once;
// the largest are the update queue (leg 1 shifts it, leg 2 copies it before
// appending: cap_updq * 8 bytes a tile each way), leg 1's messages (9 bytes
// a lane) and the (v_chunk,) slices of legs 0 and 2.  Design: every output
// is a fresh buffer (a queue shifted in place would need a read-barrier-
// write per element); data that fits stays in shared memory: leg 0's popped
// tasks and rows (at most LEG0_MAX_ROWS), leg 1's staging windows, leg 2's
// sort keys of the add fold.  The messages of leg 1 (T * cap_route_range *
// max_t2 rows) and the queues go to device memory, as in the standalone
// kernels.  Occupancy: T blocks (64 on the main path).
//
// Plain C interface, as engine_kernels.cu: device pointers, sizes, template
// codes and the caller's cudaStream_t in, cudaGetLastError() out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "engine_device.cuh"
#include "ordered_scatter.cuh"

namespace {

constexpr int LEG_THREADS = 1024;
constexpr int LEG0_MAX_ROWS = 256;   // kernels/engine/fused.py LEG0_MAX_ROWS
constexpr int STAGE_SMEM = 48 * 1024;  // leg 1's staging windows

// template codes (kernels/engine/fused.py PAYLOADS, EMITS, FOLDS, POLICIES)
enum { PAY_VALUE = 0, PAY_VALUE_OVER_DEG = 1 };
enum { EMIT_PLUS1 = 0, EMIT_PLUS_W = 1, EMIT_COPY = 2, EMIT_TIMES_W = 3 };
enum { FOLD_MIN = 0, FOLD_ADD = 1 };
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

// ---------------------------------------------------------------------------
// Leg 0.  Budgets as core/engine.py _budgets for the two channels (integer
// math of one thread); frontier_take into shared memory; the source rows
// (start, start + deg, payload) of the popped vertices, valid where deg > 0;
// fifo_turn of the range queue with them; range_split of the popped tasks
// into the messages; queue_append of the remainders onto the shifted queue.
// ---------------------------------------------------------------------------
template <int PAYLOAD, int POLICY>
__global__ void __launch_bounds__(LEG_THREADS)
fused_leg0_kernel(const uint8_t* __restrict__ frontier,
                  const float* __restrict__ value,
                  const int32_t* __restrict__ deg,
                  const int32_t* __restrict__ ptr_start,
                  const int32_t* __restrict__ rq,
                  const int32_t* __restrict__ rq_count,
                  const int32_t* __restrict__ uq_count,
                  const int32_t* __restrict__ pressure,
                  uint8_t* __restrict__ frontier_out,
                  int32_t* __restrict__ rq_out,
                  int32_t* __restrict__ rq_count_out,
                  int32_t* __restrict__ msgs, uint8_t* __restrict__ mvalid,
                  int32_t* __restrict__ drops, int32_t* __restrict__ dyn_pops,
                  int32_t* __restrict__ npop_out,
                  int32_t* __restrict__ npush_out, int v_chunk, int e_chunk,
                  int cap_r, int cap_u, int f_pop, int r_pop, int u_pop,
                  int max_t2, int plimit) {
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
    const long long occ0 = rq_count[t], occ1 = uq_count[t];
    const long long free0 = cap_r - occ0;
    long long fp;
    int p0 = r_pop;
    if (POLICY == POLICY_STATIC) {
      fp = free0 < 0 ? 0 : free0;
    } else {
      const bool hot = pressure[t] > imax(plimit, 1);
      const bool cong1 = occ1 > (3LL * cap_u) / 4;
      if (cong1 || hot) p0 = r_pop / 4;
      const bool half0 = occ0 > cap_r / 2;
      fp = free0 - 2LL * f_pop;
      if (fp < 0 || half0 || hot || cong1) fp = 0;
    }
    if (fp > f_pop) fp = f_pop;
    s_budget[0] = static_cast<int>(fp);
    s_budget[1] = p0;
    dyn_pops[2 * t] = p0;
    dyn_pops[2 * t + 1] = u_pop;
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
    float pay = value[o];
    if (PAYLOAD == PAY_VALUE_OVER_DEG)
      pay = __fdiv_rn(pay, __int2float_rn(imax(dg, 1)));
    s_rows[3 * tid] = st;
    s_rows[3 * tid + 1] = repro::wrap_add(st, dg);
    s_rows[3 * tid + 2] = __float_as_int(pay);
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
    const int boundary =
        repro::wrap_mul(repro::floor_div(ts, e_chunk) + 1, e_chunk);
    const int stop = imin(imin(te, boundary), repro::wrap_add(ts, max_t2));
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
// Leg 1.  queue_append of the range spills onto a copy of the range queue;
// T2 for the R delivered messages, one warp per message (STREAM: the warp
// first stages its two windows in shared memory), each lane emitting
// (dst, f2i(emit(parent, w))) into message row eff + r * max_t2 + j; then
// fifo_turn of the update queue with no fresh rows, its popped rows being
// message rows [0, eff).
// ---------------------------------------------------------------------------
template <int EMIT, bool STREAM>
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
                  int scan_warps) {
  extern __shared__ __align__(16) unsigned char stage_smem[];
  __shared__ int sm[33];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  // range-spill re-queue
  const int32_t* rqt = rq + (size_t)t * cap_r * 3;
  int32_t* rqo = rq_out + (size_t)t * cap_r * 3;
  for (int e = tid; e < cap_r * 3; e += blockDim.x) rqo[e] = rqt[e];
  __syncthreads();
  const int c0 = rq_count[t];
  const int nsp = repro::queue_append_block(
      rqo, cap_r, 3, c0, sp + (size_t)t * S * 3, spv + (size_t)t * S, S, sm);
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
      const int32_t* m = recv + q * 3;
      int length, local0;
      repro::message_bounds(rv[q] != 0, m[0], m[1], e_chunk, &length,
                            &local0);
      const float parent = __int_as_float(m[2]);
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
        mt[2 * o] = l.dst;
        mt[2 * o + 1] = __float_as_int(emit<EMIT>(parent, l.w));
        mvt[o] = l.valid;
        my_edges += l.valid;
      }
      if (STREAM) __syncwarp();
    }
  }
  // update-queue replay turn (no fresh rows)
  const int cu = uq_count[t];
  const int n_pop = imin(dyn_pops[2 * t + 1], cu);
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
// Leg 2.  queue_append of the update spills onto a copy of the update queue;
// then the fold of the R delivered (vertex, value) rows into the tile's
// slice: min (float atomics by integer order, exact in any order) and the
// re-arm flags | (out < target), or the ordered add (ordered_scatter.cuh).
// Invalid rows go to the v_chunk trash slot, which both folds skip.
// ---------------------------------------------------------------------------
template <int FOLD>
__global__ void __launch_bounds__(LEG_THREADS)
fused_leg2_kernel(const int32_t* __restrict__ uq,
                  const int32_t* __restrict__ uq_count,
                  const int32_t* __restrict__ sp,
                  const uint8_t* __restrict__ spv,
                  const int32_t* __restrict__ recv,
                  const uint8_t* __restrict__ rv,
                  const float* __restrict__ target,
                  const uint8_t* __restrict__ flags,
                  int32_t* __restrict__ uq_out,
                  int32_t* __restrict__ uq_count_out,
                  float* __restrict__ out, uint8_t* __restrict__ flags_out,
                  int32_t* __restrict__ drops, int32_t* __restrict__ applied,
                  int32_t* __restrict__ nspill_out, int cap_u, int S, int R,
                  int v_chunk) {
  extern __shared__ __align__(16) unsigned char fold_smem[];
  __shared__ int sm[33];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  // update-spill re-queue
  const int32_t* uqt = uq + (size_t)t * cap_u * 2;
  int32_t* uqo = uq_out + (size_t)t * cap_u * 2;
  for (int e = tid; e < cap_u * 2; e += blockDim.x) uqo[e] = uqt[e];
  const size_t vt = (size_t)t * v_chunk;
  repro::copy_slice(target + vt, out + vt, v_chunk);
  __syncthreads();
  const int c0 = uq_count[t];
  const int nsp = repro::queue_append_block(
      uqo, cap_u, 2, c0, sp + (size_t)t * S * 2, spv + (size_t)t * S, S, sm);
  // T3
  const int32_t* rc = recv + (size_t)t * R * 2;
  const uint8_t* rvt = rv + (size_t)t * R;
  int my_applied = 0;
  for (int r = tid; r < R; r += blockDim.x) my_applied += rvt[r] != 0;
  if (FOLD == FOLD_MIN) {
    for (int r = tid; r < R; r += blockDim.x)
      if (rvt[r])
        repro::atomic_min_f32(out + vt + repro::floor_mod(rc[2 * r], v_chunk),
                              __int_as_float(rc[2 * r + 1]));
    __syncthreads();
    for (int i = tid; i < v_chunk; i += blockDim.x)
      flags_out[vt + i] = flags[vt + i] | (out[vt + i] < target[vt + i]);
  } else {
    repro::ordered_add_rows_by(
        out + vt, v_chunk, R, fold_smem, [&](int i, int* s, float* v) {
          const bool ok = rvt[i] != 0;
          *s = ok ? repro::floor_mod(rc[2 * i], v_chunk) : v_chunk;
          *v = ok ? __int_as_float(rc[2 * i + 1]) : 0.0f;
        });
  }
  const int n_applied = repro::block_sum(my_applied, sm);
  if (tid == 0) {
    const int n_push = imin(nsp, imax(cap_u - c0, 0));
    uq_count_out[t] = c0 + n_push;
    drops[t] = nsp - n_push;
    applied[t] = n_applied;
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

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
  auto kernel = fused_leg0_kernel<PAY_VALUE, POLICY_TRAFFIC>;
  if (payload == PAY_VALUE && policy == POLICY_STATIC)
    kernel = fused_leg0_kernel<PAY_VALUE, POLICY_STATIC>;
  else if (payload == PAY_VALUE_OVER_DEG && policy == POLICY_TRAFFIC)
    kernel = fused_leg0_kernel<PAY_VALUE_OVER_DEG, POLICY_TRAFFIC>;
  else if (payload == PAY_VALUE_OVER_DEG)
    kernel = fused_leg0_kernel<PAY_VALUE_OVER_DEG, POLICY_STATIC>;
  kernel<<<T, LEG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frontier), static_cast<const float*>(value),
      static_cast<const int32_t*>(deg), static_cast<const int32_t*>(ptr_start),
      static_cast<const int32_t*>(rq), static_cast<const int32_t*>(rq_count),
      static_cast<const int32_t*>(uq_count),
      static_cast<const int32_t*>(pressure),
      static_cast<uint8_t*>(frontier_out), static_cast<int32_t*>(rq_out),
      static_cast<int32_t*>(rq_count_out), static_cast<int32_t*>(msgs),
      static_cast<uint8_t*>(mvalid), static_cast<int32_t*>(drops),
      static_cast<int32_t*>(dyn_pops), static_cast<int32_t*>(npop),
      static_cast<int32_t*>(npush), v_chunk, e_chunk, cap_r, cap_u, f_pop,
      r_pop, u_pop, max_t2, plimit);
  return static_cast<int>(cudaGetLastError());
}

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
  int warps = LEG_THREADS / 32;
  if (streamed) {
    const int fit = STAGE_SMEM / (16 * window);
    if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
    warps = fit < warps ? fit : warps;
  }
  const size_t smem = streamed ? (size_t)warps * 16 * window : 0;
  auto kernel = fused_leg1_kernel<EMIT_PLUS1, false>;
  switch (2 * emit_code + (streamed ? 1 : 0)) {
    case 1: kernel = fused_leg1_kernel<EMIT_PLUS1, true>; break;
    case 2: kernel = fused_leg1_kernel<EMIT_PLUS_W, false>; break;
    case 3: kernel = fused_leg1_kernel<EMIT_PLUS_W, true>; break;
    case 4: kernel = fused_leg1_kernel<EMIT_COPY, false>; break;
    case 5: kernel = fused_leg1_kernel<EMIT_COPY, true>; break;
    case 6: kernel = fused_leg1_kernel<EMIT_TIMES_W, false>; break;
    case 7: kernel = fused_leg1_kernel<EMIT_TIMES_W, true>; break;
    default: break;
  }
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<T, LEG_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
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
      R, e_chunk, max_t2, window, cap_u, u_pop, warps);
  return static_cast<int>(cudaGetLastError());
}

int repro_fused_leg2(const void* uq, const void* uq_count, const void* sp,
                     const void* spv, const void* recv, const void* rv,
                     const void* target, const void* flags, void* uq_out,
                     void* uq_count_out, void* out, void* flags_out,
                     void* drops, void* applied, void* nspill, int T,
                     int cap_u, int S, int R, int v_chunk, int fold,
                     void* stream) {
  auto kernel = fused_leg2_kernel<FOLD_MIN>;
  size_t smem = 0;
  if (fold == FOLD_ADD) {
    kernel = fused_leg2_kernel<FOLD_ADD>;
    smem = repro::ordered_add_smem(R);
  }
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<T, LEG_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(uq), static_cast<const int32_t*>(uq_count),
      static_cast<const int32_t*>(sp), static_cast<const uint8_t*>(spv),
      static_cast<const int32_t*>(recv), static_cast<const uint8_t*>(rv),
      static_cast<const float*>(target), static_cast<const uint8_t*>(flags),
      static_cast<int32_t*>(uq_out), static_cast<int32_t*>(uq_count_out),
      static_cast<float*>(out), static_cast<uint8_t*>(flags_out),
      static_cast<int32_t*>(drops), static_cast<int32_t*>(applied),
      static_cast<int32_t*>(nspill), cap_u, S, R, v_chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
