// Hopper (sm_90a) fused legs of the Dalorex round: each replaces one launch
// of fused_leg_call (src/repro/kernels/engine/kernel.py:241), whose body is
// the engine's per-tile stage (src/repro/core/engine.py:500; stages :601,
// :610, :626).  Each leg's phases are the device functions the standalone
// kernels use (engine_device.cuh, ordered_scatter.cuh), separated by block
// barriers.  Every output element below a queue's count, every valid
// message row and every other output is what the plain stage writes; leg
// 0, the scan legs and the wedge leg leave a turned queue's slots from its
// count on unwritten and write 0 into the popped message rows past the pop
// (invalid), where the plain stage keeps the reference's stale rows: both
// are don't-care to every consumer (fifo_live_turn, engine_device.cuh).
//
// Classic program (and k-core, which has its shape), 2 channels, 3 legs:
//   leg 0  TSU budgets; T4 frontier pop + payload; range-queue turn (live
//          rows); T1 range split; remainder re-push
//                                                   (template: payload, policy)
//   leg 1  range-spill re-queue (in place); T2 scan, resident gather or
//          streamed windows, and emit; update-queue replay turn (live rows);
//          replay rows ahead of the fresh rows in the messages
//                                                   (template: emit, scan)
//   leg 2  update-spill re-queue (in place); T3 min fold + re-arm of the
//          flags the wrapper passes (async: frontier, BSP: next_frontier),
//          ordered add fold, or k-core's threshold fold (ordered add of the
//          decrements, then the newly removed vertices' flags), G blocks
//          a tile on its column ranges, one on its append (template: fold)
// Triangles (src/repro/core/program.py:698), 4 channels, 5 legs:
//   leg 0  leg 0 above with the placed-id payload and the TSU over 4 queues
//   leg 1  leg 1 above, emitting wedges (nb, v) valid iff nb > v
//   leg 2  wedge-spill re-queue (in place); wedge_to_range; range2-queue
//          turn of the width-4 rows (live rows); T1 range split; remainder
//          re-push                                          (wedge leg)
//   leg 3  leg 1 above on width-4 messages, emitting (v, nb) valid iff nb > u
//   leg 4  close-spill re-queue (in place); bounded binary search of the
//          closing edge in the sorted local segment; the hits into acc by
//          per-slot counts                                  (close leg)
//
// Bound: bytes.  Each leg reads its inputs once and writes its outputs once;
// the largest are the scan leg's messages (9 bytes a lane), the (v_chunk,)
// slices of leg 0 and of the fold legs, and the live rows of the turned
// queues.  Design: a leg that appends spills onto a queue that the previous
// leg of the same round made (leg 1: the range queue of leg 0; leg 2 and
// k-core's leg 2: the update queue of leg 1; the wedge leg: the wedge queue
// of leg 1; the close leg: the close queue of leg 3) appends in place,
// moving only the rows it appends; a turned queue (leg 0's range queue, the
// scan legs' update, wedge and close queues, the wedge leg's range2 queue)
// is a fresh buffer that receives its live rows only (fifo_live_turn), so
// those bytes follow the queues' occupancy, not their capacity.  Data that
// fits stays in shared memory: leg 0's and the wedge leg's popped tasks and
// rows (dynamic shared memory sized from the pops; past STAGE_SMEM_MAX
// bytes, a device-memory scratch from the wrapper), the scan leg's staging
// windows (a window too wide for them is read from device memory), the fold
// legs' sort keys (in chunks of rows past what fits).  Occupancy: every leg
// runs a grid (T, G + 1) or (T, G + 2): G blocks a tile share its work (leg
// 0: the range queue's old live rows, one block a 32,768 rows of its
// capacity, kernels/engine/fused.py leg0_split; leg 2: column ranges; the
// scan leg: messages and live rows; the wedge leg: wedges and live rows;
// the close leg: its searches; G = 5 on the main paths,
// kernels/engine/kernel.py column_split), one more its append (leg 0: its
// frontier take and pop; the wedge leg: also its pop).  The close leg's
// binary search reads the shard word-random, at most bit_length(e_chunk) +
// 1 words a row, CLOSE_ROWS searches of a thread in flight together.
//
// The lane axis: the grid's T rows may be B * T lane-major rows of B
// serving lanes over one shard of shard_T = T rows; leg 0 and the scan legs
// read shard row t % shard_T for row t, the other legs touch state only.
// Leg 0's placed-id payload takes the tile id tile0 + t % shard_T: tile0 is
// the tile of shard row 0, 0 where every tile is a row of the launch, the
// rank where a process runs one tile (SPMD, core/comm.py AxisComm).
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
constexpr int SPLIT_THREADS = 512;   // the scan and wedge legs' grid blocks
constexpr int STAGE_SMEM = 48 * 1024;  // the scan leg's staging windows
constexpr int32_t ONE_BITS = 0x3f800000;  // the bits of 1.0f

// template codes (kernels/engine/fused.py PAYLOADS, EMITS, FOLDS, POLICIES)
// and the scan leg's ways to read the shard (resident gather; streamed
// windows staged in shared memory, or read from device memory)
enum { PAY_VALUE = 0, PAY_VALUE_OVER_DEG = 1, PAY_ONE = 2, PAY_PLACED = 3 };
enum { SCAN_GATHER = 0, SCAN_STAGED = 1, SCAN_GLOBAL = 2 };
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
// Leg 0, over a grid (T, G + 1).  Budgets as core/engine.py _budgets for K
// channels (integer math on the queue counts and the net pressure alone; a
// throttled producer gets pop / 4 when K == 2 and 0 on deeper chains);
// frontier_take into the staging; the source rows (start, start + deg,
// payload) of the popped vertices, valid where deg > 0; fifo_turn of the
// range queue with them, keeping its live rows only; range_split of the
// popped tasks into the messages; queue_append of the remainders onto the
// turned queue.  The pop is n_pop = min(pops[0], c0 + n_push0), so where
// pops[0] < c0 it is pops[0] whatever the frontier gives, and the old rows
// [n_pop, c0) survive: blocks (t, 1 + g), g < G, compute the budgets
// themselves and move share g of those rows (fifo_live_turn); otherwise no
// old row survives.  Block (t, 0), which the scheduler starts first (its
// chain is the tile's longest; a grid of 1024-thread blocks may not be
// resident at once), does the rest: the budgets, the take, the T4
// gathers (each valid row written at its compacted place by the scan that
// ranks it), the fresh rows that stay in the queue (at c0 - n_pop on), the
// pop into the messages with T1 (rows past n_pop: 0, invalid; T1 of a zero
// row is (0, 0, 0)), the remainders after them, dyn_pops and the counts.
// The two parts write disjoint slots.  The staging (Leg0Stage: f_pop and
// eff rows) is dynamic shared memory, or the tile's part of the wrapper's
// device-memory scratch where it does not fit.
// ---------------------------------------------------------------------------
__host__ __device__ inline size_t pad16(size_t b) { return (b + 15) / 16 * 16; }

struct Leg0Stage {
  int32_t* idx;    // f_pop popped vertex slots
  int32_t* rows;   // f_pop rows of 3: the compacted source rows
  int32_t* taken;  // eff popped tasks of 3, then their remainders
  uint8_t* valid;  // eff flags of the remainders
};

// kernels/engine/fused.py leg0_stage_bytes
__host__ __device__ inline size_t leg0_stage_bytes(int f_pop, int eff) {
  return pad16(4 * (size_t)f_pop) + pad16(12 * (size_t)f_pop) +
         pad16(12 * (size_t)eff) + pad16(eff);
}

__device__ inline Leg0Stage leg0_stage(unsigned char* base, int f_pop,
                                       int eff) {
  Leg0Stage s;
  s.idx = reinterpret_cast<int32_t*>(base);
  base += pad16(4 * (size_t)f_pop);
  s.rows = reinterpret_cast<int32_t*>(base);
  base += pad16(12 * (size_t)f_pop);
  s.taken = reinterpret_cast<int32_t*>(base);
  base += pad16(12 * (size_t)eff);
  s.valid = base;
  return s;
}

// A block's staging: dynamic shared memory, or its tile's `bytes` of the
// wrapper's device-memory scratch (scratch != nullptr) where the staging
// does not fit in shared memory.  Both are read through generic pointers,
// so one body serves both, and block barriers order them alike.
__device__ __forceinline__ unsigned char* stage_of(unsigned char* smem,
                                                   unsigned char* scratch,
                                                   size_t bytes, int tile) {
  return scratch != nullptr ? scratch + (size_t)tile * bytes : smem;
}

// The TSU of tile t (core/engine.py _budgets): each channel's pop into
// pops[0 .. K-1]; returns the frontier budget.  Every thread that calls it
// gets the same numbers.
template <int POLICY, int K>
__device__ inline int tsu_budgets(int t, int occ, const Downstream& down,
                                  const int32_t* __restrict__ pressure,
                                  int cap_r, int f_pop, int r_pop, int plimit,
                                  int* pops) {
  const long long free0 = (long long)cap_r - occ;
  long long fp;
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
    const bool half0 = occ > cap_r / 2;
    fp = free0 - 2LL * f_pop;
    if (fp < 0 || half0 || hot || below) fp = 0;
  }
  if (fp > f_pop) fp = f_pop;
  return static_cast<int>(fp);
}

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
                  int32_t* __restrict__ npush_out, unsigned char* scratch,
                  size_t stage_bytes, int v_chunk, int e_chunk, int cap_r,
                  int f_pop, int r_pop, int max_t2, int plimit, int shard_T,
                  int tile0) {
  extern __shared__ __align__(16) unsigned char leg0_smem[];
  __shared__ int sm[33];
  const int t = blockIdx.x, g = blockIdx.y - 1, G = gridDim.y - 1;
  const int tid = threadIdx.x;
  const int c0 = rq_count[t];
  int pops[K];
  const int fp = tsu_budgets<POLICY, K>(t, c0, down, pressure, cap_r, f_pop,
                                        r_pop, plimit, pops);
  const int32_t* rqt = rq + (size_t)t * cap_r * 3;
  int32_t* rqo = rq_out + (size_t)t * cap_r * 3;
  if (g >= 0) {
    // this block's share of the old live rows [n_pop, c0), n_pop = pops[0]
    const int L = imax(c0 - pops[0], 0);
    repro::fifo_live_turn<3>(rqt, rqo, pops[0], (int)((long long)g * L / G),
                             (int)((long long)(g + 1) * L / G), tid,
                             blockDim.x);
    return;
  }
  const int eff = imin(r_pop, cap_r);
  const Leg0Stage sg =
      leg0_stage(stage_of(leg0_smem, scratch, stage_bytes, t), f_pop, eff);
  if (tid == 0)
    for (int i = 0; i < K; ++i) dyn_pops[K * t + i] = pops[i];
  const size_t vt = (size_t)t * v_chunk;
  // this row's shard row (the serving lanes' rows share one shard of
  // shard_T rows) and its tile id in the placed payload
  const int srow = t % shard_T;
  const int tile = tile0 + srow;
  const size_t st_row = (size_t)srow * v_chunk;
  const int n_take = repro::frontier_take_block(
      frontier + vt, frontier_out + vt, v_chunk, fp, f_pop, sg.idx, sm);
  __syncthreads();
  // T4: the popped vertices' tasks, each valid one (i < n_take, deg > 0)
  // written at its rank among them
  int nvalid = 0;  // block-uniform
  for (int base = 0; base < f_pop; base += blockDim.x) {
    const int i = base + tid;
    int st = 0, dg = 0;
    int32_t pay = 0;
    if (i < n_take) {
      const int vi = sg.idx[i];
      const size_t o = vt + vi;
      dg = deg[st_row + vi];
      st = ptr_start[st_row + vi];
      if (PAYLOAD == PAY_ONE) {
        pay = ONE_BITS;
      } else if (PAYLOAD == PAY_PLACED) {  // me * v_chunk + vidx
        pay = repro::wrap_add(repro::wrap_mul(tile, v_chunk), vi);
      } else {
        float x = value[o];
        if (PAYLOAD == PAY_VALUE_OVER_DEG)
          x = __fdiv_rn(x, __int2float_rn(imax(dg, 1)));
        pay = __float_as_int(x);
      }
    }
    const int v = i < n_take && dg > 0;
    int total;
    const int pos = nvalid + repro::block_excl_scan(v, &total, sm);
    if (v) {
      sg.rows[3 * pos] = st;
      sg.rows[3 * pos + 1] = repro::wrap_add(st, dg);
      sg.rows[3 * pos + 2] = pay;
    }
    nvalid += total;
  }
  __syncthreads();
  const int n_push0 = imin(nvalid, imax(cap_r - c0, 0));
  const int c2 = c0 + n_push0;
  const int n_pop = imin(pops[0], c2);
  const int c3 = c2 - n_pop;
  // the fresh rows that stay: row c0 + j of the appended queue is row
  // c0 + j - n_pop of the turned one
  for (int j = imax(n_pop - c0, 0) + tid; j < n_push0; j += blockDim.x) {
    int32_t* o = rqo + (size_t)(c0 + j - n_pop) * 3;
    o[0] = sg.rows[3 * j];
    o[1] = sg.rows[3 * j + 1];
    o[2] = sg.rows[3 * j + 2];
  }
  // the pop (old rows, then fresh ones) and T1; the remainders replace the
  // popped tasks
  for (int i = tid; i < eff; i += blockDim.x) {
    int ts = 0, te = 0, pay = 0;
    if (i < imin(n_pop, c0)) {
      ts = rqt[3 * i];
      te = rqt[3 * i + 1];
      pay = rqt[3 * i + 2];
    } else if (i < n_pop) {
      const int j = i - c0;
      ts = sg.rows[3 * j];
      te = sg.rows[3 * j + 1];
      pay = sg.rows[3 * j + 2];
    }
    const int stop = range_stop(ts, te, e_chunk, max_t2);
    const bool tv = i < n_pop;
    int32_t* m = msgs + ((size_t)t * eff + i) * 3;
    m[0] = ts;
    m[1] = stop;
    m[2] = pay;
    mvalid[(size_t)t * eff + i] = tv;
    sg.taken[3 * i] = stop;
    sg.taken[3 * i + 1] = te;
    sg.taken[3 * i + 2] = pay;
    sg.valid[i] = tv && stop < te;
  }
  __syncthreads();
  const int nrem = repro::queue_append_block(rqo, cap_r, 3, c3, sg.taken,
                                             sg.valid, eff, sm);
  if (tid == 0) {
    const int n_push1 = imin(nrem, imax(cap_r - c3, 0));
    rq_count_out[t] = c3 + n_push1;
    drops[t] = (nvalid - n_push0) + (nrem - n_push1);
    npop_out[t] = n_pop;
    npush_out[t] = nvalid + nrem;
  }
}

// ---------------------------------------------------------------------------
// Leg 1 (the scan leg), over a grid (T, G + 1).  Blocks (t, g < G) run T2 on
// the messages [g * R / G, (g + 1) * R / G) of tile t's R delivered range
// messages (rows of W = 3 or 4 words), one warp per message (SCAN_STAGED:
// the warp first stages its two windows in shared memory; SCAN_GLOBAL: a
// window too wide to stage is read from device memory, the words the
// staging would hold), each lane emitting a width-2 row into message row
// eff + r * max_t2 + j; then they move the rows [g * L / G, (g + 1) * L / G)
// of the live-row turn of the spill-only queue of channel `chan`
// (fifo_live_turn; its pop is n_pop = min(dyn_pops[nchan * t + chan],
// count), L = count - n_pop, no fresh rows).  Their edge counts add up in
// `tally` (T sums, then T tickets, cleared on the stream before the launch:
// the tile's last block to finish writes the sum; integers, exact in any
// order).  Block (t, G) appends the range spills onto the range queue rq
// in place, at its count (what the plain stage's copy-and-append gives; leg
// 0 of the round made that queue, and nothing else reads it), writes the
// popped rows [0, eff) of the spill-only queue into the messages (valid
// below n_pop; the rows past it, which may lie past the queue's count, are
// 0), and the tile's other counts.  The emit:
//   EMIT_PLUS1 .. EMIT_TIMES_W  (dst, f2i(emit(i2f(recv[2]), w)))
//   EMIT_ONE    (dst, bits of 1.0f)                    k-core's decrement
//   EMIT_WEDGE  (dst, recv[2]), valid iff dst > recv[2]  triangles' wedge
//   EMIT_CLOSE  (recv[2], dst), valid iff dst > recv[3]  triangles' close
// The edge count is the scanned lanes, before the wedge/close narrowing.
// ---------------------------------------------------------------------------
template <int EMIT, int SCAN, int W>
__global__ void __launch_bounds__(SPLIT_THREADS)
fused_leg1_kernel(int32_t* rq, const int32_t* __restrict__ rq_count,
                  const int32_t* __restrict__ sp,
                  const uint8_t* __restrict__ spv,
                  const int32_t* __restrict__ recv,
                  const uint8_t* __restrict__ rv,
                  const int32_t* __restrict__ edge_dst,
                  const float* __restrict__ edge_val,
                  const int32_t* __restrict__ uq,
                  const int32_t* __restrict__ uq_count,
                  const int32_t* __restrict__ dyn_pops,
                  int32_t* __restrict__ rq_count_out,
                  int32_t* __restrict__ uq_out,
                  int32_t* __restrict__ uq_count_out,
                  int32_t* __restrict__ msgs, uint8_t* __restrict__ mvalid,
                  int32_t* __restrict__ drops, int32_t* __restrict__ edges,
                  int32_t* __restrict__ npop_out,
                  int32_t* __restrict__ npush_out,
                  int32_t* __restrict__ nspill_out, int* tally, int cap_r,
                  int S, int R, int e_chunk, int max_t2, int window,
                  int cap_u, int u_pop, int scan_warps, int nchan, int chan,
                  int shard_T) {
  extern __shared__ __align__(16) unsigned char stage_smem[];
  __shared__ int sm[33];
  const int t = blockIdx.x, g = blockIdx.y, G = gridDim.y - 1;
  const int tid = threadIdx.x;
  const int eff = imin(u_pop, cap_u);
  const size_t n_msgs = eff + (size_t)R * max_t2;
  int32_t* mt = msgs + (size_t)t * n_msgs * 2;
  uint8_t* mvt = mvalid + (size_t)t * n_msgs;
  const int cu = uq_count[t];
  const int n_pop = imin(dyn_pops[nchan * t + chan], cu);
  const int32_t* uqt = uq + (size_t)t * cap_u * 2;
  if (g == G) {
    // the range-spill re-queue, in place; the replayed rows; the counts
    const int c0 = rq_count[t];
    const int nsp = repro::queue_append_block(
        rq + (size_t)t * cap_r * W, cap_r, W, c0, sp + (size_t)t * S * W,
        spv + (size_t)t * S, S, sm);
    for (int i = tid; i < eff; i += blockDim.x) {
      const bool v = i < n_pop;
      reinterpret_cast<int2*>(mt)[i] =
          v ? reinterpret_cast<const int2*>(uqt)[i] : make_int2(0, 0);
      mvt[i] = v;
    }
    if (tid == 0) {
      const int n_push = imin(nsp, imax(cap_r - c0, 0));
      rq_count_out[t] = c0 + n_push;
      uq_count_out[t] = cu - n_pop;
      drops[t] = nsp - n_push;
      npop_out[t] = n_pop;
      npush_out[t] = 0;
      nspill_out[t] = nsp;
    }
    return;
  }
  // T2 and emit on this block's messages, MU a warp in flight (one at a time
  // where the warp stages its windows)
  constexpr int MU = SCAN == SCAN_STAGED ? 1 : 4;
  const int r_lo = (int)((long long)g * R / G);
  const int r_hi = (int)((long long)(g + 1) * R / G);
  // row t scans shard row t % shard_T (the serving lanes share one shard)
  const int32_t* ed = edge_dst + (size_t)(t % shard_T) * e_chunk;
  const float* ev = edge_val + (size_t)(t % shard_T) * e_chunk;
  const int warp = tid >> 5, lane = tid & 31;
  int my_edges = 0;
  if (warp < scan_warps) {
    int32_t* sd = reinterpret_cast<int32_t*>(stage_smem) + warp * 4 * window;
    float* sv = reinterpret_cast<float*>(sd + 2 * window);
    for (int r0 = r_lo + warp; r0 < r_hi; r0 += MU * scan_warps) {
      int length[MU], local0[MU];
      int32_t p2[MU], p3[MU];
#pragma unroll
      for (int u = 0; u < MU; ++u) {
        const int r = r0 + u * scan_warps;
        length[u] = local0[u] = p2[u] = p3[u] = 0;
        if (r < r_hi) {
          const size_t q = (size_t)t * R + r;
          const int32_t* m = recv + q * W;
          repro::message_bounds(rv[q] != 0, m[0], m[1], e_chunk, &length[u],
                                &local0[u]);
          p2[u] = m[2];
          p3[u] = W > 3 ? m[3] : 0;
        }
      }
#pragma unroll
      for (int u = 0; u < MU; ++u) {
        const int r = r0 + u * scan_warps;
        if (r >= r_hi) break;  // warp-uniform
        int base = 0;
        if (SCAN == SCAN_STAGED) {
          base = repro::stage_windows(ed, ev, e_chunk, local0[u], window, sd,
                                      sv);
          __syncwarp();
        }
        const float parent = __int_as_float(p2[u]);
        for (int j = lane; j < max_t2; j += 32) {
          const repro::Lane l =
              SCAN == SCAN_GATHER
                  ? repro::gather_lane(ed, ev, e_chunk, length[u], local0[u],
                                       j)
              : SCAN == SCAN_STAGED
                  ? repro::stream_lane(sd, sv, window, length[u], local0[u],
                                       base, j)
                  : repro::stream_lane_global(ed, ev, e_chunk, window,
                                              length[u], local0[u], j);
          const size_t o = eff + (size_t)r * max_t2 + j;
          int32_t a = l.dst, b;
          bool ok = l.valid;
          if (EMIT == EMIT_ONE) {
            b = ONE_BITS;
          } else if (EMIT == EMIT_WEDGE) {
            b = p2[u];
            ok = ok && l.dst > p2[u];
          } else if (EMIT == EMIT_CLOSE) {
            a = p2[u];
            b = l.dst;
            ok = ok && l.dst > p3[u];
          } else {
            b = __float_as_int(emit<EMIT>(parent, l.w));
          }
          reinterpret_cast<int2*>(mt)[o] = make_int2(a, b);
          mvt[o] = ok;
          my_edges += l.valid;
        }
        if (SCAN == SCAN_STAGED) __syncwarp();
      }
    }
  }
  // this block's share of the spill-only queue's live rows
  const int L = cu - n_pop;
  repro::fifo_live_turn<2>(uqt, uq_out + (size_t)t * cap_u * 2, n_pop,
                           (int)((long long)g * L / G),
                           (int)((long long)(g + 1) * L / G), tid,
                           blockDim.x);
  const int part = repro::block_sum(my_edges, sm);
  if (tid == 0) {
    atomicAdd(&tally[t], part);
    __threadfence();
    if (atomicAdd(&tally[gridDim.x + t], 1) == G - 1)  // the tile's last
      edges[t] = atomicAdd(&tally[t], 0);
  }
}

// ---------------------------------------------------------------------------
// Leg 2 (the fold leg), over a grid (T, G + 1): block (t, g < G) owns the
// columns [lo, hi) = [g * step, min((g + 1) * step, v_chunk)) of tile t's
// slice.  It copies that range of `target` to `out`, then folds the tile's
// R delivered (vertex, value) rows whose slot lies in it: min (integer atomics
// in the order of the floats, a NaN as the ticket of its place:
// ordered_scatter.cuh min_fold_beside, exact in any order) and the re-arm
// flags | (out < target); the ordered add (ordered_scatter.cuh, over the
// in-range rows only, in row-order chunks of FOLD_ADD_MAX_ROWS rows); or
// k-core's threshold fold: the ordered add of -value, then newly = (acc == 0)
// & (out < k), acc_out = newly ? 1 : acc and flags | newly.  Invalid rows go
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
    repro::min_fold_beside(out + vt, target + vt, lo, hi, R, fold_smem,
                           load);
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
    repro::add_fold_beside(out + vt, lo, hi, step, R, fold_smem, load, copy);
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
// Triangles leg 2 (the wedge leg), over a grid (T, G + 2).  wedge_to_range of
// the R delivered wedges (u, v) gives the rows (start, start + deg, v, u) of
// u's adjacency, valid iff the wedge is valid and deg > 0; the first `room`
// of them in row order append onto the width-4 range2 queue (the others
// drop), the queue pops n_pop = min(dyn_pops[nchan * t + chan], count') rows,
// range_split turns the popped tasks into the messages, and their
// remainders append after the queue's live rows.  Every block but (t, G)
// first counts the tile's valid rows, all R of them (from L2 after the
// first block): that fixes the append, the pop and every row's place.
// Blocks (t, g < G) then rank the valid rows among their recv rows [g * R /
// G, (g + 1) * R / G) in row order (a block scan, from the count of valid
// rows before theirs, taken in the same pass), place those that stay in the
// queue, and move their share of the queue's old live rows
// (fifo_live_turn): the turned queue gets its live rows only.  Block (t, G)
// appends the wedge spills onto the wedge queue wq in place, at its count
// (leg 1 of the round made that queue, and nothing else reads it).  Block
// (t, G + 1) gathers the popped rows (old rows, then the first fresh ones)
// into its staging (WedgeStage: dynamic shared memory, or the tile's part of
// the wrapper's device-memory scratch), writes the messages (rows past n_pop:
// 0, invalid), appends the remainders after the moved rows, and writes the
// tile's counts.  Work is 0 (the wedge channel counts none).
// ---------------------------------------------------------------------------
struct WedgeStage {
  int32_t* taken;  // eff popped tasks of 4, then their remainders
  uint8_t* remv;   // eff remainder flags
};

// kernels/engine/fused.py wedge_stage_bytes
__host__ __device__ inline size_t wedge_stage_bytes(int eff) {
  return pad16(16 * (size_t)eff) + pad16(eff);
}

constexpr int WEDGE_UNROLL = 4;  // rows a thread reads at once when counting

__global__ void __launch_bounds__(SPLIT_THREADS)
fused_wedge_leg_kernel(int32_t* wq, const int32_t* __restrict__ wq_count,
                       const int32_t* __restrict__ sp,
                       const uint8_t* __restrict__ spv,
                       const int32_t* __restrict__ recv,
                       const uint8_t* __restrict__ rv,
                       const int32_t* __restrict__ ptr_start,
                       const int32_t* __restrict__ deg,
                       const int32_t* __restrict__ rq,
                       const int32_t* __restrict__ rq_count,
                       const int32_t* __restrict__ dyn_pops,
                       int32_t* __restrict__ wq_count_out,
                       int32_t* __restrict__ rq_out,
                       int32_t* __restrict__ rq_count_out,
                       int32_t* __restrict__ msgs,
                       uint8_t* __restrict__ mvalid,
                       int32_t* __restrict__ drops,
                       int32_t* __restrict__ work,
                       int32_t* __restrict__ npop_out,
                       int32_t* __restrict__ npush_out,
                       int32_t* __restrict__ nspill_out,
                       unsigned char* scratch, size_t stage_bytes, int cap_w,
                       int S, int R, int v_chunk, int cap_r, int r_pop,
                       int max_t2, int e_chunk, int nchan, int chan) {
  extern __shared__ __align__(16) unsigned char wedge_smem[];
  __shared__ int sm[33];
  const int t = blockIdx.x, g = blockIdx.y, G = gridDim.y - 2;
  const int tid = threadIdx.x;
  const int cw = wq_count[t];
  if (g == G) {
    // the wedge-spill re-queue, in place
    const int nsp = repro::queue_append_block(
        wq + (size_t)t * cap_w * 2, cap_w, 2, cw, sp + (size_t)t * S * 2,
        spv + (size_t)t * S, S, sm);
    if (tid == 0) {
      wq_count_out[t] = cw + imin(nsp, imax(cap_w - cw, 0));
      nspill_out[t] = nsp;
    }
    return;
  }
  const int32_t* rc = recv + (size_t)t * R * 2;
  const uint8_t* rvt = rv + (size_t)t * R;
  const size_t vt = (size_t)t * v_chunk;
  // row r's task (start, start + deg, v, u); valid iff dg > 0
  const auto task = [&](int r, int* st, int* dg, int* u, int* v) {
    *st = *dg = *u = *v = 0;
    if (rvt[r]) {
      *u = rc[2 * r];
      *v = rc[2 * r + 1];
      const size_t o = vt + repro::floor_mod(*u, v_chunk);
      *st = ptr_start[o];
      *dg = deg[o];
    }
  };
  const int r_lo = g < G ? (int)((long long)g * R / G) : 0;
  const int r_hi = g < G ? (int)((long long)(g + 1) * R / G) : 0;
  // the tile's valid rows, and those before r_lo
  int mine = 0, before = 0;
  for (int r0 = tid; r0 < R; r0 += WEDGE_UNROLL * (int)blockDim.x) {
    int dg[WEDGE_UNROLL];
#pragma unroll
    for (int k = 0; k < WEDGE_UNROLL; ++k) {
      const int r = r0 + k * (int)blockDim.x;
      dg[k] = 0;
      if (r < R && rvt[r])
        dg[k] = deg[vt + repro::floor_mod(rc[2 * r], v_chunk)];
    }
#pragma unroll
    for (int k = 0; k < WEDGE_UNROLL; ++k) {
      mine += dg[k] > 0;
      before += dg[k] > 0 && r0 + k * (int)blockDim.x < r_lo;
    }
  }
  const int nvalid = repro::block_sum(mine, sm);
  const int n_before = repro::block_sum(before, sm);
  const int c0 = rq_count[t];
  const int n_push0 = imin(nvalid, imax(cap_r - c0, 0));
  const int c2 = c0 + n_push0;
  const int n_pop = imin(dyn_pops[nchan * t + chan], c2);
  const int c3 = c2 - n_pop;
  const int32_t* rqt = rq + (size_t)t * cap_r * 4;
  int32_t* rqo = rq_out + (size_t)t * cap_r * 4;
  if (g < G) {
    // the fresh rows of [r_lo, r_hi) that stay in the queue: row c0 + k of
    // the appended queue is row c0 + k - n_pop of the turned one
    int rank = n_before;  // block-uniform
    for (int base = r_lo; base < r_hi; base += blockDim.x) {
      const int r = base + tid;
      int st = 0, dg = 0, u = 0, v = 0;
      if (r < r_hi) task(r, &st, &dg, &u, &v);
      const int ok = dg > 0;
      int total;
      const int k = rank + repro::block_excl_scan(ok, &total, sm);
      if (ok && k < n_push0 && c0 + k >= n_pop)
        reinterpret_cast<int4*>(rqo)[c0 + k - n_pop] =
            make_int4(st, repro::wrap_add(st, dg), v, u);
      rank += total;
    }
    // this block's share of the old live rows [n_pop, c0)
    const int L = imax(c0 - n_pop, 0);
    repro::fifo_live_turn<4>(rqt, rqo, n_pop, (int)((long long)g * L / G),
                             (int)((long long)(g + 1) * L / G), tid,
                             blockDim.x);
    return;
  }
  // block (t, G + 1): the pop
  const int eff = imin(r_pop, cap_r);
  unsigned char* base = stage_of(wedge_smem, scratch, stage_bytes, t);
  const WedgeStage sg{reinterpret_cast<int32_t*>(base),
                      base + pad16(16 * (size_t)eff)};
  const int p_old = imin(n_pop, c0);
  for (int i = tid; i < p_old; i += blockDim.x)
    reinterpret_cast<int4*>(sg.taken)[i] =
        reinterpret_cast<const int4*>(rqt)[i];
  const int need = n_pop - p_old;  // fresh rows popped: the first `need`
  int rank = 0;                    // block-uniform
  for (int b0 = 0; b0 < R && rank < need; b0 += blockDim.x) {
    const int r = b0 + tid;
    int st = 0, dg = 0, u = 0, v = 0;
    if (r < R) task(r, &st, &dg, &u, &v);
    const int ok = dg > 0;
    int total;
    const int k = rank + repro::block_excl_scan(ok, &total, sm);
    if (ok && k < need)
      reinterpret_cast<int4*>(sg.taken)[p_old + k] =
          make_int4(st, repro::wrap_add(st, dg), v, u);
    rank += total;
  }
  __syncthreads();
  // T1 on the popped tasks; the remainders replace them
  for (int i = tid; i < eff; i += blockDim.x) {
    int4* m = reinterpret_cast<int4*>(msgs) + (size_t)t * eff + i;
    int32_t* tk = sg.taken + 4 * i;
    const bool tv = i < n_pop;
    bool rem = false;
    if (tv) {
      const int ts = tk[0], te = tk[1];
      const int stop = range_stop(ts, te, e_chunk, max_t2);
      *m = make_int4(ts, stop, tk[2], tk[3]);
      tk[0] = stop;
      tk[1] = te;
      rem = stop < te;
    } else {
      *m = make_int4(0, 0, 0, 0);
    }
    mvalid[(size_t)t * eff + i] = tv;
    sg.remv[i] = rem;
  }
  __syncthreads();
  const int nrem =
      repro::queue_append_block(rqo, cap_r, 4, c3, sg.taken, sg.remv, eff, sm);
  // the wedge spills' count, for the drops (block (t, G) appends them)
  int my_sp = 0;
  for (int i = tid; i < S; i += blockDim.x) my_sp += spv[(size_t)t * S + i];
  const int nsp = repro::block_sum(my_sp, sm);
  if (tid == 0) {
    const int n_wpush = imin(nsp, imax(cap_w - cw, 0));
    const int n_push1 = imin(nrem, imax(cap_r - c3, 0));
    rq_count_out[t] = c3 + n_push1;
    drops[t] = (nsp - n_wpush) + (nvalid - n_push0) + (nrem - n_push1);
    work[t] = 0;
    npop_out[t] = n_pop;
    npush_out[t] = nvalid + nrem;
  }
}

// ---------------------------------------------------------------------------
// Triangles leg 4 (the close leg), over a grid (T, G + 1).  Block (t, G)
// appends the close spills onto the close queue cq in place, at its count
// (what the plain stage's copy-and-append gives; leg 3 of the round made that
// queue, and nothing else reads it), and writes the tile's queue count,
// drops and spill count.  Blocks (t, g < G) take the rows [g * R / G, (g + 1)
// * R / G) of tile t's R delivered (v, w) rows: found = the closing edge (v,
// w) is in v's sorted local segment, by program.py _segment_contains's
// bounded binary search of `steps` = max(1, bit_length(e_chunk)) steps,
// every probe clamped to the shard (once left >= right no step changes
// anything, so a search stops there), CLOSE_ROWS rows of a thread searched
// side by side so that their dependent shard reads overlap; then each valid
// row adds (1 << 32) + found to its slot's count, a 64-bit integer atomic
// (the valid rows in the high word, the hits in the low one: exact in any
// order).  Their found counts add up in `tally` (T sums, then T tickets; the
// slot counts and `tally` are cleared on the stream before the launch).  The
// tile's last block to finish folds the counts into acc: out = acc, + 0.0f
// once where a valid row touched the slot, then + 1.0f once a hit, each a
// __fadd_rn.  That is the plain stage's ordered add of found (0.0f or 1.0f)
// bit for bit: f(x) = x + 1 and z(x) = x + 0 commute under round-to-nearest
// (x + 1 is never -0, and z changes -0 only), and z(z(x)) = z(x); so no sort
// and no float atomic (atom / red .add.f32 flushes subnormals).  acc stays
// a fresh output, copied slot by slot in that pass.
// ---------------------------------------------------------------------------
constexpr int CLOSE_ROWS = 4;        // searches a thread keeps in flight
constexpr float TWO24 = 16777216.0f;  // above it x + 1 no longer counts

// x + 1.0f, h times, each rounded to nearest.  An integer in [-2^24, 2^24]
// counts exactly up to 2^24 and stays there (2^24 + 1 rounds to 2^24);
// other values step until they reach such an integer or a fixed point
// (inf, NaN, a float too large for + 1 to change).
__device__ inline float add_ones(float x, unsigned h) {
  for (; h > 0; --h) {
    if (fabsf(x) <= TWO24 && x == truncf(x)) {
      const long long r = (long long)x + h;
      return (float)(r < (long long)TWO24 ? r : (long long)TWO24);
    }
    const float y = __fadd_rn(x, 1.0f);
    if (__float_as_int(y) == __float_as_int(x)) return x;
    x = y;
  }
  return x;
}

__global__ void __launch_bounds__(SPLIT_THREADS)
fused_close_leg_kernel(int32_t* cq, const int32_t* __restrict__ cq_count,
                       const int32_t* __restrict__ sp,
                       const uint8_t* __restrict__ spv,
                       const int32_t* __restrict__ recv,
                       const uint8_t* __restrict__ rv,
                       const int32_t* __restrict__ ptr_start,
                       const int32_t* __restrict__ deg,
                       const int32_t* __restrict__ edge_dst,
                       const float* __restrict__ acc,
                       int32_t* __restrict__ cq_count_out,
                       float* __restrict__ acc_out,
                       int32_t* __restrict__ drops,
                       int32_t* __restrict__ found_out,
                       int32_t* __restrict__ nspill_out,
                       unsigned long long* slots, int* tally, int cap_c,
                       int S, int R, int v_chunk, int e_chunk, int steps) {
  __shared__ int sm[33];
  __shared__ int s_last;
  const int t = blockIdx.x, g = blockIdx.y, G = gridDim.y - 1;
  const int tid = threadIdx.x;
  if (g == G) {
    // the close-spill re-queue, in place, and the counts
    const int c0 = cq_count[t];
    const int nsp = repro::queue_append_block(
        cq + (size_t)t * cap_c * 2, cap_c, 2, c0, sp + (size_t)t * S * 2,
        spv + (size_t)t * S, S, sm);
    if (tid == 0) {
      const int n_push = imin(nsp, imax(cap_c - c0, 0));
      cq_count_out[t] = c0 + n_push;
      drops[t] = nsp - n_push;
      nspill_out[t] = nsp;
    }
    return;
  }
  const int32_t* rc = recv + (size_t)t * R * 2;
  const uint8_t* rvt = rv + (size_t)t * R;
  const int32_t* ed = edge_dst + (size_t)t * e_chunk;
  const size_t vt = (size_t)t * v_chunk;
  unsigned long long* st = slots + vt;
  const int r_lo = (int)((long long)g * R / G);
  const int r_hi = (int)((long long)(g + 1) * R / G);
  const int step = CLOSE_ROWS * (int)blockDim.x;
  const auto probe = [&](int i) {
    return ed[imin(imax(i, 0), e_chunk - 1)];
  };
  int my_found = 0;
  for (int r0 = r_lo + tid; r0 < r_hi; r0 += step) {
    int left[CLOSE_ROWS], right[CLOSE_ROWS], end[CLOSE_ROWS];
    int target[CLOSE_ROWS], slot[CLOSE_ROWS];
#pragma unroll
    for (int u = 0; u < CLOSE_ROWS; ++u) {
      const int r = r0 + u * (int)blockDim.x;
      left[u] = right[u] = end[u] = target[u] = 0;
      slot[u] = -1;  // invalid: counts nowhere
      if (r < r_hi && rvt[r]) {
        slot[u] = repro::floor_mod(rc[2 * r], v_chunk);
        target[u] = rc[2 * r + 1];
        left[u] = repro::floor_mod(ptr_start[vt + slot[u]], e_chunk);
        right[u] = end[u] = repro::wrap_add(left[u], deg[vt + slot[u]]);
      }
    }
    for (int s = 0; s < steps; ++s) {
      bool busy = false;
#pragma unroll
      for (int u = 0; u < CLOSE_ROWS; ++u) {
        if (left[u] < right[u]) {
          const int mid = repro::floor_div(repro::wrap_add(left[u], right[u]),
                                           2);
          if (probe(mid) < target[u])
            left[u] = repro::wrap_add(mid, 1);
          else
            right[u] = mid;
          busy = true;
        }
      }
      if (!busy) break;
    }
#pragma unroll
    for (int u = 0; u < CLOSE_ROWS; ++u) {
      if (slot[u] < 0) continue;
      const bool found = left[u] < end[u] && probe(left[u]) == target[u];
      my_found += found;
      atomicAdd(st + slot[u], (1ULL << 32) + (found ? 1ULL : 0ULL));
    }
  }
  __threadfence();  // this thread's slot counts, before the tile's ticket
  const int part = repro::block_sum(my_found, sm);
  if (tid == 0) {
    atomicAdd(&tally[t], part);
    __threadfence();
    s_last = atomicAdd(&tally[gridDim.x + t], 1) == G - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the tile's last block: every block's counts are in; fold them into acc
  __threadfence();
  if (tid == 0) found_out[t] = atomicAdd(&tally[t], 0);
  for (int i = tid; i < v_chunk; i += blockDim.x) {
    const unsigned long long c = __ldcg(st + i);
    float x = acc[vt + i];
    if (c != 0) x = add_ones(__fadd_rn(x, 0.0f), (unsigned)(c & 0xffffffffu));
    acc_out[vt + i] = x;
  }
}

// Dynamic shared memory beside the kernels' static arrays (a few hundred
// bytes): above 48 KiB in all it needs the opt-in, a host call, so a launch
// that takes more than SMEM_NO_OPT_IN sets it and the others skip the call.
constexpr size_t SMEM_NO_OPT_IN = 40 * 1024;

template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= SMEM_NO_OPT_IN) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// A staging of `need` bytes a tile, `bytes` of it (at least `need`): in
// dynamic shared memory up to STAGE_SMEM_MAX bytes, past it in the
// wrapper's device-memory scratch of `bytes` a tile.  Sets *smem and *stage
// to what the launch takes; false where the request does not cover the
// need.
bool staging(size_t need, size_t bytes, void* scratch, size_t* smem,
             unsigned char** stage) {
  if (bytes < need || bytes % 16 != 0) return false;
  if (bytes > repro::STAGE_SMEM_MAX) {
    *smem = 0;
    *stage = static_cast<unsigned char*>(scratch);
    return scratch != nullptr;
  }
  *smem = bytes;
  *stage = nullptr;
  return true;
}

// Every instantiation of a leg kernel has the same signature.
using Leg0Kernel = decltype(&fused_leg0_kernel<PAY_VALUE, POLICY_TRAFFIC, 2>);

cudaError_t launch_leg0(Leg0Kernel kernel, int T, int G, cudaStream_t stream,
                        const void* frontier, const void* value,
                        const void* deg, const void* ptr_start, const void* rq,
                        const void* rq_count, const Downstream& down,
                        const void* pressure, void* frontier_out, void* rq_out,
                        void* rq_count_out, void* msgs, void* mvalid,
                        void* drops, void* dyn_pops, void* npop, void* npush,
                        void* scratch, int v_chunk, int e_chunk, int cap_r,
                        int f_pop, int r_pop, int max_t2, int plimit,
                        long long stage_bytes, int shard_T, int tile0) {
  size_t smem;
  unsigned char* stage;
  const int eff = r_pop < cap_r ? r_pop : cap_r;
  if (G < 1 || f_pop < 0 || r_pop < 0 || shard_T < 1 || T % shard_T ||
      tile0 < 0 ||
      !staging(leg0_stage_bytes(f_pop, eff), (size_t)stage_bytes, scratch,
               &smem, &stage))
    return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(T, G + 1), LEG_THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(frontier), static_cast<const float*>(value),
      static_cast<const int32_t*>(deg), static_cast<const int32_t*>(ptr_start),
      static_cast<const int32_t*>(rq), static_cast<const int32_t*>(rq_count),
      down, static_cast<const int32_t*>(pressure),
      static_cast<uint8_t*>(frontier_out), static_cast<int32_t*>(rq_out),
      static_cast<int32_t*>(rq_count_out), static_cast<int32_t*>(msgs),
      static_cast<uint8_t*>(mvalid), static_cast<int32_t*>(drops),
      static_cast<int32_t*>(dyn_pops), static_cast<int32_t*>(npop),
      static_cast<int32_t*>(npush), stage, (size_t)stage_bytes, v_chunk,
      e_chunk, cap_r, f_pop, r_pop, max_t2, plimit, shard_T, tile0);
  return cudaGetLastError();
}

using Leg1Kernel = decltype(&fused_leg1_kernel<EMIT_PLUS1, SCAN_GATHER, 3>);

cudaError_t launch_leg1(Leg1Kernel kernel, int T, int G, size_t smem,
                        cudaStream_t stream, void* rq, const void* rq_count,
                        const void* sp, const void* spv, const void* recv,
                        const void* rv, const void* edge_dst,
                        const void* edge_val, const void* uq,
                        const void* uq_count, const void* dyn_pops,
                        void* rq_count_out, void* uq_out, void* uq_count_out,
                        void* msgs, void* mvalid, void* drops, void* edges,
                        void* npop, void* npush, void* nspill, void* tally,
                        int cap_r, int S, int R, int e_chunk, int max_t2,
                        int window, int cap_u, int u_pop, int warps, int nchan,
                        int chan, int shard_T) {
  if (G < 1 || warps < 1 || shard_T < 1 || T % shard_T)
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(tally, 0, 2 * (size_t)T * sizeof(int), stream);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(T, G + 1), SPLIT_THREADS, smem, stream>>>(
      static_cast<int32_t*>(rq), static_cast<const int32_t*>(rq_count),
      static_cast<const int32_t*>(sp), static_cast<const uint8_t*>(spv),
      static_cast<const int32_t*>(recv), static_cast<const uint8_t*>(rv),
      static_cast<const int32_t*>(edge_dst),
      static_cast<const float*>(edge_val), static_cast<const int32_t*>(uq),
      static_cast<const int32_t*>(uq_count),
      static_cast<const int32_t*>(dyn_pops),
      static_cast<int32_t*>(rq_count_out), static_cast<int32_t*>(uq_out),
      static_cast<int32_t*>(uq_count_out), static_cast<int32_t*>(msgs),
      static_cast<uint8_t*>(mvalid), static_cast<int32_t*>(drops),
      static_cast<int32_t*>(edges), static_cast<int32_t*>(npop),
      static_cast<int32_t*>(npush), static_cast<int32_t*>(nspill),
      static_cast<int*>(tally), cap_r, S, R, e_chunk, max_t2, window, cap_u,
      u_pop, warps, nchan, chan, shard_T);
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

// The scan leg's shard reads: resident (window 0), or streamed windows
// staged by `warps` warps of a block (16 * window bytes each, STAGE_SMEM in
// all) up to STREAM_MAX_WINDOW, or read from device memory by every warp.
// Returns the mode, the warps that scan and the dynamic shared memory.
int scan_mode(int window, int* warps, size_t* smem) {
  static_assert(16 * repro::STREAM_MAX_WINDOW <= STAGE_SMEM,
                "a staged window fits the staging");
  *warps = SPLIT_THREADS / 32;
  *smem = 0;
  if (window == 0) return SCAN_GATHER;
  if (window > repro::STREAM_MAX_WINDOW) return SCAN_GLOBAL;
  const int fit = STAGE_SMEM / (16 * window);
  if (fit < *warps) *warps = fit;
  *smem = (size_t)*warps * 16 * window;
  return SCAN_STAGED;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Leg 0 of the 2-channel programs (classic, k-core); the staging in dynamic
// shared memory or, past STAGE_SMEM_MAX, in `scratch` (stage_bytes a tile).
int repro_fused_leg0(const void* frontier, const void* value, const void* deg,
                     const void* ptr_start, const void* rq,
                     const void* rq_count, const void* uq_count,
                     const void* pressure, void* frontier_out, void* rq_out,
                     void* rq_count_out, void* msgs, void* mvalid, void* drops,
                     void* dyn_pops, void* npop, void* npush, void* scratch,
                     int T, int shard_T, int tile0, int v_chunk, int e_chunk,
                     int cap_r, int cap_u, int f_pop, int r_pop, int u_pop,
                     int max_t2, int plimit, int payload, int policy, int G,
                     long long stage_bytes, void* stream) {
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
      kernel, T, G, static_cast<cudaStream_t>(stream), frontier, value, deg,
      ptr_start, rq, rq_count, down, pressure, frontier_out, rq_out,
      rq_count_out, msgs, mvalid, drops, dyn_pops, npop, npush, scratch,
      v_chunk, e_chunk, cap_r, f_pop, r_pop, max_t2, plimit, stage_bytes,
      shard_T, tile0));
}

// Leg 0 of the 4-channel triangles chain (placed-id payload).
int repro_fused_leg0_chain(
    const void* frontier, const void* value, const void* deg,
    const void* ptr_start, const void* rq, const void* rq_count,
    const void* count1, const void* count2, const void* count3,
    const void* pressure, void* frontier_out, void* rq_out,
    void* rq_count_out, void* msgs, void* mvalid, void* drops, void* dyn_pops,
    void* npop, void* npush, void* scratch, int T, int shard_T, int tile0,
    int v_chunk, int e_chunk, int cap_r, int cap1, int cap2, int cap3,
    int f_pop, int r_pop, int pop1, int pop2, int pop3, int max_t2, int plimit,
    int payload, int policy, int G, long long stage_bytes, void* stream) {
  if (payload != PAY_PLACED) return static_cast<int>(cudaErrorInvalidValue);
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
      kernel, T, G, static_cast<cudaStream_t>(stream), frontier, value, deg,
      ptr_start, rq, rq_count, down, pressure, frontier_out, rq_out,
      rq_count_out, msgs, mvalid, drops, dyn_pops, npop, npush, scratch,
      v_chunk, e_chunk, cap_r, f_pop, r_pop, max_t2, plimit, stage_bytes,
      shard_T, tile0));
}

// Leg 1 of the 2-channel programs: resident or streamed (window > 0; its
// windows staged or not), over a grid (T, G + 1); the range spills append
// to rq in place.  `tally` (2 T ints) is cleared on the stream first.
int repro_fused_leg1(void* rq, const void* rq_count, const void* sp,
                     const void* spv, const void* recv, const void* rv,
                     const void* edge_dst, const void* edge_val,
                     const void* uq, const void* uq_count,
                     const void* dyn_pops, void* rq_count_out, void* uq_out,
                     void* uq_count_out, void* msgs, void* mvalid, void* drops,
                     void* edges, void* npop, void* npush, void* nspill,
                     void* tally, int T, int shard_T, int cap_r, int S, int R,
                     int e_chunk, int max_t2, int window, int cap_u, int u_pop,
                     int emit_code, int G, void* stream) {
  int warps;
  size_t smem;
  const int mode = scan_mode(window, &warps, &smem);
  if (window < 0 || warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  Leg1Kernel kernel = nullptr;
  switch (3 * emit_code + mode) {
#define LEG1_CASES(E)                                              \
  case 3 * E + SCAN_GATHER:                                        \
    kernel = fused_leg1_kernel<E, SCAN_GATHER, 3>;                 \
    break;                                                         \
  case 3 * E + SCAN_STAGED:                                        \
    kernel = fused_leg1_kernel<E, SCAN_STAGED, 3>;                 \
    break;                                                         \
  case 3 * E + SCAN_GLOBAL:                                        \
    kernel = fused_leg1_kernel<E, SCAN_GLOBAL, 3>;                 \
    break;
    LEG1_CASES(EMIT_PLUS1)
    LEG1_CASES(EMIT_PLUS_W)
    LEG1_CASES(EMIT_COPY)
    LEG1_CASES(EMIT_TIMES_W)
    LEG1_CASES(EMIT_ONE)
#undef LEG1_CASES
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_leg1(
      kernel, T, G, smem, static_cast<cudaStream_t>(stream), rq, rq_count,
      sp, spv, recv, rv, edge_dst, edge_val, uq, uq_count, dyn_pops,
      rq_count_out, uq_out, uq_count_out, msgs, mvalid, drops, edges, npop,
      npush, nspill, tally, cap_r, S, R, e_chunk, max_t2, window, cap_u,
      u_pop, warps, 2, 1, shard_T));
}

// Legs 1 and 3 of the triangles chain (resident shard): the range channel
// chan - 1 of width 3 (wedge emit) or 4 (close emit), the spill-only
// channel chan.
int repro_fused_leg1_chain(
    void* rq, const void* rq_count, const void* sp, const void* spv,
    const void* recv, const void* rv, const void* edge_dst,
    const void* edge_val, const void* uq, const void* uq_count,
    const void* dyn_pops, void* rq_count_out, void* uq_out,
    void* uq_count_out, void* msgs, void* mvalid, void* drops, void* edges,
    void* npop, void* npush, void* nspill, void* tally, int T, int shard_T,
    int cap_r, int S, int R, int e_chunk, int max_t2, int cap_u, int u_pop,
    int nchan, int chan, int emit_code, int G, void* stream) {
  Leg1Kernel kernel = nullptr;
  if (emit_code == EMIT_WEDGE)
    kernel = fused_leg1_kernel<EMIT_WEDGE, SCAN_GATHER, 3>;
  else if (emit_code == EMIT_CLOSE)
    kernel = fused_leg1_kernel<EMIT_CLOSE, SCAN_GATHER, 4>;
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_leg1(
      kernel, T, G, 0, static_cast<cudaStream_t>(stream), rq, rq_count, sp,
      spv, recv, rv, edge_dst, edge_val, uq, uq_count, dyn_pops,
      rq_count_out, uq_out, uq_count_out, msgs, mvalid, drops, edges, npop,
      npush, nspill, tally, cap_r, S, R, e_chunk, max_t2, 0, cap_u, u_pop,
      SPLIT_THREADS / 32, nchan, chan, shard_T));
}

// Leg 2 of the classic program: the min (of at most MIN_FOLD_MAX_ROWS
// rows) or the add fold (in chunks of FOLD_ADD_MAX_ROWS rows), over a grid
// (T, G) of column ranges of `step` slots; the spills append to uq in
// place.
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
  } else if (fold != FOLD_MIN || R > repro::MIN_FOLD_MAX_ROWS) {
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
      fused_leg2_kernel<FOLD_KCORE>, T, G,
      repro::ordered_add_smem(R, step),
      static_cast<cudaStream_t>(stream), uq, uq_count, sp, spv, recv, rv,
      value, flags, acc, uq_count_out, value_out, flags_out, acc_out, drops,
      applied, nspill, cap_u, S, R, v_chunk, step, k));
}

// Leg 2 of triangles, over a grid (T, G + 2): the wedge spills append to wq
// in place; wedge_to_range, the range2 turn (live rows) and split; the
// popped rows staged in dynamic shared memory or in `scratch`.
int repro_fused_wedge_leg(
    void* wq, const void* wq_count, const void* sp, const void* spv,
    const void* recv, const void* rv, const void* ptr_start, const void* deg,
    const void* rq, const void* rq_count, const void* dyn_pops,
    void* wq_count_out, void* rq_out, void* rq_count_out, void* msgs,
    void* mvalid, void* drops, void* work, void* npop, void* npush,
    void* nspill, void* scratch, int T, int cap_w, int S, int R, int v_chunk,
    int e_chunk, int cap_r, int r_pop, int max_t2, int nchan, int chan,
    int G, long long stage_bytes, void* stream) {
  size_t smem;
  unsigned char* stage;
  const int eff = r_pop < cap_r ? r_pop : cap_r;
  if (G < 1 || r_pop < 0 ||
      !staging(wedge_stage_bytes(eff), (size_t)stage_bytes, scratch, &smem,
               &stage))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem(fused_wedge_leg_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_wedge_leg_kernel<<<dim3(T, G + 2), SPLIT_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(wq), static_cast<const int32_t*>(wq_count),
      static_cast<const int32_t*>(sp), static_cast<const uint8_t*>(spv),
      static_cast<const int32_t*>(recv), static_cast<const uint8_t*>(rv),
      static_cast<const int32_t*>(ptr_start),
      static_cast<const int32_t*>(deg), static_cast<const int32_t*>(rq),
      static_cast<const int32_t*>(rq_count),
      static_cast<const int32_t*>(dyn_pops),
      static_cast<int32_t*>(wq_count_out), static_cast<int32_t*>(rq_out),
      static_cast<int32_t*>(rq_count_out), static_cast<int32_t*>(msgs),
      static_cast<uint8_t*>(mvalid), static_cast<int32_t*>(drops),
      static_cast<int32_t*>(work), static_cast<int32_t*>(npop),
      static_cast<int32_t*>(npush), static_cast<int32_t*>(nspill), stage,
      (size_t)stage_bytes, cap_w, S, R, v_chunk, cap_r, r_pop, max_t2,
      e_chunk, nchan, chan);
  return static_cast<int>(cudaGetLastError());
}

// Leg 4 of triangles, over a grid (T, G + 1): the close spills append to cq
// in place; the search and the fold of the hits by slot counts.  `scratch`
// starts with T * v_chunk slot counts (64 bits each), then the G blocks'
// found sums and tickets (2 T ints), cleared on the stream first.
int repro_fused_close_leg(
    void* cq, const void* cq_count, const void* sp, const void* spv,
    const void* recv, const void* rv, const void* ptr_start, const void* deg,
    const void* edge_dst, const void* acc, void* cq_count_out, void* acc_out,
    void* drops, void* found, void* nspill, void* scratch, int T, int cap_c,
    int S, int R, int v_chunk, int e_chunk, int steps, int G, void* stream) {
  if (G < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t nslots = (size_t)T * v_chunk;
  cudaError_t e = cudaMemsetAsync(
      scratch, 0, nslots * sizeof(unsigned long long) + 2 * T * sizeof(int),
      st);
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned long long* slots = static_cast<unsigned long long*>(scratch);
  fused_close_leg_kernel<<<dim3(T, G + 1), SPLIT_THREADS, 0, st>>>(
      static_cast<int32_t*>(cq), static_cast<const int32_t*>(cq_count),
      static_cast<const int32_t*>(sp), static_cast<const uint8_t*>(spv),
      static_cast<const int32_t*>(recv), static_cast<const uint8_t*>(rv),
      static_cast<const int32_t*>(ptr_start),
      static_cast<const int32_t*>(deg),
      static_cast<const int32_t*>(edge_dst), static_cast<const float*>(acc),
      static_cast<int32_t*>(cq_count_out), static_cast<float*>(acc_out),
      static_cast<int32_t*>(drops), static_cast<int32_t*>(found),
      static_cast<int32_t*>(nspill), slots,
      reinterpret_cast<int*>(slots + nslots), cap_c, S, R, v_chunk, e_chunk,
      steps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
