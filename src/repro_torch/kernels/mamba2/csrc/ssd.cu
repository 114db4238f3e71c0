// Hopper (sm_90a) chunked Mamba2 SSD recurrence: replaces ssd_pallas
// (src/repro/kernels/mamba2/kernel.py:55, body _ssd_kernel at :18), the
// selective-state scan of a zamba2 prefill.
//
// x (B, S, H, P), dt (B, S, H), a_log (H), B and C (B, S, N) shared across
// heads, and an optional state0 (B, H, P, N), all float32, in; y (B, S, H,
// P) and the final state (B, H, P, N) float32 out.  The (P, N) state of a
// head is carried through chunks of C steps.  For each chunk, with l =
// clip(-exp(a_log) dt, -4, 0) and L its inclusive cumsum down the chunk:
//
//   y[t] = exp(L_t) C_t S^T
//        + sum_{s <= t} (C_t . B_s) exp(L_t - L_s) dt_s x_s
//   S   <- exp(L_last) S + sum_s (x_s dt_s exp(L_last - L_s))^T B_s
//
// what _ssd_kernel computes, summed in another order.  Only s <= t is
// taken: above the diagonal exp(L_t - L_s) reaches e^60 at C = 16 and
// overflows float32 at C = 32, so it is selected away, never multiplied by
// 0.  Every exponent whose value is used is <= 0.  expf, no fast math.
//
// Bound: bytes at the zamba2-2.7b prefill shape (B 4, S 2048, H 80, P 64,
// N 64, C 16): x and y, dt, B, C and the state in and out (353 MB) take
// 0.105 ms at 3.35 TB/s; the chunk products (2 C P N for C_t S^T and for
// the state, 2 P for each of the C (C + 1) / 2 scores s <= t, and
// 2 C (C + 1) / 2 N for C B^T once a batch row) take 0.069 ms in 3xTF32
// at 495 / 3 TFLOP/s, the rest 0.007 ms at 67 TFLOP/s in float32.
//
// Design.  The recurrence is independent along P: y[t][p] reads only
// S[p][:] and x[:, p], and S[p][:] is updated only from x[:, p]; only the
// scores C_t . B_s and L are shared, across p and across heads.  So
//  - a warp carries 16 state rows of one head (P / 16 warps a head) in
//    registers, as the accumulator fragments of mma.m16n8k8; a block of
//    WARPS = 12 warps carries 12 * 16 / P heads of one batch row (3 at
//    zamba2's P = 64: 108 blocks at its prefill shape, one wave on an
//    H100's 132 SMs).  A block's chain of chunks is the kernel's time;
//  - the chunk's products run on the tensor cores in 3xTF32: each float32
//    operand is split into a TF32 high part and a TF32 remainder
//    (cvt.rna.tf32.f32), and each product takes three MMAs, lo.hi + hi.lo
//    + hi.hi, accumulated in float32.  y's two terms come out of their own
//    accumulators, as does the chunk's state increment: the tensor cores
//    round their sums toward zero, so the carried state is updated with
//    float32 FMAs, S = exp(L_last) S + dS, and never accumulates in them.
//    Every operand is split once: the chunk's B and C, which every warp of
//    the block reads, into shared hi and lo planes by the block; x, x dt
//    exp(L_last - L) and the state by their warp, once a chunk.  A chunk
//    is padded with zero rows to KT tiles of 8 steps (2 up to 16 steps, 4
//    up to 32), a template parameter, so that the products are
//    straight-line code whose independent MMA chains interleave;
//  - G = C B^T (the chunk's C x C scores before the decay) is computed once
//    a chunk by the block for all its heads and P-slices, a warp a 16 x 8
//    tile (two at C = 16).  Each warp applies its head's decay
//    exp(L_t - L_s) dt_s to G[t][s] as a select on s <= t;
//  - the chunk's x, dt, B and C are copied with cp.async into rings of
//    stages: chunk c + 2 is in flight while chunk c is computed and chunk
//    c + 1's planes and scores are formed, behind one barrier a chunk;
//  - each warp takes its head's L with a warp scan (shfl), one lane a step.
// Shared-memory row strides are 8 words past a multiple of 32 (x, B, C)
// or 4 (G), so every fragment load of a warp hits 32 different banks.  The
// padding rows are 0, so every product they enter is 0.
//
// Plain C interface, built and loaded as the other kernels are
// (repro_torch/kernels/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/mma_tf32.cuh"

namespace {

using namespace repro;  // 3xTF32 and cp.async (mma_tf32.cuh)

constexpr int CMAX = 32;                 // the longest chunk the kernel takes
constexpr int SLICE = 16;                // state rows of a warp (the MMA's M)
constexpr int STAGES = 3;                // the ring of chunk tiles
constexpr int WARPS = 12;                // warps a block
constexpr unsigned FULL = 0xffffffffu;

// The shared-memory layout of the kernel <P, N, KT>, in 4-byte
// words, for chunks of at most KT tiles of 8 steps (RB = 8 KT rows):
//   STAGES stages of x (RB, XS) and dt (RB, HB): chunk ch in ch % 3;
//   2 stages of B and C as copied (RB, BS) each: chunk ch in ch % 2;
//   2 sets of B and C split into TF32 hi and lo planes (4 of (RB, BS));
//   2 score tiles G (RB, RB + 4).
template <int P, int N, int KT>
struct Layout {
  static constexpr int NT = 32 * WARPS;         // threads of a block
  static constexpr int HB = WARPS * SLICE / P;  // heads a block
  static constexpr int XS = HB * P + 8;         // row stride of x
  static constexpr int BS = N + 8;              // row stride of B and C
  static constexpr int NJ = N / 8;              // 8-column tiles of N
  static constexpr int RB = 8 * KT;             // rows of a chunk's tiles
  static constexpr int GS = RB + 4;             // row stride of G
  static constexpr int XST = RB * XS + ((RB * HB + 3) & ~3);
  static constexpr int PLANE = RB * BS;
  static constexpr size_t WORDS = (size_t)STAGES * XST + 12 * PLANE +
                                  2 * RB * GS;
};

template <int P, int N, int KT>
__global__ void __launch_bounds__(32 * WARPS, 1)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const float* __restrict__ bm,
           const float* __restrict__ cm, const float* __restrict__ state0,
           float* __restrict__ y, float* __restrict__ state_out, int S,
           int H, int C) {
  using Lay = Layout<P, N, KT>;
  constexpr int NT = Lay::NT, HB = Lay::HB, XS = Lay::XS, BS = Lay::BS;
  constexpr int NJ = Lay::NJ;
  constexpr int RB = Lay::RB, GS = Lay::GS, XST = Lay::XST;
  constexpr int PLANE = Lay::PLANE;
  constexpr int WPH = P / SLICE;   // warps a head
  extern __shared__ __align__(16) float smem[];
  constexpr int MT = (KT + 1) / 2;  // 16-row tiles of G
  float* raw = smem + STAGES * XST;             // 2 x (B, C) as copied
  uint32_t* planes = reinterpret_cast<uint32_t*>(raw + 4 * PLANE);
  float* scores = raw + 12 * PLANE;             // 2 x (RB, GS)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h0 = blockIdx.x * HB, b = blockIdx.y;
  const int nh = H - h0 < HB ? H - h0 : HB;       // heads of this block
  const int hb = warp / WPH, h = h0 + hb;         // the warp's head
  const int pw = (warp % WPH) * SLICE;            // its first state row
  const bool live = hb < nh;
  const int n_chunks = S / C;
  const size_t row = (size_t)H * P;               // a step of x and y

  // rows past C are never loaded or split: they stay 0
  for (int i = threadIdx.x; i < (int)Lay::WORDS; i += NT) smem[i] = 0.0f;
  __syncthreads();

  // chunk ch's x and dt into stage ch % 3, B and C into ch % 2 (a group
  // for every ch)
  auto load = [&](int ch) {
    if (ch < n_chunks) {
      float* xs = smem + (ch % STAGES) * XST;
      float* ds = xs + RB * XS;
      float* bs = raw + (ch & 1) * 2 * PLANE;
      float* cs = bs + PLANE;
      const size_t t0 = (size_t)b * S + (size_t)ch * C;
      const int xq = nh * P / 4;
      for (int i = threadIdx.x; i < C * xq; i += NT) {
        const int t = i / xq, q = i - t * xq;
        cp_async16(xs + t * XS + 4 * q, x + (t0 + t) * row + h0 * P + 4 * q);
      }
      constexpr int BQ = N / 4;
      for (int i = threadIdx.x; i < C * BQ; i += NT) {
        const int t = i / BQ, q = i - t * BQ;
        cp_async16(bs + t * BS + 4 * q, bm + (t0 + t) * N + 4 * q);
        cp_async16(cs + t * BS + 4 * q, cm + (t0 + t) * N + 4 * q);
      }
      for (int i = threadIdx.x; i < C * nh; i += NT) {
        const int t = i / nh, k = i - t * nh;
        cp_async4(ds + t * HB + k, dt + (t0 + t) * H + h0 + k);
      }
    }
    cp_async_commit();
  };

  // Chunk ch's B and C, landed: G[t][s] = C_t . B_s into score set ch % 2,
  // warp w < MT * KT taking the 16 x 8 tile (rows 16 (w / KT) .., columns
  // 8 (w % KT) ..), its k-steps on two accumulators; and B and C
  // split into the hi and lo planes of set ch % 2 by the other warps (by
  // every warp where G takes them all).
  auto prepare = [&](int ch) {
    const float* bs = raw + (ch & 1) * 2 * PLANE;
    const float* cs = bs + PLANE;
    constexpr int tiles = MT * KT;
    if (warp < tiles) {
      const int r0 = 16 * (warp / KT), s0 = 8 * (warp % KT);
      float d[2][4] = {};
#pragma unroll
      for (int k = 0; k < NJ; ++k) {
        const int n = 8 * k + t4;
        const AFrag a = split_a(
            cs[(r0 + g) * BS + n], cs[(r0 + g + 8) * BS + n],
            cs[(r0 + g) * BS + n + 4], cs[(r0 + g + 8) * BS + n + 4]);
        mma3(d[k & 1], a, bs[(s0 + g) * BS + n], bs[(s0 + g) * BS + n + 4]);
      }
      float* gt = scores + (ch & 1) * RB * GS;
      *reinterpret_cast<float2*>(gt + (r0 + g) * GS + s0 + 2 * t4) =
          make_float2(d[0][0] + d[1][0], d[0][1] + d[1][1]);
      *reinterpret_cast<float2*>(gt + (r0 + g + 8) * GS + s0 + 2 * t4) =
          make_float2(d[0][2] + d[1][2], d[0][3] + d[1][3]);
    }
    constexpr int first = tiles < WARPS ? 32 * tiles : 0;
    uint32_t* pl = planes + (ch & 1) * 4 * PLANE;
    for (int i = threadIdx.x - first; i >= 0 && i < C * N; i += NT - first) {
      const int o = i / N * BS + i % N;
      split(bs[o], &pl[o], &pl[PLANE + o]);
      split(cs[o], &pl[2 * PLANE + o], &pl[3 * PLANE + o]);
    }
  };

  // the warp's 16 state rows: st[j] is the accumulator fragment of columns
  // 8j .. 8j + 7 (rows pw + g and pw + g + 8)
  float st[NJ][4];
  const size_t sbase = ((size_t)b * H + h) * P * N;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float2 lo2 = make_float2(0.0f, 0.0f), hi2 = lo2;
    if (live && state0 != nullptr) {
      lo2 = *reinterpret_cast<const float2*>(
          state0 + sbase + (size_t)(pw + g) * N + 8 * j + 2 * t4);
      hi2 = *reinterpret_cast<const float2*>(
          state0 + sbase + (size_t)(pw + g + 8) * N + 8 * j + 2 * t4);
    }
    st[j][0] = lo2.x;
    st[j][1] = lo2.y;
    st[j][2] = hi2.x;
    st[j][3] = hi2.y;
  }
  const float neg_a = live ? -expf(a_log[h]) : 0.0f;

  load(0);
  load(1);
  cp_async_wait<1>();
  __syncthreads();
  prepare(0);

  for (int ch = 0; ch < n_chunks; ++ch) {
    // chunk ch + 1 has landed, and chunk ch's planes and scores are
    // written; every warp is done with chunk ch - 1, whose stages the
    // copy of chunk ch + 2 takes
    cp_async_wait<0>();
    __syncthreads();
    load(ch + 2);
    if (live) {
      const float* xs = smem + (ch % STAGES) * XST;
      const float* ds = xs + RB * XS;
      xs += hb * P + pw;
      const uint32_t* pl = planes + (ch & 1) * 4 * PLANE;
      const uint32_t *bh = pl, *bl = pl + PLANE, *chi = pl + 2 * PLANE,
                     *clo = pl + 3 * PLANE;
      const float* gt = scores + (ch & 1) * RB * GS;
      // L down the chunk by a warp scan, lane j holding step j
      const float dtj = lane < C ? ds[lane * HB + hb] : 0.0f;
      float L = fminf(fmaxf(neg_a * dtj, -4.0f), 0.0f);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(FULL, L, o);
        if (lane >= o) L += v;
      }
      const float l_last = __shfl_sync(FULL, L, C - 1);
      const float elj = expf(L);                          // exp(L_j)
      const float wgj = lane < C ? expf(l_last - L) * dtj : 0.0f;
      const float dec = __shfl_sync(FULL, elj, C - 1);   // exp(L_last)

      // y^T (16 rows of p, 8 columns of t a tile): yi = S C^T (the old
      // state), ya = x^T att^T, att[t][s] = G[t][s] exp(L_t - L_s) dt_s for
      // s <= t
      float yi[KT][4] = {}, ya[KT][4] = {};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        // the state as the A operand, its k index permuted within the tile:
        // k = t4 <-> column 8j + 2 t4, k = t4 + 4 <-> column 8j + 2 t4 + 1
        const AFrag a = split_a(st[j][0], st[j][2], st[j][1], st[j][3]);
#pragma unroll
        for (int i = 0; i < KT; ++i) {
          const int o = (8 * i + g) * BS + 8 * j + 2 * t4;
          const uint2 h2 = *reinterpret_cast<const uint2*>(chi + o);
          const uint2 l2 = *reinterpret_cast<const uint2*>(clo + o);
          mma3(yi[i], a, h2.x, h2.y, l2.x, l2.y);
        }
      }
      float xf[KT][4];   // x^T's fragments, 8 steps a k-tile
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const int s = 8 * k + t4;
        xf[k][0] = xs[s * XS + g];
        xf[k][1] = xs[s * XS + g + 8];
        xf[k][2] = xs[(s + 4) * XS + g];
        xf[k][3] = xs[(s + 4) * XS + g + 8];
        const AFrag a = split_a(xf[k][0], xf[k][1], xf[k][2], xf[k][3]);
        const float ls0 = __shfl_sync(FULL, L, s);
        const float ls1 = __shfl_sync(FULL, L, s + 4);
        const float d0 = __shfl_sync(FULL, dtj, s);
        const float d1 = __shfl_sync(FULL, dtj, s + 4);
#pragma unroll
        for (int i = k; i < KT; ++i) {   // the tiles with some s <= t
          const int t = 8 * i + g;
          const float lt = __shfl_sync(FULL, L, t);
          mma3(ya[i], a,
               s <= t ? gt[t * GS + s] * expf(lt - ls0) * d0 : 0.0f,
               s + 4 <= t ? gt[t * GS + s + 4] * expf(lt - ls1) * d1 : 0.0f);
        }
      }
      // y[t][p] = exp(L_t) yi + ya
      float* yb = y + ((size_t)b * S + (size_t)ch * C) * row + (size_t)h * P +
                  pw;
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        const int t = 8 * i + 2 * t4;
        const float e0 = __shfl_sync(FULL, elj, t);
        const float e1 = __shfl_sync(FULL, elj, t + 1);
        if (t < C) {
          yb[(size_t)t * row + g] = e0 * yi[i][0] + ya[i][0];
          yb[(size_t)t * row + g + 8] = e0 * yi[i][2] + ya[i][2];
        }
        if (t + 1 < C) {
          yb[(size_t)(t + 1) * row + g] = e1 * yi[i][1] + ya[i][1];
          yb[(size_t)(t + 1) * row + g + 8] = e1 * yi[i][3] + ya[i][3];
        }
      }
      // S = exp(L_last) S + dS, dS = (x wg)^T B from zero accumulators
      AFrag xw[KT];
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const int s = 8 * k + t4;
        const float w0 = __shfl_sync(FULL, wgj, s);
        const float w1 = __shfl_sync(FULL, wgj, s + 4);
        xw[k] = split_a(xf[k][0] * w0, xf[k][1] * w0, xf[k][2] * w1,
                        xf[k][3] * w1);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float dd[4] = {};
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          const int o = (8 * k + t4) * BS + 8 * j + g;
          mma3(dd, xw[k], bh[o], bh[o + 4 * BS], bl[o], bl[o + 4 * BS]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          st[j][r] = fmaf(dec, st[j][r], dd[r]);
      }
    }
    if (ch + 1 < n_chunks) prepare(ch + 1);
  }
  cp_async_wait<0>();
  if (live) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      *reinterpret_cast<float2*>(state_out + sbase + (size_t)(pw + g) * N +
                                 8 * j + 2 * t4) =
          make_float2(st[j][0], st[j][1]);
      *reinterpret_cast<float2*>(state_out + sbase +
                                 (size_t)(pw + g + 8) * N + 8 * j + 2 * t4) =
          make_float2(st[j][2], st[j][3]);
    }
  }
}

template <int P, int N, int KT>
int launch(const float* x, const float* dt, const float* a_log,
           const float* bm, const float* cm, const float* s0, float* y,
           float* sT, int B, int S, int H, int C, cudaStream_t stream) {
  using Lay = Layout<P, N, KT>;
  const size_t smem = sizeof(float) * Lay::WORDS;
  auto kern = ssd_kernel<P, N, KT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + Lay::HB - 1) / Lay::HB, B);
  kern<<<grid, Lay::NT, smem, stream>>>(x, dt, a_log, bm, cm, s0, y, sT, S,
                                        H, C);
  return static_cast<int>(cudaGetLastError());
}

// Chunks of up to 16 steps hold two 8-step tiles, longer ones four.
template <int P, int N>
int dispatch_c(const float* x, const float* dt, const float* a_log,
               const float* bm, const float* cm, const float* s0, float* y,
               float* sT, int B, int S, int H, int C, cudaStream_t st) {
  if (C <= 16)
    return launch<P, N, 2>(x, dt, a_log, bm, cm, s0, y, sT, B, S, H, C, st);
  return launch<P, N, CMAX / 8>(x, dt, a_log, bm, cm, s0, y, sT, B, S, H, C,
                                st);
}

template <int P>
int dispatch_n(const float* x, const float* dt, const float* a_log,
               const float* bm, const float* cm, const float* s0, float* y,
               float* sT, int B, int S, int H, int N, int C,
               cudaStream_t st) {
  switch (N) {
    case 8:
      return dispatch_c<P, 8>(x, dt, a_log, bm, cm, s0, y, sT, B, S, H, C, st);
    case 16:
      return dispatch_c<P, 16>(x, dt, a_log, bm, cm, s0, y, sT, B, S, H, C,
                               st);
    case 64:
      return dispatch_c<P, 64>(x, dt, a_log, bm, cm, s0, y, sT, B, S, H, C,
                               st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// state0 may be null (a zero state).  C = min(chunk, S) divides S.  x, B and
// C start on 16 bytes (cp.async), state0 on 8.
int repro_ssd(const void* x, const void* dt, const void* a_log,
              const void* bm, const void* cm, const void* state0, void* y,
              void* state_out, int B, int S, int H, int P, int N, int C,
              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || C <= 0 || C > CMAX || S % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(bm) |
       reinterpret_cast<uintptr_t>(cm)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(state0) % 8 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const float *xp = static_cast<const float*>(x),
              *dp = static_cast<const float*>(dt),
              *ap = static_cast<const float*>(a_log),
              *bp = static_cast<const float*>(bm),
              *cp = static_cast<const float*>(cm),
              *sp = static_cast<const float*>(state0);
  float *yp = static_cast<float*>(y), *tp = static_cast<float*>(state_out);
  switch (P) {
    case 16:
      return dispatch_n<16>(xp, dp, ap, bp, cp, sp, yp, tp, B, S, H, N, C, st);
    case 32:
      return dispatch_n<32>(xp, dp, ap, bp, cp, sp, yp, tp, B, S, H, N, C, st);
    case 64:
      return dispatch_n<64>(xp, dp, ap, bp, cp, sp, yp, tp, B, S, H, N, C, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
