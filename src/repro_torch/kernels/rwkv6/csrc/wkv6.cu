// Hopper (sm_90a) chunked RWKV6 WKV recurrence: replaces wkv6_pallas
// (src/repro/kernels/rwkv6/kernel.py:59, body _wkv6_kernel at :21), the
// time mix of an rwkv6 prefill.
//
// r, k, v and w_log (B, S, H, K) float32, u (H, K) float32 and an optional
// state0 (B, H, K, K) float32 in; y (B, S, H, K) and the final state
// (B, H, K, K) float32 out.  The (K, K) state of a head (key channel c x
// value column j) is carried through chunks of C steps.  For each chunk,
// with L = cumsum(w) down the chunk (per channel) and pex = L - w:
//
//   r_in = r * exp(pex),  k_neg = k * exp(-L),  k_dec = k * exp(L_last - L)
//   att  = tril_-1(r_in k_neg^T) + diag((r * u) . k)
//   y    = r_in S  +  att v
//   S   <- exp(L_last)[:, None] * S  +  k_dec^T v
//
// what _wkv6_kernel computes, summed in another order (its bonus term
// ((r * u) . k) v is att's diagonal here).  The strictly lower triangle is
// taken by selection, as the reference takes it, never by a product with
// 0: above the diagonal exp(-L) reaches e^64 at C = 16 (w_log clipped to
// -4) and overflows float32 at C = 32.  L is summed step after step, in
// the reference's order: its rounding, an error of ulp(|L|), becomes a
// relative error of exp(+-L).  expf, no fast math.
//
// Bound: bytes at the rwkv6-1.6b prefill shape (4, 2048, 32, 64): r, k,
// v, w_log read once and y written once (340 MB) take 0.101 ms at 3.35
// TB/s, longer than the 5.4 GFLOP of the chunked form take at 67 TFLOP/s
// in float32.
//
// Design.  The recurrence is independent along the value columns j: y[t][j]
// reads only S[:, j] and v[:, j], and S[:, j] is updated only from v[:, j];
// the key side (L, r_in, k_neg, k_dec, att, exp(L_last)) is shared by all
// of a head's columns.  So a block carries one head, with two kinds of
// warps, and one barrier a chunk:
//  - WPH = K / 16 chain warps each carry 16 value columns of the state in
//    registers, transposed (j x c), as the accumulator fragments of
//    mma.m16n8k8, and run the chunk's products on the tensor cores in
//    3xTF32 (mma_tf32.cuh): y^T = S^T r_in^T + v^T att^T and the state's
//    increment dS^T = v^T k_dec.  The tensor cores round their sums toward
//    zero, so the carried state is updated with float32 FMAs, S = exp(L_last)
//    S + dS, each thread scaling its fragments' key channels, and never
//    accumulates in them;
//  - PW = 2 WPH prep warps form the key side once for the head, into shared
//    memory: step A (L, r_in and k_dec split into TF32 hi and lo planes,
//    k_neg, exp(L_last), the bonus) and step B (att = r_in k_neg^T on the
//    tensor cores, a warp a 16 x 8 tile, selected and split into hi and lo
//    planes).  Each operand that a chain warp reads is split once;
//  - a pipeline, so that no barrier falls inside a chunk: while the chain
//    warps carry the state through chunk c (S^T r_in^T, dS, S) and finish
//    chunk c - 1 (v^T att^T and y, from the registers they kept), the prep
//    warps run step B of chunk c and step A of chunk c + 1, which need
//    nothing from each other, and the copy of chunk c + 2 (cp.async, into
//    a ring of three stages) lands;
//  - a chunk is padded with zero rows to KT tiles of 8 steps (1 up to 8
//    steps, 2 up to 16, 4 up to 32), a template parameter, so that the
//    products are straight-line code.
// Shared-memory row strides are 8 words past a multiple of 32 for the
// (step, channel) tiles and 4 for the scores, so the chain warps' fragment
// loads hit 32 different banks.  The padding rows are 0, so every product
// they enter is 0.
//
// Plain C interface, built and loaded as the other kernels are
// (repro_torch/kernels/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/mma_tf32.cuh"

namespace {

using namespace repro;  // 3xTF32 and cp.async (mma_tf32.cuh)

constexpr int CMAX = 32;     // the longest chunk the kernel takes
constexpr int SLICE = 16;    // value columns of a chain warp (the MMA's M)
constexpr int STAGES = 3;    // the ring of chunk tiles

// The shared-memory layout of the kernel <K, KT>, in 4-byte words, for
// chunks of at most KT tiles of 8 steps (RB = 8 KT steps; every tile holds
// RA = 16 rows, a multiple of the MMA's M):
//   STAGES stages of r, k, v and w (RA, BS) each: chunk ch in ch % 3;
//   2 sets of step A's output: r_in and k_dec split into hi and lo planes
//   and k_neg (5 of (RA, BS)), exp(L_last) (K) and the bonus (RA): chunk ch
//   in ch % 2;
//   2 sets of att split into hi and lo planes (2 of (RA, AS)): chunk ch in
//   ch % 2;
//   u (K).
// kernel.py smem_bytes mirrors it.
template <int K, int KT>
struct Layout {
  static constexpr int WPH = K / SLICE;         // chain warps
  static constexpr int PW = 2 * WPH;            // prep warps
  static constexpr int NT = 32 * (WPH + PW);    // threads of a block
  static constexpr int PT = 32 * PW;            // prep threads
  static constexpr int RB = 8 * KT;             // steps of a padded chunk
  static constexpr int RA = 16 * ((KT + 1) / 2);
  static constexpr int BS = K + 8;              // row stride, (step, channel)
  static constexpr int AS = RB + 4;             // row stride of att
  static constexpr int TILE = RA * BS;
  static constexpr int STAGE = 4 * TILE;
  static constexpr int ASET = 5 * TILE + K + RA;
  static constexpr int BSET = 2 * RA * AS;
  static constexpr int WORDS = STAGES * STAGE + 2 * ASET + 2 * BSET + K;
  // step A's shares: L and the planes, NPART threads a channel (RP steps
  // each); the bonus, GB lanes a step (K / GB channels each)
  static constexpr int NPART = PT / K, RP = RB / NPART;
  static constexpr int GB = PT / RB;
  static_assert(PT % K == 0 && RB % NPART == 0 && PT % RB == 0 &&
                    K % GB == 0 && GB <= 32,
                "the prep threads' shares");
  // att's 16 x 8 tiles with some s < t or s = t: rows 16 mt .., columns
  // 8 nt .. for nt <= 2 mt + 1
  static constexpr int NTILES = KT == 4 ? 6 : KT;
};

template <int K, int KT>
__global__ void __launch_bounds__(Layout<K, KT>::NT, 1)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ state0,
            float* __restrict__ y, float* __restrict__ state_out, int S,
            int H, int C) {
  using Lay = Layout<K, KT>;
  constexpr int NT = Lay::NT, PT = Lay::PT, BS = Lay::BS;
  constexpr int AS = Lay::AS, TILE = Lay::TILE;
  constexpr int NJ = K / 8;  // 8-channel tiles of the state
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                                  // STAGES x (r, k, v, w)
  float* asets = raw + STAGES * Lay::STAGE;           // 2 x A-set
  uint32_t* bsets = reinterpret_cast<uint32_t*>(asets + 2 * Lay::ASET);
  float* us = reinterpret_cast<float*>(bsets + 2 * Lay::BSET);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_chunks = S / C;
  const size_t row = (size_t)H * K;  // a step of r, k, v, w and y
  const size_t head = (size_t)b * S * row + (size_t)h * K;
  const size_t sbase = ((size_t)b * H + h) * K * K;
  const bool chain = warp < Lay::WPH;
  const int ptid = threadIdx.x - 32 * Lay::WPH;  // a prep thread's index

  // rows past C are never loaded or written: they stay 0
  for (int i = threadIdx.x; i < Lay::WORDS; i += NT) smem[i] = 0.0f;
  __syncthreads();

  // chunk ch's r, k, v and w into stage ch % 3 (a group for every ch)
  auto load = [&](int ch) {
    if (ch < n_chunks) {
      float* st = raw + (ch % STAGES) * Lay::STAGE;
      constexpr int KQ = K / 4;
      const float* src[4] = {r, k, v, w};
      for (int i = ptid; i < C * KQ; i += PT) {
        const int t = i / KQ, q = i - t * KQ;
        const size_t o = head + (size_t)(ch * C + t) * row + 4 * q;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          cp_async16(st + a * TILE + t * BS + 4 * q, src[a] + o);
      }
    }
    cp_async_commit();
  };

  // Step A of chunk ch, landed, into A-set ch % 2: r_in, k_dec (hi, lo),
  // k_neg, exp(L_last) and the bonus.
  auto step_a = [&](int ch) {
    const float* st = raw + (ch % STAGES) * Lay::STAGE;
    const float *rs = st, *ks = st + TILE, *ws = st + 3 * TILE;
    float* as = asets + (ch & 1) * Lay::ASET;
    uint32_t* rin = reinterpret_cast<uint32_t*>(as);   // hi, then lo
    uint32_t* kdec = rin + 2 * TILE;                   // hi, then lo
    float* kneg = as + 4 * TILE;
    float* dec = kneg + TILE;
    float* bonus = dec + K;
    {
      // channel c, steps [p RP, (p + 1) RP): L summed from step 0
      constexpr int RP = Lay::RP;
      const int c = ptid % K, p = ptid / K, t0 = p * RP;
      float L = 0.0f, Lm[RP], wm[RP];
      for (int t = 0; t < t0 && t < C; ++t) L += ws[t * BS + c];
#pragma unroll
      for (int q = 0; q < RP; ++q) {
        wm[q] = t0 + q < C ? ws[(t0 + q) * BS + c] : 0.0f;
        L += wm[q];
        Lm[q] = L;
      }
      for (int t = t0 + RP; t < C; ++t) L += ws[t * BS + c];
      const float last = L;  // L at step C - 1
#pragma unroll
      for (int q = 0; q < RP; ++q) {
        const int t = t0 + q, o = t * BS + c;
        if (t < C) {
          const float kk = ks[o];
          split(rs[o] * expf(Lm[q] - wm[q]), &rin[o], &rin[TILE + o]);
          kneg[o] = kk * expf(-Lm[q]);
          split(kk * expf(last - Lm[q]), &kdec[o], &kdec[TILE + o]);
        }
      }
      if (p == 0) dec[c] = expf(last);
    }
    {
      // bonus[t] = (r_t * u) . k_t, GB lanes a step
      constexpr int GB = Lay::GB;
      const int t = ptid / GB, cg = ptid % GB;
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < K / GB; ++m) {
        const int c = cg + m * GB;
        acc = fmaf(rs[t * BS + c] * us[c], ks[t * BS + c], acc);
      }
#pragma unroll
      for (int o = GB / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (cg == 0) bonus[t] = acc;
    }
  };

  // Step B of chunk ch, from A-set ch % 2, into B-set ch % 2: att = r_in
  // k_neg^T, a prep warp a 16 x 8 tile, its k-steps on two accumulators;
  // s < t selected, s = t the bonus, the rest 0.
  auto step_b = [&](int ch) {
    const float* as = asets + (ch & 1) * Lay::ASET;
    const uint32_t* rin = reinterpret_cast<const uint32_t*>(as);
    const float* kneg = as + 4 * TILE;
    const float* bonus = kneg + TILE + K;
    uint32_t* att = bsets + (ch & 1) * Lay::BSET;      // hi, then lo
    for (int tile = ptid >> 5; tile < Lay::NTILES; tile += Lay::PW) {
      const int mt = tile < 2 ? 0 : 1, nt = tile < 2 ? tile : tile - 2;
      const int r0 = 16 * mt, s0 = 8 * nt;
      float d[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        const int n = 8 * kk + t4;
        const int o0 = (r0 + g) * BS + n, o1 = o0 + 8 * BS;
        AFrag a;
        a.hi[0] = rin[o0];
        a.hi[1] = rin[o1];
        a.hi[2] = rin[o0 + 4];
        a.hi[3] = rin[o1 + 4];
        a.lo[0] = rin[TILE + o0];
        a.lo[1] = rin[TILE + o1];
        a.lo[2] = rin[TILE + o0 + 4];
        a.lo[3] = rin[TILE + o1 + 4];
        mma3(d[kk & 1], a, kneg[(s0 + g) * BS + n],
             kneg[(s0 + g) * BS + n + 4]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = r0 + g + 8 * (e >> 1), s = s0 + 2 * t4 + (e & 1);
        const float a = t < C && s < t ? d[0][e] + d[1][e]
                                       : (s == t ? bonus[t] : 0.0f);
        split(a, &att[t * AS + s], &att[Lay::RA * AS + t * AS + s]);
      }
    }
  };

  // the warp's 16 value columns: st[j] is the accumulator fragment of key
  // channels 8j .. 8j + 7 (columns pw + g and pw + g + 8); yi and vf, the
  // last chunk's S^T r_in^T and v^T fragments (8 steps a k-tile), kept
  // for its v^T att^T
  const int pw = warp * SLICE;
  float st[NJ][4], yi[KT][4];
  AFrag vf[KT];
  if (chain) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const size_t o = sbase + (size_t)(8 * j + 2 * t4) * K + pw + g;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[j][e] = state0 == nullptr
                       ? 0.0f
                       : state0[o + (e & 1) * K + (e >> 1) * 8];
    }
  } else {
    for (int i = ptid; i < K; i += PT) us[i] = u[h * K + i];
    load(0);
    load(1);
    cp_async_wait<1>();
  }
  __syncthreads();  // u and chunk 0 landed
  if (!chain) {
    step_a(0);
    cp_async_wait<0>();
  }
  __syncthreads();  // chunk 0's step A done, chunk 1 landed

  for (int ch = 0; ch <= n_chunks; ++ch) {
    if (!chain) {
      // chunk ch + 2 into the stage of chunk ch - 1, which every warp is
      // done with; chunk ch + 1 landed at the last barrier
      load(ch + 2);
      if (ch < n_chunks) step_b(ch);
      if (ch + 1 < n_chunks) step_a(ch + 1);
      cp_async_wait<0>();
    } else {
      constexpr int ALO = Lay::RA * AS;  // att's lo plane
      if (ch > 0) {
        // chunk ch - 1: ya = v^T att^T (y^T, 16 columns j, 8 steps t a
        // tile), y = yi + ya
        const uint32_t* att = bsets + ((ch - 1) & 1) * Lay::BSET;
        float ya[KT][4] = {};
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
          for (int i = kk; i < KT; ++i) {  // the tiles with some s <= t
            const int o = (8 * i + g) * AS + 8 * kk + t4;
            mma3(ya[i], vf[kk], att[o], att[o + 4], att[ALO + o],
                 att[ALO + o + 4]);
          }
        }
        float* yb = y + head + (size_t)(ch - 1) * C * row + pw;
#pragma unroll
        for (int i = 0; i < KT; ++i) {
          const int t = 8 * i + 2 * t4;
          if (t < C) {
            yb[(size_t)t * row + g] = yi[i][0] + ya[i][0];
            yb[(size_t)t * row + g + 8] = yi[i][2] + ya[i][2];
          }
          if (t + 1 < C) {
            yb[(size_t)(t + 1) * row + g] = yi[i][1] + ya[i][1];
            yb[(size_t)(t + 1) * row + g + 8] = yi[i][3] + ya[i][3];
          }
        }
      }
      if (ch < n_chunks) {
        // chunk ch: yi = S^T r_in^T (the old state), then S = exp(L_last) S
        // + dS, dS^T = v^T k_dec from zero accumulators
        const float* vs = raw + (ch % STAGES) * Lay::STAGE + 2 * TILE + pw;
        const float* as = asets + (ch & 1) * Lay::ASET;
        const uint32_t* rin = reinterpret_cast<const uint32_t*>(as);
        const uint32_t* kdec = rin + 2 * TILE;
        const float* dec = as + 5 * TILE;
#pragma unroll
        for (int i = 0; i < KT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) yi[i][e] = 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          // the state as the A operand, its k index permuted within the
          // tile: k = t4 <-> channel 8j + 2 t4, k = t4 + 4 <-> 8j + 2 t4 + 1
          const AFrag a = split_a(st[j][0], st[j][2], st[j][1], st[j][3]);
#pragma unroll
          for (int i = 0; i < KT; ++i) {
            const int o = (8 * i + g) * BS + 8 * j + 2 * t4;
            const uint2 h2 = *reinterpret_cast<const uint2*>(rin + o);
            const uint2 l2 = *reinterpret_cast<const uint2*>(rin + TILE + o);
            mma3(yi[i], a, h2.x, h2.y, l2.x, l2.y);
          }
        }
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          const int s = 8 * kk + t4;
          vf[kk] = split_a(vs[s * BS + g], vs[s * BS + g + 8],
                           vs[(s + 4) * BS + g], vs[(s + 4) * BS + g + 8]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float dd[4] = {};
#pragma unroll
          for (int kk = 0; kk < KT; ++kk) {
            const int o = (8 * kk + t4) * BS + 8 * j + g;
            mma3(dd, vf[kk], kdec[o], kdec[o + 4 * BS], kdec[TILE + o],
                 kdec[TILE + o + 4 * BS]);
          }
          const float2 e2 = *reinterpret_cast<const float2*>(dec + 8 * j +
                                                             2 * t4);
          st[j][0] = fmaf(e2.x, st[j][0], dd[0]);
          st[j][1] = fmaf(e2.y, st[j][1], dd[1]);
          st[j][2] = fmaf(e2.x, st[j][2], dd[2]);
          st[j][3] = fmaf(e2.y, st[j][3], dd[3]);
        }
      }
    }
    __syncthreads();  // chunk ch + 1's step A, chunk ch's step B and the
                      // copy of chunk ch + 2 done; chunk ch's reads done
  }
  if (chain) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const size_t o = sbase + (size_t)(8 * j + 2 * t4) * K + pw + g;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        state_out[o + (e & 1) * K + (e >> 1) * 8] = st[j][e];
    }
  }
}

template <int K, int KT>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* sT, int B, int S,
           int H, int C, cudaStream_t stream) {
  using Lay = Layout<K, KT>;
  const size_t smem = sizeof(float) * Lay::WORDS;
  auto kern = wkv6_kernel<K, KT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(H, B), Lay::NT, smem, stream>>>(r, k, v, w, u, s0, y, sT, S,
                                              H, C);
  return static_cast<int>(cudaGetLastError());
}

// Chunks of up to 8 steps hold one 8-step tile, up to 16 two, longer ones
// four.
template <int K>
int dispatch_c(const float* r, const float* k, const float* v, const float* w,
               const float* u, const float* s0, float* y, float* sT, int B,
               int S, int H, int C, cudaStream_t st) {
  if (C <= 8) return launch<K, 1>(r, k, v, w, u, s0, y, sT, B, S, H, C, st);
  if (C <= 16) return launch<K, 2>(r, k, v, w, u, s0, y, sT, B, S, H, C, st);
  return launch<K, CMAX / 8>(r, k, v, w, u, s0, y, sT, B, S, H, C, st);
}

template <int K>
int words_c(int C) {
  return C <= 8 ? Layout<K, 1>::WORDS
                : (C <= 16 ? Layout<K, 2>::WORDS : Layout<K, 4>::WORDS);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The dynamic shared memory of the instance that runs (K, C), in bytes; -1
// for a pair the kernel does not take.
int repro_wkv6_smem(int K, int C) {
  if (C <= 0 || C > CMAX) return -1;
  switch (K) {
    case 16: return 4 * words_c<16>(C);
    case 32: return 4 * words_c<32>(C);
    case 64: return 4 * words_c<64>(C);
    default: return -1;
  }
}

// state0 may be null (a zero state).  C = min(chunk, S) divides S.  r, k,
// v and w start on 16 bytes (cp.async).
int repro_wkv6(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* state0, void* y, void* state_out,
               int B, int S, int H, int K, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || C <= 0 || C > CMAX || S % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w)) %
          16 !=
      0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const float *rp = static_cast<const float*>(r),
              *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v),
              *wp = static_cast<const float*>(w),
              *up = static_cast<const float*>(u),
              *sp = static_cast<const float*>(state0);
  float *yp = static_cast<float*>(y), *tp = static_cast<float*>(state_out);
  switch (K) {
    case 16:
      return dispatch_c<16>(rp, kp, vp, wp, up, sp, yp, tp, B, S, H, C, st);
    case 32:
      return dispatch_c<32>(rp, kp, vp, wp, up, sp, yp, tp, B, S, H, C, st);
    case 64:
      return dispatch_c<64>(rp, kp, vp, wp, up, sp, yp, tp, B, S, H, C, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
