// Hopper (sm_90a) chunked Mamba2 SSD recurrence: replaces ssd_pallas
// (src/repro/kernels/mamba2/kernel.py:55, body _ssd_kernel at :18), the
// selective-state scan of a zamba2 prefill.
//
// x (B, S, H, P), dt (B, S, H), a_log (H), B and C (B, S, N) shared across
// heads, and an optional state0 (B, H, P, N), all float32, in; y (B, S, H,
// P) and the final state (B, H, P, N) float32 out.  One block per (head,
// batch) carries the head's (P, N) state through chunks of C steps.  For
// each chunk, with l = clip(-exp(a_log) dt, -4, 0) and L its inclusive
// cumsum down the chunk:
//
//   y[t] = exp(L_t) C_t S^T
//        + sum_{s <= t} (C_t . B_s) exp(L_t - L_s) dt_s x_s
//   S   <- exp(L_last) S + sum_s (x_s dt_s exp(L_last - L_s))^T B_s
//
// what _ssd_kernel computes, summed in another order.  Only s <= t is
// computed: above the diagonal exp(L_t - L_s) reaches e^60 at C = 16 and
// overflows float32 at C = 32, so it is selected away (skipped), never
// multiplied by 0.  Every exponent the kernel takes is <= 0.  L is summed
// in order by one thread.  expf, no fast math.
//
// Bound: operations at the zamba2-2.7b prefill shape (B 4, S 2048, H 80,
// P 64, N 64, C 16): per chunk and head 2 C P N for C_t S^T, 2 C P N for
// the state update and 2 (N + P) for each of the C (C + 1) / 2 scores
// s <= t and their product with x, 12.6 GFLOP with the elementwise terms,
// take longer at 67 TFLOP/s in float32 (0.189 ms) than x and y, dt, B, C
// and the state in and out (353 MB) take at 3.35 TB/s (0.105 ms).  Design
// (simple first; tensor cores, TMA and sharing C B^T across heads are later
// work): grid (H, B), 256 threads, P (16, 32, 64) and N (8, 16, 64)
// template parameters, C a runtime argument <= 32 (the tiles' size).  The
// state, transposed with a P + 1 stride, and the chunk's tiles (x; B and C
// with an N + 1 stride, so the rows of the scores fall in different banks;
// the masked scores) live in shared memory.  Thread (column p, row group
// g) owns y[t][p] for t = g, g + G, ... and S[p][n] for n = g, g + G, ...,
// G = 256 / P, so each product reads one shared value for several register
// accumulators.  The state update waits at a barrier until every thread
// has read the old state.
//
// Plain C interface, built and loaded as the other kernels are
// (repro_torch/kernels/cuda_build.py).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;      // threads of a block
constexpr int CMAX = 32;     // the longest chunk the kernel takes

template <int P, int N>
__global__ void __launch_bounds__(NT)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const float* __restrict__ bm,
           const float* __restrict__ cm, const float* __restrict__ state0,
           float* __restrict__ y, float* __restrict__ state_out, int S,
           int H, int C) {
  constexpr int G = NT / P;                   // row groups
  constexpr int PP = P + 1;                   // row stride of the state
  constexpr int NP = N + 1;                   // row stride of B and C
  constexpr int AP = CMAX + 1;                // row stride of the scores
  constexpr int SCOLS = (N + G - 1) / G;      // most state columns a thread
  constexpr int YROWS = (CMAX + G - 1) / G;   // most y rows a thread owns
  extern __shared__ float smem[];
  float* st = smem;                  // (N, P + 1): st[n][p] = S[p][n]
  float* xs = st + N * PP;           // (C, P): x
  float* bs = xs + CMAX * P;         // (C, N + 1): B
  float* cs = bs + CMAX * NP;        // (C, N + 1): C
  float* att = cs + CMAX * NP;       // (C, C + 1): the masked scores
  float* dts = att + CMAX * AP;      // (C,): dt
  float* ls = dts + CMAX;            // (C,): L
  float* el = ls + CMAX;             // (C,): exp(L)
  float* wg = el + CMAX;             // (C,): exp(L_last - L) dt

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int p = tid % P, g = tid / P;
  const size_t row = (size_t)H * P;  // stride of one step of x and y
  const size_t head = (size_t)b * S * row + (size_t)h * P;
  const size_t sbase = ((size_t)b * H + h) * P * N;
  const float neg_a = -expf(a_log[h]);

  for (int i = tid; i < P * N; i += NT)
    st[(i % N) * PP + i / N] = state0 ? state0[sbase + i] : 0.0f;

  const int n_chunks = S / C;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * C;
    const size_t base = head + (size_t)t0 * row;
    for (int i = tid; i < C * P; i += NT)
      xs[i] = x[base + (size_t)(i / P) * row + i % P];
    const size_t bc = ((size_t)b * S + t0) * N;
    for (int i = tid; i < C * N; i += NT) {
      const int t = i / N, n = i % N;
      bs[t * NP + n] = bm[bc + i];
      cs[t * NP + n] = cm[bc + i];
    }
    if (tid < C) dts[tid] = dt[((size_t)b * S + t0 + tid) * H + h];
    __syncthreads();
    if (tid == 0) {  // L = cumsum(l), in order
      float acc = 0.0f;
      for (int t = 0; t < C; ++t) {
        acc += fminf(fmaxf(neg_a * dts[t], -4.0f), 0.0f);
        ls[t] = acc;
      }
    }
    __syncthreads();
    if (tid < C) {
      el[tid] = expf(ls[tid]);
      wg[tid] = expf(ls[C - 1] - ls[tid]) * dts[tid];
    }
    // att[t][s] = (C_t . B_s) exp(L_t - L_s) dt_s for s <= t; 0 elsewhere
    for (int i = tid; i < C * C; i += NT) {
      const int t = i / C, s = i % C;
      float a = 0.0f;
      if (s <= t) {
#pragma unroll 8
        for (int n = 0; n < N; ++n)
          a = fmaf(cs[t * NP + n], bs[s * NP + n], a);
        a = a * expf(ls[t] - ls[s]) * dts[s];
      }
      att[t * AP + s] = a;
    }
    __syncthreads();
    // y[t][p] = exp(L_t) sum_n C[t][n] S[p][n]
    //         + sum_{s <= t} att[t][s] x[s][p]
    {
      float yi[YROWS], ya[YROWS];
#pragma unroll
      for (int q = 0; q < YROWS; ++q) yi[q] = ya[q] = 0.0f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float sc = st[n * PP + p];
#pragma unroll
        for (int q = 0; q < YROWS; ++q) {
          const int t = g + q * G;
          if (t < C) yi[q] = fmaf(cs[t * NP + n], sc, yi[q]);
        }
      }
      for (int s = 0; s < C; ++s) {
        const float xsp = xs[s * P + p];
#pragma unroll
        for (int q = 0; q < YROWS; ++q) {
          const int t = g + q * G;
          if (t >= s && t < C) ya[q] = fmaf(att[t * AP + s], xsp, ya[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < YROWS; ++q) {
        const int t = g + q * G;
        if (t < C) y[base + (size_t)t * row + p] = el[t] * yi[q] + ya[q];
      }
    }
    __syncthreads();  // every thread has read the old state
    // S[p][n] = exp(L_last) S[p][n] + sum_s (x[s][p] wg[s]) B[s][n]
    {
      float acc[SCOLS];
#pragma unroll
      for (int q = 0; q < SCOLS; ++q) acc[q] = 0.0f;
      for (int s = 0; s < C; ++s) {
        const float w = xs[s * P + p] * wg[s];
#pragma unroll
        for (int q = 0; q < SCOLS; ++q) {
          const int n = g + q * G;
          if (n < N) acc[q] = fmaf(w, bs[s * NP + n], acc[q]);
        }
      }
      const float dec = expf(ls[C - 1]);
#pragma unroll
      for (int q = 0; q < SCOLS; ++q) {
        const int n = g + q * G;
        if (n < N) st[n * PP + p] = dec * st[n * PP + p] + acc[q];
      }
    }
    __syncthreads();  // the tiles are reloaded next chunk
  }
  for (int i = tid; i < P * N; i += NT)
    state_out[sbase + i] = st[(i % N) * PP + i / N];
}

template <int P, int N>
int launch(const float* x, const float* dt, const float* a_log,
           const float* bm, const float* cm, const float* s0, float* y,
           float* sT, int B, int S, int H, int C, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (N * (P + 1) + CMAX * P + 2 * CMAX * (N + 1) + CMAX * (CMAX + 1) +
       4 * CMAX);
  auto kern = ssd_kernel<P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(H, B), NT, smem, stream>>>(x, dt, a_log, bm, cm, s0, y, sT, S,
                                         H, C);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int dispatch_n(const float* x, const float* dt, const float* a_log,
               const float* bm, const float* cm, const float* s0, float* y,
               float* sT, int B, int S, int H, int N, int C,
               cudaStream_t st) {
  switch (N) {
    case 8:
      return launch<P, 8>(x, dt, a_log, bm, cm, s0, y, sT, B, S, H, C, st);
    case 16:
      return launch<P, 16>(x, dt, a_log, bm, cm, s0, y, sT, B, S, H, C, st);
    case 64:
      return launch<P, 64>(x, dt, a_log, bm, cm, s0, y, sT, B, S, H, C, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// state0 may be null (a zero state).  C = min(chunk, S) divides S.
int repro_ssd(const void* x, const void* dt, const void* a_log,
              const void* bm, const void* cm, const void* state0, void* y,
              void* state_out, int B, int S, int H, int P, int N, int C,
              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || C <= 0 || C > CMAX || S % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
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
