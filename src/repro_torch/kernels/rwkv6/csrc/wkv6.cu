// Hopper (sm_90a) chunked RWKV6 WKV recurrence: replaces wkv6_pallas
// (src/repro/kernels/rwkv6/kernel.py:59, body _wkv6_kernel at :21), the
// time mix of an rwkv6 prefill.
//
// r, k, v and w_log (B, S, H, K) float32, u (H, K) float32 and an optional
// state0 (B, H, K, K) float32 in; y (B, S, H, K) and the final state
// (B, H, K, K) float32 out.  One block per (head, batch) carries the head's
// (K, K) state through chunks of C steps.  For each chunk, with
// L = cumsum(w) down the chunk (per column) and pex = L - w:
//
//   r_in = r * exp(pex)
//   y    = r_in S  +  tril_-1(r_in (k * exp(-L))^T) v  +  ((r * u) . k) v
//   S   <- exp(L_last)[:, None] * S  +  (k * exp(L_last - L))^T v
//
// what _wkv6_kernel computes, summed in another order.  The strictly lower
// triangle is taken by selection: above the diagonal exp(-L) may reach
// e^64 at C = 16 (w_log clipped to -4), and the caller keeps C <= 32.
//
// Bound: bytes at the rwkv6-1.6b prefill shape (4, 2048, 32, 64): r, k,
// v, w_log read once and y written once (340 MB) take longer at 3.35 TB/s
// than the 5.4 GFLOP take at 67 TFLOP/s in float32.  Design (simple first;
// tensor cores, a split over state columns and more blocks a head are later
// work): grid (H, B), 256 threads, K a template parameter in {16, 32, 64}
// and C a runtime argument <= 32.  The state (K x K) and the chunk's tiles
// (r, k, v, w and L, C x (K + 1) each, the odd stride keeping rows in
// different banks) live in shared memory.  Thread (column j, row group g)
// owns y[t][j] for t = g, g + G, ... and S[c][j] for c = g, g + G, ...,
// G = 256 / K, so both products read one shared value for several
// register accumulators.  The state update waits at a barrier until every
// thread has read the old state.
//
// Plain C interface, built and loaded as the other kernels are
// (repro_torch/kernels/cuda_build.py).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;      // threads of a block
constexpr int CMAX = 32;     // the longest chunk the kernel takes

template <int K>
__global__ void __launch_bounds__(NT)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ state0,
            float* __restrict__ y, float* __restrict__ state_out, int S,
            int H, int C) {
  constexpr int KP = K + 1;          // row stride of the chunk tiles
  constexpr int G = NT / K;          // row groups
  constexpr int SROWS = K / G;       // state rows a thread owns
  constexpr int YROWS = (CMAX + G - 1) / G;  // most y rows a thread owns
  extern __shared__ float smem[];
  float* st = smem;                  // state (K, K)
  float* rs = st + K * K;            // r, then r_in
  float* ks = rs + CMAX * KP;        // k, then k * exp(-L)
  float* vs = ks + CMAX * KP;        // v
  float* ws = vs + CMAX * KP;        // w, then k * exp(L_last - L)
  float* ls = ws + CMAX * KP;        // L
  float* att = ls + CMAX * KP;       // (C, C + 1): the masked scores
  float* diag = att + CMAX * (CMAX + 1);  // (C,): (r * u) . k

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int j = tid % K, g = tid / K;
  const size_t row = (size_t)H * K;  // stride of one step
  const size_t head = (size_t)b * S * row + (size_t)h * K;
  const size_t sbase = ((size_t)b * H + h) * K * K;

  for (int i = tid; i < K * K; i += NT)
    st[i] = state0 ? state0[sbase + i] : 0.0f;

  const int n_chunks = S / C;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const size_t base = head + (size_t)ch * C * row;
    for (int i = tid; i < C * K; i += NT) {
      const int t = i / K, c = i % K;
      const size_t off = base + (size_t)t * row + c;
      rs[t * KP + c] = r[off];
      ks[t * KP + c] = k[off];
      vs[t * KP + c] = v[off];
      ws[t * KP + c] = w[off];
    }
    __syncthreads();
    // L = cumsum(w) per column; the bonus (r * u) . k per row
    if (tid < K) {
      float acc = 0.0f;
      for (int t = 0; t < C; ++t) {
        acc += ws[t * KP + tid];
        ls[t * KP + tid] = acc;
      }
    } else if (tid >= 128 && tid < 128 + C) {
      const int t = tid - 128;
      float acc = 0.0f;
      for (int c = 0; c < K; ++c)
        acc = fmaf(rs[t * KP + c] * u[h * K + c], ks[t * KP + c], acc);
      diag[t] = acc;
    }
    __syncthreads();
    for (int i = tid; i < C * K; i += NT) {
      const int t = i / K, c = i % K;
      const float L = ls[t * KP + c], last = ls[(C - 1) * KP + c];
      const float kk = ks[t * KP + c];
      rs[t * KP + c] *= expf(L - ws[t * KP + c]);   // r_in = r e^pex
      ks[t * KP + c] = kk * expf(-L);                // k e^-L
      ws[t * KP + c] = kk * expf(last - L);          // k e^(L_last - L)
    }
    __syncthreads();
    // att[t][s] = r_in[t] . (k e^-L)[s] for s < t; 0 elsewhere
    for (int i = tid; i < C * C; i += NT) {
      const int t = i / C, s = i % C;
      float acc = 0.0f;
      if (s < t) {
#pragma unroll 8
        for (int c = 0; c < K; ++c)
          acc = fmaf(rs[t * KP + c], ks[s * KP + c], acc);
      }
      att[t * (CMAX + 1) + s] = acc;
    }
    __syncthreads();
    // y[t][j] = r_in[t] S[:, j] + att[t] v[:, j] + diag[t] v[t][j]
    {
      float yi[YROWS], ya[YROWS];
#pragma unroll
      for (int q = 0; q < YROWS; ++q) yi[q] = ya[q] = 0.0f;
#pragma unroll 4
      for (int c = 0; c < K; ++c) {
        const float sc = st[c * K + j];
#pragma unroll
        for (int q = 0; q < YROWS; ++q) {
          const int t = g + q * G;
          if (t < C) yi[q] = fmaf(rs[t * KP + c], sc, yi[q]);
        }
      }
      for (int s = 0; s < C - 1; ++s) {
        const float vsj = vs[s * KP + j];
#pragma unroll
        for (int q = 0; q < YROWS; ++q) {
          const int t = g + q * G;
          if (t > s && t < C)
            ya[q] = fmaf(att[t * (CMAX + 1) + s], vsj, ya[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < YROWS; ++q) {
        const int t = g + q * G;
        if (t < C)
          y[base + (size_t)t * row + j] =
              (yi[q] + ya[q]) + diag[t] * vs[t * KP + j];
      }
    }
    __syncthreads();  // every thread has read the old state
    // S[c][j] = e^(L_last[c]) S[c][j] + sum_s (k e^(L_last - L))[s][c] v[s][j]
    {
      float acc[SROWS];
#pragma unroll
      for (int q = 0; q < SROWS; ++q) acc[q] = 0.0f;
      for (int s = 0; s < C; ++s) {
        const float vsj = vs[s * KP + j];
#pragma unroll
        for (int q = 0; q < SROWS; ++q)
          acc[q] = fmaf(ws[s * KP + g + q * G], vsj, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < SROWS; ++q) {
        const int c = g + q * G;
        st[c * K + j] = expf(ls[(C - 1) * KP + c]) * st[c * K + j] + acc[q];
      }
    }
    __syncthreads();  // the tiles are reloaded next chunk
  }
  for (int i = tid; i < K * K; i += NT) state_out[sbase + i] = st[i];
}

template <int K>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* sT, int B, int S,
           int H, int C, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (K * K + 5 * CMAX * (K + 1) + CMAX * (CMAX + 1) + CMAX);
  auto kern = wkv6_kernel<K>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(H, B), NT, smem, stream>>>(r, k, v, w, u, s0, y, sT, S, H, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// state0 may be null (a zero state).  C = min(chunk, S) divides S.
int repro_wkv6(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* state0, void* y, void* state_out,
               int B, int S, int H, int K, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || C <= 0 || C > CMAX || S % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float *rp = static_cast<const float*>(r),
              *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v),
              *wp = static_cast<const float*>(w),
              *up = static_cast<const float*>(u),
              *sp = static_cast<const float*>(state0);
  float *yp = static_cast<float*>(y), *tp = static_cast<float*>(state_out);
  switch (K) {
    case 16: return launch<16>(rp, kp, vp, wp, up, sp, yp, tp, B, S, H, C, st);
    case 32: return launch<32>(rp, kp, vp, wp, up, sp, yp, tp, B, S, H, C, st);
    case 64: return launch<64>(rp, kp, vp, wp, up, sp, yp, tp, B, S, H, C, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
