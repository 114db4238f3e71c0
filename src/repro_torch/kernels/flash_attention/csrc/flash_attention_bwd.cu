// Hopper (sm_90a) flash attention, backward: the gradient of the causal
// attention of the LM's training forward (flash_attention.cu), with an
// optional sliding window and grouped-query heads.  It replaces no TPU
// kernel: the JAX package's trainer differentiates its plain
// blockwise_attention (src/repro/models/layers.py:57) with jax.grad, and its
// Pallas flash kernel has no backward.  The port's training forward is the
// flash kernel, so this is its gradient.
//
// Inputs: q (B, S, H, hd), k and v (B, S, Hkv, hd), the forward's output o
// (B, S, H, hd) and each row's logsumexp lse (B, H, S) float32 (natural
// log, of the scaled and masked scores), and dO (B, S, H, hd).  Outputs dq,
// dk, dv in q's dtype; delta (B, H, S) float32 is scratch.  bfloat16 or
// float32 operands; every sum is float32, each output rounded once.
//
// Three passes, no float atomics, so a training step gives the same bits
// every run:
//   1. delta = rowsum(dO * O), once a (row, head): a warp a row.
//   2. the key-block pass: a block of 256 threads owns 64 keys of one kv
//      head and batch row, and loops over the G query heads that read that
//      kv head and over the query tiles of 64 rows that the causal mask and
//      the window leave.  A tile: S^T = K Q^T and dP^T = V dO^T (64 x 64),
//      P^T = exp(scale S^T - lse) where the mask keeps the pair (0
//      elsewhere), dS^T = P^T (dP^T - delta); then dV += P^T dO and
//      dK += dS^T Q in registers.  dK and dV are written once, dK times the
//      scale: a kv head's G query heads sum in the block, so grouped heads
//      need no atomics.
//   3. the query-block pass: a block owns 64 query rows of one head and
//      batch row and loops over the live key tiles: S, dP, P and dS as
//      above (untransposed), dQ += dS K, written once times the scale.
// Causal masking and the window are the forward's: key j is live for query
// i when j <= i and (no window or j > i - window); rows and keys past S
// are masked and never written.
//
// Bound: operations.  Five products of a (query, key) pair's head vectors
// (S and dP in both passes, dV, dK and dQ: the recomputed S and dP make
// seven, the work a pair needs is five), 2 * hd operations each: the pass
// is far above the card's operations-per-byte line at S = 2048.
//
// The design is the simple one: CUDA-core FMAs in float32 (bfloat16
// operands widened on load), the tiles row-major in shared memory with a
// row stride of hd + 4 floats, so that 8 threads' 16-byte loads of 8
// consecutive rows fall in distinct banks (hd + 4 = 4 mod 32 at hd 32, 64
// and 128; 20 mod 32 at hd 80).  A thread owns rows ty + 16 i (i < 4) and
// columns tx + 16 j of a 64 x 64 tile, and columns tx + 16 c of the
// 64 x hd accumulators (hd / 16 of them).  A design on the tensor cores
// (wgmma, TMA) is later work.
//
// Plain C interface, built and loaded as the forward is
// (repro_torch/kernels/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;       // rows of a query tile and of a key tile
constexpr int NT = 256;      // threads: 16 row groups x 16 column groups
constexpr int TS = BT + 4;   // row stride of a 64 x 64 score tile

template <int HD>
struct Lay {
  static constexpr int LD = HD + 4;        // row stride of a 64 x hd tile
  static constexpr int TILE = BT * LD;     // floats of a 64 x hd tile
  static constexpr int NC = HD / 16;       // accumulator columns a thread
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows r0 .. r0 + 63 of one head of a (B, S, heads, HD) tensor, from `base`
// (its (b, 0, head, 0) element; rows `row` elements apart), into a
// row-major tile of stride LD; rows past S read as zeros
template <typename T, int HD>
__device__ void load_tile(float* dst, const T* base, size_t row, int r0,
                          int S) {
  constexpr int Q4 = HD / 4;
  for (int e = threadIdx.x; e < BT * Q4; e += NT) {
    const int r = e / Q4, c = 4 * (e % Q4);
    const float4 x = r0 + r < S ? load4(base + (size_t)(r0 + r) * row + c)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * Lay<HD>::LD + c) = x;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * Bm[tx + 16 j][d] over two row-major
// tiles of stride LD
template <int HD>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         int ty, int tx, float (&acc)[4][4]) {
  constexpr int LD = Lay<HD>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = load4(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = load4(Bm + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][c] += sum_r P[ty + 16 i][r] * X[r][tx + 16 c]: P a 64 x 64 tile of
// stride TS, X a 64 x HD tile of stride LD
template <int HD>
__device__ __forceinline__ void tile_acc(const float* P, const float* X,
                                         int ty, int tx,
                                         float (&acc)[4][Lay<HD>::NC]) {
  constexpr int LD = Lay<HD>::LD, NC = Lay<HD>::NC;
#pragma unroll 2
  for (int r = 0; r < BT; r += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = load4(P + (ty + 16 * i) * TS + r);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float x[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) x[c] = X[(r + rr) * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = rr == 0 ? p[i].x : rr == 1 ? p[i].y
                       : rr == 2 ? p[i].z : p[i].w;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv, x[c], acc[i][c]);
      }
    }
  }
}

__device__ __forceinline__ bool live(int kpos, int qpos, int S, int window) {
  return kpos <= qpos && qpos < S && (!window || kpos > qpos - window);
}

// ---- pass 1: delta = rowsum(dO * O), a warp a (row, head) ----
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int B, int S, int H) {
  const int warp = (blockIdx.x * NT + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (warp >= B * S * H) return;
  const int h = warp % H, s = (warp / H) % S, b = warp / (H * S);
  const size_t off = (size_t)warp * HD;  // (b, s, h) row of o and dout
  float acc = 0.0f;
  for (int d = lane; d < HD; d += 32)
    acc = fmaf(to_f(dout[off + d]), to_f(o[off + d]), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) delta[((size_t)b * H + h) * S + s] = acc;
}

// ---- pass 2: dK and dV, a block a (64 keys, kv head, batch row) ----
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ lse,
                const T* __restrict__ dout, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, int S, int H,
                int Hkv, int window, float scale) {
  using L = Lay<HD>;
  constexpr int NC = L::NC;
  extern __shared__ float4 bwd_smem4[];
  float* ks = reinterpret_cast<float*>(bwd_smem4);
  float* vs = ks + L::TILE;
  float* qs = vs + L::TILE;
  float* dos = qs + L::TILE;
  float* pt = dos + L::TILE;     // P^T (64 keys x 64 queries)
  float* dst = pt + BT * TS;     // dS^T
  float* lse_s = dst + BT * TS;  // the query tile's lse and delta
  float* del_s = lse_s + BT;

  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BT;
  const int G = H / Hkv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)Hkv * HD;
  load_tile<T, HD>(ks, k + (size_t)b * S * kv_row + (size_t)hk * HD, kv_row,
                   k0, S);
  load_tile<T, HD>(vs, v + (size_t)b * S * kv_row + (size_t)hk * HD, kv_row,
                   k0, S);

  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[i][c] = dva[i][c] = 0.0f;

  // the query tiles holding a query that one of these keys is live for
  const int nq = (S + BT - 1) / BT;
  const int qt_lo = k0 / BT;
  const int qt_hi =
      window ? min(nq - 1, (min(k0 + BT, S) - 1 + window - 1) / BT) : nq - 1;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* qb = q + (size_t)b * S * q_row + (size_t)h * HD;
    const T* db = dout + (size_t)b * S * q_row + (size_t)h * HD;
    const float* lb = lse + ((size_t)b * H + h) * S;
    const float* eb = delta + ((size_t)b * H + h) * S;
    for (int it = qt_lo; it <= qt_hi; ++it) {
      const int q0 = it * BT;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, HD>(qs, qb, q_row, q0, S);
      load_tile<T, HD>(dos, db, q_row, q0, S);
      if (threadIdx.x < BT) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < S ? lb[r] : 0.0f;
        del_s[threadIdx.x] = r < S ? eb[r] : 0.0f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_dot<HD>(ks, qs, ty, tx, s);
      tile_dot<HD>(vs, dos, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kr = ty + 16 * i, qc = tx + 16 * j;
          const float p = live(k0 + kr, q0 + qc, S, window)
                              ? expf(s[i][j] * scale - lse_s[qc])
                              : 0.0f;
          pt[kr * TS + qc] = p;
          dst[kr * TS + qc] = p * (dp[i][j] - del_s[qc]);
        }
      __syncthreads();
      tile_acc<HD>(pt, dos, ty, tx, dva);
      tile_acc<HD>(dst, qs, ty, tx, dka);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= S) continue;
    const size_t off = ((size_t)b * S + r) * kv_row + (size_t)hk * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store(dk + off + tx + 16 * c, dka[i][c] * scale);
      store(dv + off + tx + 16 * c, dva[i][c]);
    }
  }
}

// ---- pass 3: dQ, a block a (64 query rows, head, batch row) ----
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ lse,
              const T* __restrict__ dout, const float* __restrict__ delta,
              T* __restrict__ dq, int S, int H, int Hkv, int window,
              float scale) {
  using L = Lay<HD>;
  constexpr int NC = L::NC;
  extern __shared__ float4 bwd_smem4[];
  float* qs = reinterpret_cast<float*>(bwd_smem4);
  float* dos = qs + L::TILE;
  float* ks = dos + L::TILE;
  float* vs = ks + L::TILE;
  float* ds = vs + L::TILE;      // dS (64 queries x 64 keys)
  float* lse_s = ds + BT * TS;
  float* del_s = lse_s + BT;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BT;  // heaviest tiles first
  const int hk = h / (H / Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)Hkv * HD;
  load_tile<T, HD>(qs, q + (size_t)b * S * q_row + (size_t)h * HD, q_row, q0,
                   S);
  load_tile<T, HD>(dos, dout + (size_t)b * S * q_row + (size_t)h * HD, q_row,
                   q0, S);
  if (threadIdx.x < BT) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < S ? lse[((size_t)b * H + h) * S + r] : 0.0f;
    del_s[threadIdx.x] = r < S ? delta[((size_t)b * H + h) * S + r] : 0.0f;
  }

  float dqa[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dqa[i][c] = 0.0f;

  // the key tiles holding a key that some row of this tile attends to
  const int kt_hi = (min(q0 + BT, S) - 1) / BT;
  const int kt_lo = window ? max(0, (q0 - window + 1) / BT) : 0;
  const T* kb = k + (size_t)b * S * kv_row + (size_t)hk * HD;
  const T* vb = v + (size_t)b * S * kv_row + (size_t)hk * HD;
  for (int it = kt_lo; it <= kt_hi; ++it) {
    const int k0 = it * BT;
    __syncthreads();
    load_tile<T, HD>(ks, kb, kv_row, k0, S);
    load_tile<T, HD>(vs, vb, kv_row, k0, S);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<HD>(qs, ks, ty, tx, s);
    tile_dot<HD>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = ty + 16 * i, kc = tx + 16 * j;
        const float p = live(k0 + kc, q0 + qr, S, window)
                            ? expf(s[i][j] * scale - lse_s[qr])
                            : 0.0f;
        ds[qr * TS + kc] = p * (dp[i][j] - del_s[qr]);
      }
    __syncthreads();
    tile_acc<HD>(ds, ks, ty, tx, dqa);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const size_t off = ((size_t)b * S + r) * q_row + (size_t)h * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(dq + off + tx + 16 * c,
                                       dqa[i][c] * scale);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           void* delta, int B, int S, int H, int Hkv, int window, float scale,
           cudaStream_t st) {
  using L = Lay<HD>;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* ep = static_cast<float*>(delta);
  const int rows = B * S * H;
  delta_kernel<T, HD><<<(rows * 32 + NT - 1) / NT, NT, 0, st>>>(
      static_cast<const T*>(o), dop, ep, B, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int smem = (int)sizeof(float) * (4 * L::TILE + 2 * BT * TS + 2 * BT);
  auto kv_kern = dkdv_kernel<T, HD>;
  err = cudaFuncSetAttribute(
      kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (S + BT - 1) / BT;
  kv_kern<<<dim3(Hkv, B, nt), NT, smem, st>>>(
      qp, kp, vp, lp, dop, ep, static_cast<T*>(dk), static_cast<T*>(dv), S,
      H, Hkv, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int smem_q = (int)sizeof(float) * (4 * L::TILE + BT * TS + 2 * BT);
  auto q_kern = dq_kernel<T, HD>;
  err = cudaFuncSetAttribute(
      q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  q_kern<<<dim3(H, B, nt), NT, smem_q, st>>>(qp, kp, vp, lp, dop, ep,
                                             static_cast<T*>(dq), S, H, Hkv,
                                             window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* lse, const void* dout, void* dq, void* dk, void* dv,
             void* delta, int B, int S, int H, int Hkv, int hd, int window,
             float scale, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, H,
                           Hkv, window, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, H,
                           Hkv, window, scale, st);
    case 80:
      return launch<T, 80>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, H,
                           Hkv, window, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, S,
                            H, Hkv, window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// is_bf16: 1 for bfloat16 operands and gradients, 0 for float32; scale:
// hd^-0.5 as the caller rounds it to float32, as in the forward.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* lse,
                              const void* dout, void* dq, void* dk, void* dv,
                              void* delta, int B, int S, int H, int Hkv,
                              int hd, int window, int is_bf16, float scale,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, lse, dout, dq, dk, dv,
                                           delta, B, S, H, Hkv, hd, window,
                                           scale, st)
                 : dispatch<float>(q, k, v, o, lse, dout, dq, dk, dv, delta,
                                   B, S, H, Hkv, hd, window, scale, st);
}

}  // extern "C"
