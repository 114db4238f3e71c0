// Hopper (sm_90a) flash attention, forward: replaces flash_attention
// (src/repro/kernels/flash_attention/kernel.py:72), the causal attention of
// the LM prefill with an optional sliding window and grouped-query heads.
//
// q (B, S, H, hd), k and v (B, S, Hkv, hd), bfloat16 or float32, read in
// place; out (B, S, H, hd) in q's dtype.  Query head h reads kv head
// h / (H / Hkv) directly, so K/V are never repeated.  Everything is
// computed in float32: scores s = (q . k) * hd^-0.5, masked to -1e30 where
// key > query or key <= query - window, an online softmax (m, l, acc) over
// the kv tiles, and acc / max(l, 1e-30) at the end -- the Pallas body's
// arithmetic (kernel.py:22-66), summed in another order.
//
// Bound: operations.  The causal product does 2 * B * H * S^2 * hd
// operations (QK^T and PV over the lower triangle) on 2 * hd bytes a
// query row and kv row, far above the card's operations-per-byte line at
// S = 2048.  Design (simple first, the tensor cores are later work): one
// block of 256 threads per (query tile of 64 rows, head, batch), query
// tiles heaviest-first.  The block loops over only the 64-key tiles that
// the causal mask and the window leave (the Pallas kernel skips the rest
// with pl.when), staging K transposed and V row-major in shared memory as
// float32.  Each thread owns a 4 x 4 block of the 64 x 64 score tile and
// a 4 x (hd / 16) block of the output (hd in 32, 64, 80, 128): both
// products are float32 FMAs on CUDA cores over float4 reads of shared
// memory (float2 and float reads of V at hd 32 and 80); the row max and
// row sum of the online softmax reduce over the 16 threads of a row group
// with warp shuffles.  Rows and keys past S (S need not be a multiple of 64)
// are zero-filled and never written.
//
// Plain C interface, built and loaded as the engine kernels are
// (repro_torch/kernels/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows of a block
constexpr int BK = 64;         // keys of a kv tile
constexpr int NT = 256;        // threads: 16 row groups x 16 column groups
constexpr int TS = BQ + 4;     // row stride of the transposed tiles
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Output columns of thread tx: hd / 16 of them, in float4 (hd = 64, 128)
// or float2 (hd = 32) runs, so that the 16 threads of a row group read one
// contiguous stretch of a V row.  hd = 80 has no such layout (its 5
// columns a thread are no float4 run, and 80 is no multiple of 64): thread
// tx owns columns 5 tx .. 5 tx + 4, read one float at a time (a row stride
// of 5 puts the 16 threads' reads in 16 different banks).
template <int HD>
__device__ __forceinline__ int out_col(int tx, int c) {
  if constexpr (HD % 64 == 0) {
    return (c / 4) * 64 + tx * 4 + (c % 4);
  } else if constexpr (HD == 32) {
    return tx * 2 + c;
  } else {
    return tx * (HD / 16) + c;
  }
}

template <int HD>
__device__ __forceinline__ void load_row(const float* row, int tx,
                                         float (&out)[HD / 16]) {
  if constexpr (HD % 64 == 0) {
#pragma unroll
    for (int g = 0; g < HD / 64; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(row + g * 64 + tx * 4);
      out[4 * g] = x.x;
      out[4 * g + 1] = x.y;
      out[4 * g + 2] = x.z;
      out[4 * g + 3] = x.w;
    }
  } else if constexpr (HD == 32) {
    const float2 x = *reinterpret_cast<const float2*>(row + tx * 2);
    out[0] = x.x;
    out[1] = x.y;
  } else {
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) out[c] = row[tx * (HD / 16) + c];
  }
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S,
                     int H, int Hkv, int window, float scale) {
  constexpr int NC = HD / 16;  // output columns a thread owns
  extern __shared__ float4 fa_smem4[];
  float* smem = reinterpret_cast<float*>(fa_smem4);
  float* qt = smem;              // (HD, TS): q tile, transposed
  float* kt = qt + HD * TS;      // (HD, TS): k tile, transposed
  float* vs = kt + HD * TS;      // (BK, HD): v tile
  float* pt = vs + BK * HD;      // (BK, TS): probabilities, transposed

  const int h = blockIdx.x, b = blockIdx.y;
  const int iq = gridDim.z - 1 - blockIdx.z;  // heaviest tiles first
  const int q0 = iq * BQ;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)Hkv * HD;
  const T* qb = q + (size_t)b * S * q_row + (size_t)h * HD;
  const T* kb = k + (size_t)b * S * kv_row + (size_t)hk * HD;
  const T* vb = v + (size_t)b * S * kv_row + (size_t)hk * HD;

  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    qt[d * TS + r] = q0 + r < S ? to_f32(qb[(size_t)(q0 + r) * q_row + d])
                                : 0.0f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  // kv tiles holding a key that some row of this tile may attend to
  const int q_last = min(q0 + BQ, S) - 1;
  const int kt_hi = q_last / BK;
  const int kt_lo = window ? max(0, (q0 - window + 1) / BK) : 0;
  for (int it = kt_lo; it <= kt_hi; ++it) {
    const int k0 = it * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * HD; e += NT) {
      const int r = e / HD, d = e % HD;
      const bool in = k0 + r < S;
      const size_t off = (size_t)(k0 + r) * kv_row + d;
      kt[d * TS + r] = in ? to_f32(kb[off]) : 0.0f;
      vs[r * HD + d] = in ? to_f32(vb[off]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * TS + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * TS + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool live = kpos <= qpos && (!window || kpos > qpos - window);
        s[i][j] = live ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * TS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(pt + kk * TS + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float vr[NC];
      load_row<HD>(vs + kk * HD, tx, vr);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(av[i], vr[c], acc[i][c]);
    }
  }

  T* ob = o + (size_t)b * S * q_row + (size_t)h * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store(ob + (size_t)r * q_row + out_col<HD>(tx, c), acc[i][c] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Hkv, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * HD * TS + BK * HD + BK * TS);
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Hkv, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int Hkv, int hd, int window, float scale,
             cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, Hkv, window, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, Hkv, window, scale, st);
    case 80: return launch<T, 80>(q, k, v, o, B, S, H, Hkv, window, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, Hkv, window, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// is_bf16: 1 for bfloat16 operands, 0 for float32; scale: hd^-0.5 as the
// caller rounds it to float32.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int B, int S, int H, int Hkv, int hd,
                          int window, int is_bf16, float scale,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, hd,
                                           window, scale, st)
                 : dispatch<float>(q, k, v, o, B, S, H, Hkv, hd, window,
                                   scale, st);
}

}  // extern "C"
