// Hopper (sm_90a) block-ELL SpMV: replaces spmv_block_ell
// (src/repro/kernels/spmv/kernel.py:42), the paper's SpMV workload in block
// form.  y = A x with A stored as NB row-blocks of S (b, b) blocks each;
// bcols[i, s] is the column-block of slot s of row-block i, -1 (or any
// value outside [0, NB)) for an empty slot, which is never read.
//
// Bound: bytes -- each non-empty (b, b) block is read once (4*b*b bytes for
// 2*b*b operations, far below the card's operations-per-byte line), plus x
// and y.  On a power-law graph the live slots are few and skewed (R-MAT-14
// at b = 128: 7 to 127 live slots a row-block), so one block per row-block
// left most SMs idle behind the busiest row-block.  Design:
//   * Work split: grid (NB, G).  Block (i, g) takes the slots s = g, g + G,
//     g + 2G, ... of row-block i; the wrapper picks G from the SM count, so
//     that the grid keeps several blocks on every SM and no row-block's
//     slots wait on one SM.
//   * Reads: 256 threads; a row of a block is LPR lanes of float4 loads (a
//     whole 512-byte row a warp at b = 128; 16 or 8 lanes at b = 64 or 32,
//     where a warp covers 2 or 4 rows).  Each lane keeps its float4s of the
//     slot's x block in registers and owns the partial sums of b / 32 * LPR
//     / 8 rows across every slot of its group, so a slot issues all its
//     loads (up to 16 float4 a thread in flight) before any multiply, and
//     the lanes of a row reduce with shuffles only once, at the end.
//   * Combining the groups, in one launch and in a fixed order: group
//     partials go to part (NB, G, b); the last block of a row-block to
//     finish (__threadfence and a per-row-block counter, reset by that
//     block) sums the G partials in group order.  Each y element is thus
//     summed in the same order on every run (bitwise equal from run to
//     run); the TPU kernel sums in the MXU's order, so the two agree within
//     rounding.  A row-block with no live slot writes zeros.
//
// Plain C interface, built and loaded as the engine kernels are
// (repro_torch/kernels/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;          // warps of a block
constexpr int NT = 32 * NW;    // threads of a block
constexpr int MAX_LOADS = 16;  // float4 loads a thread keeps in flight

// Thread layout of a (B, B) block: lanes a row, float4s a lane reads of a
// row, rows a warp covers at once, rows a thread owns.
template <int B>
struct Layout {
  static constexpr int V4 = B / 4;  // float4s a row
  static constexpr int LPR = V4 % 32 == 0 ? 32 : V4 % 16 == 0 ? 16 : 8;
  static constexpr int C4 = V4 / LPR;
  static constexpr int RPW = 32 / LPR;
  static constexpr int RPT = B / (RPW * NW);
  static constexpr int CHUNK = C4 >= MAX_LOADS ? 1 : MAX_LOADS / C4;
  static_assert(B % 32 == 0 && RPT * RPW * NW == B, "block size");
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int B>
__global__ void __launch_bounds__(NT)
    spmv_block_ell_kernel(const float* __restrict__ bvals,
                          const int32_t* __restrict__ bcols,
                          const float* __restrict__ x, float* __restrict__ y,
                          float* __restrict__ part, int* __restrict__ count,
                          int nb, int S) {
  using L = Layout<B>;
  const int i = blockIdx.x, g = blockIdx.y, G = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = lane % L::LPR;                // first float4 column
  const int rsub = lane / L::LPR;              // row within the warp's rows
  auto row_of = [&](int r) { return (r * NW + warp) * L::RPW + rsub; };

  float acc[L::RPT];
#pragma unroll
  for (int r = 0; r < L::RPT; ++r) acc[r] = 0.0f;

  for (int s = g; s < S; s += G) {
    const int c = __ldg(bcols + (size_t)i * S + s);
    if (c < 0 || c >= nb) continue;  // empty slot, same for every thread
    const float4* x4 = reinterpret_cast<const float4*>(x) + (size_t)c * L::V4;
    float4 xv[L::C4];
#pragma unroll
    for (int q = 0; q < L::C4; ++q) xv[q] = __ldg(x4 + c0 + q * L::LPR);
    const float4* blk = reinterpret_cast<const float4*>(bvals) +
                        ((size_t)i * S + s) * (B * L::V4);
#pragma unroll
    for (int r0 = 0; r0 < L::RPT; r0 += L::CHUNK) {
      float4 v[L::CHUNK][L::C4];
#pragma unroll
      for (int rr = 0; rr < L::CHUNK; ++rr)
#pragma unroll
        for (int q = 0; q < L::C4; ++q)
          if (r0 + rr < L::RPT)
            v[rr][q] = __ldcs(blk + row_of(r0 + rr) * L::V4 + c0 +
                              q * L::LPR);
#pragma unroll
      for (int rr = 0; rr < L::CHUNK; ++rr)
#pragma unroll
        for (int q = 0; q < L::C4; ++q)
          if (r0 + rr < L::RPT) acc[r0 + rr] = dot4(v[rr][q], xv[q],
                                                     acc[r0 + rr]);
    }
  }

  // reduce each row over its LPR lanes; lane 0 of the row writes the part
  float* mine = part + ((size_t)i * G + g) * B;
#pragma unroll
  for (int r = 0; r < L::RPT; ++r) {
    float v = acc[r];
#pragma unroll
    for (int off = L::LPR / 2; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (c0 == 0) mine[row_of(r)] = v;
  }

  // the last block of row-block i sums the G parts in group order
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(count + i, 1) == G - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int r = threadIdx.x; r < B; r += NT) {
    float v = 0.0f;
    for (int k = 0; k < G; ++k) v += __ldcg(part + ((size_t)i * G + k) * B + r);
    y[(size_t)i * B + r] = v;
  }
  if (threadIdx.x == 0) count[i] = 0;  // ready for the next launch
}

template <int B>
int launch(const void* bvals, const void* bcols, const void* x, void* y,
           void* part, void* count, int nb, int S, int G,
           cudaStream_t stream) {
  spmv_block_ell_kernel<B><<<dim3(nb, G), NT, 0, stream>>>(
      static_cast<const float*>(bvals), static_cast<const int32_t*>(bcols),
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<float*>(part), static_cast<int*>(count), nb, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// part: (nb, G, b) float32 scratch; count: (nb,) int32, zero before the
// first launch (each launch leaves it zero).  Pointers 16-byte aligned.
int repro_spmv_block_ell(const void* bvals, const void* bcols, const void* x,
                         void* y, void* part, void* count, int nb, int S,
                         int b, int G, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (b) {
    case 32: return launch<32>(bvals, bcols, x, y, part, count, nb, S, G, st);
    case 64: return launch<64>(bvals, bcols, x, y, part, count, nb, S, G, st);
    case 96: return launch<96>(bvals, bcols, x, y, part, count, nb, S, G, st);
    case 128:
      return launch<128>(bvals, bcols, x, y, part, count, nb, S, G, st);
    case 160:
      return launch<160>(bvals, bcols, x, y, part, count, nb, S, G, st);
    case 192:
      return launch<192>(bvals, bcols, x, y, part, count, nb, S, G, st);
    case 224:
      return launch<224>(bvals, bcols, x, y, part, count, nb, S, G, st);
    case 256:
      return launch<256>(bvals, bcols, x, y, part, count, nb, S, G, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
