// Hopper (sm_90a) block-ELL SpMV: replaces spmv_block_ell
// (src/repro/kernels/spmv/kernel.py:42), the paper's SpMV workload in block
// form.  y = A x with A stored as NB row-blocks of S (b, b) blocks each;
// bcols[i, s] is the column-block of slot s of row-block i, -1 (or any
// value outside [0, NB)) for an empty slot, which is never read.
//
// Bound: bytes — each non-empty (b, b) block is read once (4*b*b bytes for
// 2*b*b operations, far below the card's operations-per-byte line), plus x
// and y.  Design: one block of b threads per row-block, each thread owning
// one row's f32 dot product.  The block
// walks its S slots in order, skips empty ones (a block-uniform branch),
// stages the b-vector of x in shared memory, and streams the (b, b) block
// through shared memory 32 columns at a time: each warp reads 32
// consecutive floats of a row (one 128-byte line), and the tile's rows are
// padded to 33 floats so that the row-per-thread reads hit 32 banks.
// Each row sums in slot order, then column order, with fused multiply-adds;
// the TPU kernel sums in the MXU's order, so the two agree within rounding.
//
// Plain C interface, built and loaded as the engine kernels are
// (repro_torch/kernels/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SP_COLS = 32;  // columns of a block staged per step

__global__ void spmv_block_ell_kernel(const float* __restrict__ bvals,
                                      const int32_t* __restrict__ bcols,
                                      const float* __restrict__ x,
                                      float* __restrict__ y, int nb, int S,
                                      int b) {
  extern __shared__ float sp_smem[];
  float* xs = sp_smem;        // (b,)
  float* tile = sp_smem + b;  // (b, SP_COLS + 1)
  const int i = blockIdx.x, t = threadIdx.x;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) {
    const int c = bcols[(size_t)i * S + s];
    if (c < 0 || c >= nb) continue;  // empty slot, same for every thread
    __syncthreads();  // the previous slot's readers are done with xs
    xs[t] = x[(size_t)c * b + t];
    const float* blk = bvals + ((size_t)i * S + s) * b * b;
    for (int c0 = 0; c0 < b; c0 += SP_COLS) {
      __syncthreads();
      for (int e = t; e < b * SP_COLS; e += b) {
        const int r = e / SP_COLS, k = e - r * SP_COLS;
        tile[r * (SP_COLS + 1) + k] = blk[(size_t)r * b + c0 + k];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < SP_COLS; ++k)
        acc = fmaf(tile[t * (SP_COLS + 1) + k], xs[c0 + k], acc);
    }
  }
  y[(size_t)i * b + t] = acc;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_spmv_block_ell(const void* bvals, const void* bcols, const void* x,
                         void* y, int nb, int S, int b, void* stream) {
  const size_t smem = (size_t)b * (SP_COLS + 2) * sizeof(float);
  spmv_block_ell_kernel<<<nb, b, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bvals), static_cast<const int32_t*>(bcols),
      static_cast<const float*>(x), static_cast<float*>(y), nb, S, b);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
