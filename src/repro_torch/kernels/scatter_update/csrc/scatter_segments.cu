// Hopper (sm_90a) binned segment scatter: replaces scatter_segments
// (src/repro/kernels/scatter_update/kernel.py:47), the Dalorex T3 apply step
// in block form.  Bin i folds its `cap` updates (idx -1 = empty slot) into
// its own (b,) block of the value array:
//   add: out[i, idx] += vals in row order (scatter_ref's serial f32 loop);
//   min: out[i, idx] = min(out[i, idx], vals).
//
// The TPU kernel turns the scatter into one-hot algebra for the MXU (a
// (cap, b) one-hot matrix product for add, a masked row reduction for min).
// Hopper has no reason to: the scatter is a few bytes per update, so the
// kernel is bound by bytes (the (b,) block read and written once, each
// update read once), and a one-hot product would spend cap*b operations on
// it.  Design: one block per bin copies its block of the value array, then
// adds through the order-keeping sort of ../../engine/csrc/ordered_scatter.cuh
// (bitwise equal to scatter_ref, where the TPU's matmul order agrees only
// within rounding) or takes the min with float atomics in the integer-order
// trick.  Every write lands in the bin's own block: atomic-free by ownership
// for the add, and exact in any order for the min.
//
// Plain C interface, built and loaded as the engine kernels are
// (repro_torch/kernels/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../engine/csrc/ordered_scatter.cuh"

namespace {

constexpr int SS_THREADS = 1024;

__global__ void __launch_bounds__(SS_THREADS)
scatter_segments_add_kernel(const float* __restrict__ base,
                            const int32_t* __restrict__ idx,
                            const float* __restrict__ vals,
                            float* __restrict__ out, int b, int cap) {
  extern __shared__ __align__(16) unsigned char ss_smem[];
  const int i = blockIdx.x;
  float* o = out + (size_t)i * b;
  repro::copy_slice(base + (size_t)i * b, o, b);
  __syncthreads();
  repro::ordered_add_rows(o, b, idx + (size_t)i * cap, vals + (size_t)i * cap,
                          nullptr, cap, ss_smem);
}

__global__ void __launch_bounds__(SS_THREADS)
scatter_segments_min_kernel(const float* __restrict__ base,
                            const int32_t* __restrict__ idx,
                            const float* __restrict__ vals,
                            float* __restrict__ out, int b, int cap) {
  const int i = blockIdx.x;
  float* o = out + (size_t)i * b;
  repro::copy_slice(base + (size_t)i * b, o, b);
  __syncthreads();
  for (int c = threadIdx.x; c < cap; c += blockDim.x) {
    const size_t q = (size_t)i * cap + c;
    const int j = idx[q];
    if (j >= 0 && j < b) repro::atomic_min_f32(o + j, vals[q]);
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_scatter_segments_add(const void* base, const void* idx,
                               const void* vals, void* out, int nb, int b,
                               int cap, void* stream) {
  const size_t smem = repro::ordered_add_smem(cap);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scatter_segments_add_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  scatter_segments_add_kernel<<<nb, SS_THREADS, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const int32_t*>(idx),
      static_cast<const float*>(vals), static_cast<float*>(out), b, cap);
  return static_cast<int>(cudaGetLastError());
}

int repro_scatter_segments_min(const void* base, const void* idx,
                               const void* vals, void* out, int nb, int b,
                               int cap, void* stream) {
  scatter_segments_min_kernel<<<nb, SS_THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const int32_t*>(idx),
      static_cast<const float*>(vals), static_cast<float*>(out), b, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
