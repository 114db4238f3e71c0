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
// it.  Design: a grid (NB, G) of column-owning blocks, so that a few bins
// still fill the card (G = 5 at 64 bins of 65,536 slots: 320 blocks, ~2.4 a
// SM; kernels/engine/kernel.py column_split).  Block (i, g) owns the slots
// [g * step, min((g + 1) * step, b)) of bin i, and applies only the updates
// whose slot lies there.  Half of its threads copy that range of the value
// array with 16-byte vectors (a stream of device memory) while the other
// half read the bin's `cap` updates (from L2 after the first block of the
// bin) and gather those in range into shared memory: for the add, their
// (slot, row) keys (in row-order chunks of FOLD_ADD_MAX_ROWS updates), sorted
// by the order-keeping sort of
// ../../engine/csrc/ordered_scatter.cuh (bitwise equal to scatter_ref, where
// the TPU's matmul order agrees only within rounding); for the min, their
// (slot, value) pairs.  Then the whole block folds them in: the add at the
// head of each slot's run, in row order; the min with float atomics in the
// integer-order trick.  Every write lands in the block's own range:
// atomic-free by ownership for the add, and exact in any order for the
// min.
//
// Plain C interface, built and loaded as the engine kernels are
// (repro_torch/kernels/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../engine/csrc/ordered_scatter.cuh"

namespace {

constexpr int SS_THREADS = 512;
static_assert(SS_THREADS > repro::COPY_THREADS, "two parts a block");

__global__ void __launch_bounds__(SS_THREADS)
scatter_segments_add_kernel(const float* __restrict__ base,
                            const int32_t* __restrict__ idx,
                            const float* __restrict__ vals,
                            float* __restrict__ out, int b, int cap,
                            int step) {
  extern __shared__ __align__(16) unsigned char ss_smem[];
  const int i = blockIdx.x;
  const int lo = blockIdx.y * step, hi = min(lo + step, b);
  float* o = out + (size_t)i * b;
  const float* bs = base + (size_t)i * b;
  const int32_t* ix = idx + (size_t)i * cap;
  const float* vx = vals + (size_t)i * cap;
  repro::add_fold_beside(
      o, lo, hi, step, cap, ss_smem,
      [&](int r) { return repro::SlotValue{ix[r], vx[r]}; },
      [&](const repro::Team& part) {
        repro::copy_range(bs, o, lo, hi, part);
      });
}

__global__ void __launch_bounds__(SS_THREADS)
scatter_segments_min_kernel(const float* __restrict__ base,
                            const int32_t* __restrict__ idx,
                            const float* __restrict__ vals,
                            float* __restrict__ out, int b, int cap,
                            int step) {
  extern __shared__ __align__(16) unsigned char ss_smem[];
  const int i = blockIdx.x;
  const int lo = blockIdx.y * step, hi = min(lo + step, b);
  float* o = out + (size_t)i * b;
  const float* bs = base + (size_t)i * b;
  const int32_t* ix = idx + (size_t)i * cap;
  const float* vx = vals + (size_t)i * cap;
  repro::min_fold_beside(o, bs, lo, hi, cap, ss_smem, [&](int r) {
    return repro::SlotValue{ix[r], vx[r]};
  });
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The add in row-order chunks of FOLD_ADD_MAX_ROWS updates a bin.
int repro_scatter_segments_add(const void* base, const void* idx,
                               const void* vals, void* out, int nb, int b,
                               int cap, int G, int step, void* stream) {
  if (!repro::valid_split(b, G, step))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = repro::ordered_add_smem(cap, step);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scatter_segments_add_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  scatter_segments_add_kernel<<<dim3(nb, G), SS_THREADS, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const int32_t*>(idx),
      static_cast<const float*>(vals), static_cast<float*>(out), b, cap,
      step);
  return static_cast<int>(cudaGetLastError());
}

int repro_scatter_segments_min(const void* base, const void* idx,
                               const void* vals, void* out, int nb, int b,
                               int cap, int G, int step, void* stream) {
  if (!repro::valid_split(b, G, step) || cap > repro::MIN_FOLD_MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = repro::min_fold_smem(cap);  // under 48 KiB
  scatter_segments_min_kernel<<<dim3(nb, G), SS_THREADS, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const int32_t*>(idx),
      static_cast<const float*>(vals), static_cast<float*>(out), b, cap,
      step);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
