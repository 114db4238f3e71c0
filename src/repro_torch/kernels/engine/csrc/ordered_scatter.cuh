// Device code shared by the T3 folds (engine_kernels.cu) and the binned
// segment scatter (../../scatter_update/csrc/scatter_segments.cu): one block
// folds R rows into one slice of float slots, the slice lying in device
// memory and owned by that block alone.
//
// The add keeps the serial order of the reference (XLA's scatter, and
// scatter_ref's loop): slot s ends as target[s] + v[r1] + v[r2] + ... over
// its rows r1 < r2 < ... .  The block sorts the (slot, row) pairs of its
// rows in shared memory, one 64-bit key each (slot in the high word, row in
// the low word, so keys are unique and the sort needs no stability), then
// the first thread of each run of one slot adds the run in row order.  The
// adds are __fadd_rn, so no contraction can change a bit.
//
// The min is exact in any order, so it folds with float atomics through the
// integer-order trick.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr unsigned long long kNoKey = ~0ull;  // padding: sorts last

__host__ __device__ inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Shared memory an ordered add of R rows needs: R padded keys and R values.
__host__ __device__ inline size_t ordered_add_smem(int R) {
  const int P = next_pow2(R > 0 ? R : 1);
  return (size_t)P * sizeof(unsigned long long) + (size_t)P * sizeof(float);
}

// out[i] = src[i] for i < n, with 16-byte vectors when both are aligned.
__device__ inline void copy_slice(const float* __restrict__ src,
                                  float* __restrict__ out, int n) {
  const bool vec = (n % 4 == 0) && ((reinterpret_cast<uintptr_t>(src) |
                                     reinterpret_cast<uintptr_t>(out)) &
                                    15) == 0;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) o4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = src[i];
  }
}

__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  const int bits = __float_as_int(v);
  if (bits >= 0)
    atomicMin(reinterpret_cast<int*>(addr), bits);
  else
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

// Ascending bitonic sort of n keys in shared memory (n a power of two).
__device__ inline void block_sort(unsigned long long* key, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long a = key[i], b = key[p];
          if ((a > b) == ((i & k) == 0)) {
            key[i] = b;
            key[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// out[slot[r]] += (valid ? (valid[r] ? val[r] : 0) : val[r]) for the rows r
// with 0 <= slot[r] < n_slots, each slot's rows in increasing r.  `out`
// must already hold the target slice, visible to the whole block; `smem`
// holds ordered_add_smem(R) bytes.  Rows that are not valid still add 0.0
// at their slot, as the reference's masked scatter does (-0.0 + 0.0 is
// +0.0), so the caller maps them to an out-of-range slot to skip them.
__device__ inline void ordered_add_rows(float* __restrict__ out, int n_slots,
                                        const int32_t* __restrict__ slot,
                                        const float* __restrict__ val,
                                        const uint8_t* __restrict__ valid,
                                        int R, unsigned char* smem) {
  const int P = next_pow2(R > 0 ? R : 1);
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem);
  float* sval = reinterpret_cast<float*>(key + P);
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    unsigned long long k = kNoKey;
    if (i < R) {
      const int s = slot[i];
      const float v = val[i];
      sval[i] = (valid == nullptr || valid[i]) ? v : 0.0f;
      if (s >= 0 && s < n_slots)
        k = (static_cast<unsigned long long>(s) << 32) |
            static_cast<unsigned int>(i);
    }
    key[i] = k;
  }
  __syncthreads();
  block_sort(key, P);
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const unsigned long long k = key[i];
    if (k == kNoKey) continue;
    const unsigned int s = static_cast<unsigned int>(k >> 32);
    if (i > 0 && static_cast<unsigned int>(key[i - 1] >> 32) == s) continue;
    float acc = out[s];  // this thread owns slot s: the head of its run
    for (int j = i; j < P && static_cast<unsigned int>(key[j] >> 32) == s;
         ++j)
      acc = __fadd_rn(acc, sval[static_cast<unsigned int>(key[j])]);
    out[s] = acc;
  }
}

}  // namespace repro
