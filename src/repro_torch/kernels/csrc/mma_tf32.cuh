// Device helpers shared by the chunked recurrences on the tensor cores
// (../mamba2/csrc/ssd.cu, ../rwkv6/csrc/wkv6.cu): float32 products in
// 3xTF32 on mma.sync.m16n8k8, and cp.async copies into shared memory.
//
// 3xTF32: each float32 operand is split into a TF32 high part and a TF32
// remainder (cvt.rna.tf32.f32), and each product takes three MMAs, lo.hi +
// hi.lo + hi.hi, accumulated in float32: about float32's precision at three
// times TF32's cost.  The tensor cores round their sums toward zero, so a
// sum carried across many products is kept outside them.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo + O(2^-22 |v|), both parts TF32
__device__ __forceinline__ void split(float v, uint32_t* hi, uint32_t* lo) {
  *hi = to_tf32(v);
  *lo = to_tf32(v - __uint_as_float(*hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The fragments of mma.m16n8k8 (g = lane / 4, t4 = lane % 4): A (16 x 8)
// a[0..3] at (row g, column t4), (g + 8, t4), (g, t4 + 4), (g + 8, t4 + 4);
// B (8 x 8) b[0..1] at (row t4, column g), (t4 + 4, g); the accumulator
// d[0..3] at (row g, column 2 t4), (g, 2 t4 + 1), (g + 8, 2 t4), (g + 8,
// 2 t4 + 1).  A B in 3xTF32 is lo.hi + hi.lo + hi.hi.
struct AFrag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ AFrag split_a(float a0, float a1, float a2,
                                         float a3) {
  AFrag f;
  split(a0, &f.hi[0], &f.lo[0]);
  split(a1, &f.hi[1], &f.lo[1]);
  split(a2, &f.hi[2], &f.lo[2]);
  split(a3, &f.hi[3], &f.lo[3]);
  return f;
}

// d += A B: the small terms first
__device__ __forceinline__ void mma3(float* d, const AFrag& a, uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(d, a.lo, bh0, bh1);
  mma_tf32(d, a.hi, bl0, bl1);
  mma_tf32(d, a.hi, bh0, bh1);
}

__device__ __forceinline__ void mma3(float* d, const AFrag& a, float b0,
                                     float b1) {
  uint32_t bh0, bh1, bl0, bl1;
  split(b0, &bh0, &bl0);
  split(b1, &bh1, &bl1);
  mma3(d, a, bh0, bh1, bl0, bl1);
}

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* s, const float* g) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(g));
}

__device__ __forceinline__ void cp_async4(void* s, const float* g) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(g));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

}  // namespace repro
