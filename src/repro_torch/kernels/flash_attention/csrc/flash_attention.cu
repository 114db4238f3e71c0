// Hopper (sm_90a) flash attention, forward: replaces flash_attention
// (src/repro/kernels/flash_attention/kernel.py:72), the causal attention of
// the LM prefill with an optional sliding window and grouped-query heads.
//
// q (B, S, H, hd), k and v (B, S, Hkv, hd), bfloat16 or float32, read in
// place; out (B, S, H, hd) in q's dtype.  Query head h reads kv head
// h / (H / Hkv) directly, so K/V are never repeated.  Both bodies compute
// what the Pallas body computes (kernel.py:25-67): scores in float32,
// scaled by hd^-0.5, -1e30 (not -inf) where key > query or key <= query -
// window, an online softmax (m, l, acc) over the kv tiles, and
// acc / max(l, 1e-30) at the end, rounded once to q's dtype -- summed in
// another order.  Both visit only the kv tiles that the causal mask and the
// window leave (the Pallas kernel skips the rest with pl.when), and start
// the query tiles heaviest first.
//
// Bound: operations.  The causal product does 2 * B * H * S^2 * hd
// operations (QK^T and PV over the lower triangle) on 2 * hd values a query
// row and kv row, far above the card's operations-per-byte line at S = 2048.
//
// bfloat16 (every published prefill): the tensor cores, FA3's shape on raw
// PTX.  A block of 384 threads takes 128 query rows of one head and batch
// row: two consumer warpgroups of 64 rows each, and a producer warpgroup
// whose one thread issues every copy (setmaxnreg moves its registers to the
// consumers: 24 against 240).  The producer loads the Q tile once by TMA,
// then keeps K and V tiles of 64 keys in flight in a 2-stage ring of shared
// memory, each stage with a full and an empty mbarrier.  S = QK^T is
// wgmma m64n64k16 with both operands in shared memory (K-major, swizzled);
// the online softmax runs on the accumulator fragment in registers, each row
// reducing over the 4 lanes that hold it; O += PV is wgmma m64n{hd}k16 with
// P from registers as A and V read as B in its row-major (MN-major) layout.
// P is split into bfloat16 hi = bf16(p) and lo = bf16(p - hi), two wgmma
// each, so P keeps ~2^-17 of relative precision, as in the float32 arithmetic
// of the reference; a bf16 x bf16 product is exact in the float32
// accumulator, so QK^T changes only the order of summation.  The output is
// stored in bfloat16 straight from the registers.  What needs care:
//   * hd = 80: a row is 160 bytes, wider than the 128-byte swizzle.  The
//     tensor map has hd as its innermost dimension and each tile loads as
//     two 64-column boxes; columns 80-127 are out of bounds and TMA fills
//     them with zeros.  QK^T takes 5 k-steps of 16, PV wgmma's N = 80.
//   * hd = 32: a row is 64 bytes, so the tiles take the 64-byte swizzle.
//   * hd = 128: S and O hold 32 + 64 accumulator registers a thread (ptxas
//     -v reports the registers and any spill at every build).
//   * The tensor maps: cuTensorMapEncodeTiled lives in libcuda, which this
//     library does not link; it is looked up (dlopen/dlsym) in the libcuda
//     the CUDA runtime has loaded.  The maps are encoded on the host at
//     each launch, over the (hd, H, S, B) view of q and the (hd, Hkv, S, B)
//     views of k and v, and passed as __grid_constant__ parameters.
//   * GQA: query head h reads kv head h / G through the map's coordinates.
//   * Ragged S (8, 100, 200, ...): TMA fills rows past S with zeros.  A zero
//     key past S scores 0, not -1e30, but the causal mask still removes it:
//     the kv loop stops at the tile of the block's last valid query, and
//     such a key lies past every valid query.  Rows past S are never
//     stored.
//   * A row with no live key in a live tile (the window): its scores are
//     all -1e30, so p = 1 until a live key arrives, when exp(-1e30 - m) = 0
//     wipes acc and l exactly (the reference does the same); l's clamp at
//     1e-30 stays.  A warpgroup skips the tiles in which none of its 64 rows
//     has a live key, which that wipe makes exact.
//   * TMA needs 16-byte-aligned global addresses: the wrapper refuses any
//     other.  A wait on an mbarrier that has not completed after ~1 s traps,
//     so a fault shows as a launch error rather than a hang.
//   * Build time: the PTX is written inline (no CuTe headers), so the source
//     builds in seconds.
//
// float32 (the check of the arithmetic, held at 2e-5): CUDA-core FMAs, one
// block of 256 threads per (query tile of 64 rows, head, batch), staging K
// transposed and V row-major in shared memory as float32.  Each thread owns
// a 4 x 4 block of the 64 x 64 score tile and a 4 x (hd / 16) block of the
// output; the row max and row sum reduce over the 16 threads of a row group
// with warp shuffles.
//
// Plain C interface, built and loaded as the engine kernels are
// (repro_torch/kernels/cuda_build.py).

#include <cuda.h>  // CUtensorMap and its enums: declarations only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

// --------------------------------------------------------------------------
// float32: CUDA-core FMAs
// --------------------------------------------------------------------------

constexpr int BQ = 64;         // query rows of a block
constexpr int BK = 64;         // keys of a kv tile
constexpr int NT = 256;        // threads: 16 row groups x 16 column groups
constexpr int TS = BQ + 4;     // row stride of the transposed tiles

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

template <int HD>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int S, int H, int Hkv, int window, float scale) {
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
  const float* qb = q + (size_t)b * S * q_row + (size_t)h * HD;
  const float* kb = k + (size_t)b * S * kv_row + (size_t)hk * HD;
  const float* vb = v + (size_t)b * S * kv_row + (size_t)hk * HD;

  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    qt[d * TS + r] = q0 + r < S ? qb[(size_t)(q0 + r) * q_row + d] : 0.0f;
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
      kt[d * TS + r] = in ? kb[off] : 0.0f;
      vs[r * HD + d] = in ? vb[off] : 0.0f;
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

  float* ob = o + (size_t)b * S * q_row + (size_t)h * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[(size_t)r * q_row + out_col<HD>(tx, c)] = acc[i][c] / den;
  }
}

template <int HD>
int launch_fma(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int Hkv, int window, float scale,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * HD * TS + BK * HD + BK * TS);
  auto kern = flash_fwd_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, Hkv, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------------
// bfloat16: TMA, an mbarrier ring, wgmma
// --------------------------------------------------------------------------

constexpr int WQ = 128;              // query rows of a block: 2 x 64
constexpr int WK = 64;               // keys of a kv tile
constexpr int STAGES = 2;            // K/V ring depth
constexpr int WG = 128;              // threads of a warpgroup
constexpr int WT = 3 * WG;           // two consumer warpgroups, one producer
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory geometry of one head width.  A tile row is cut into NCH
// chunks of BOXC columns (one TMA box each, SW bytes: the swizzle span);
// each chunk of a tile is its own swizzled region, 1024-byte aligned.
template <int HD>
struct Geom {
  static constexpr int SW = HD == 32 ? 64 : 128;
  static constexpr int BOXC = SW / 2;
  static constexpr int NCH = (HD + BOXC - 1) / BOXC;  // 1, 1, 2, 2
  static constexpr uint64_t LAYOUT = HD == 32 ? 2 : 1;  // 64B / 128B swizzle
  static constexpr int QCH = WQ * SW;   // bytes of a Q chunk (128 rows)
  static constexpr int KCH = WK * SW;   // bytes of a K or V chunk (64 rows)
  static constexpr int Q_BYTES = NCH * QCH;
  static constexpr int KV_BYTES = NCH * KCH;
  static constexpr int KSTEPS = HD / 16;  // QK^T k-steps: 2, 4, 5, 8
  static constexpr int BARS = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = BARS + 8 * (1 + 2 * STAGES) + 1024;  // + align
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the phase of parity `parity`; trap after ~1 s.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > 2000000000LL) __trap();
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode in bits 62-63.
template <int HD>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         Geom<HD>::LAYOUT << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads and writes of a wgmma's registers
// (its accumulator, or the A fragments it reads asynchronously) across the
// wait for it
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 64, f32) (+)= A B^T: A and B in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 32, f32) += A B: A in registers, B in shared memory (MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A B: A in registers, B in shared memory (MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 80, f32) += A B: A in registers, B in shared memory (MN-major)
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                              const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A B: A in registers, B in shared memory (MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  if constexpr (N == 80) wgmma_rs_n80(d, a, db);
  if constexpr (N == 128) wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int HD>
__global__ void __launch_bounds__(WT, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ o, int S, int H, int Hkv,
                       int window, float scale_log2) {
  using G = Geom<HD>;
  extern __shared__ uint8_t fw_smem[];
  const uint32_t base = (smem_u32(fw_smem) + 1023u) & ~1023u;
  const uint32_t qs = base;                       // Q: NCH chunks of 128 rows
  const uint32_t kv = base + G::Q_BYTES;          // stage s: K, then V
  const uint32_t q_full = base + G::BARS;         // then full[s], empty[s]
  auto k_at = [&](int s) { return kv + s * 2 * G::KV_BYTES; };
  auto v_at = [&](int s) { return kv + s * 2 * G::KV_BYTES + G::KV_BYTES; };
  auto full = [&](int s) { return q_full + 8 + 8 * s; };
  auto empty = [&](int s) { return q_full + 8 + 8 * STAGES + 8 * s; };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * WQ;  // heaviest tiles first
  const int hk = h / (H / Hkv);
  // kv tiles holding a key that some row of this block may attend to
  const int kt_hi = (min(q0 + WQ, S) - 1) / WK;
  const int kt_lo = window ? max(0, (q0 - window + 1) / WK) : 0;
  const int n_tiles = kt_hi - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * WG);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 2 * WG) {
      mbar_expect_tx(q_full, G::Q_BYTES);
      for (int c = 0; c < G::NCH; ++c)
        tma_load(qs + c * G::QCH, &qmap, q_full, c * G::BOXC, h, q0, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % STAGES;
        if (n >= STAGES) mbar_wait(empty(s), (n / STAGES - 1) & 1);
        mbar_expect_tx(full(s), 2 * G::KV_BYTES);
        const int k0 = (kt_lo + n) * WK;
        for (int c = 0; c < G::NCH; ++c) {
          tma_load(k_at(s) + c * G::KCH, &kmap, full(s), c * G::BOXC, hk, k0,
                   b);
          tma_load(v_at(s) + c * G::KCH, &vmap, full(s), c * G::BOXC, hk, k0,
                   b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes query rows q0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
    const int qw0 = q0 + 64 * wg;
    // accumulator fragment: this thread holds rows r and r + 8 of the
    // warpgroup's 64, columns 8 j + 2 (lane % 4) + {0, 1} for every j
    const int qa = qw0 + warp * 16 + lane / 4, qb = qa + 8;
    const int c_lane = 2 * (lane % 4);
    // the tiles in which some row of this warpgroup has a live key
    const int hi_w = qw0 < S ? (min(qw0 + 64, S) - 1) / WK : -1;
    const int lo_w = window ? max(0, (qw0 - window + 1) / WK) : 0;
    constexpr int SBO = 8 * G::SW;  // 8-row groups of a swizzled region

    float oacc[HD / 2], sacc[32];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

    mbar_wait(q_full, 0);
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % STAGES, it = kt_lo + n;
      mbar_wait(full(s), (n / STAGES) & 1);
      if (it >= lo_w && it <= hi_w) {
        // S = Q K^T over hd in k-steps of 16 (32 bytes of a swizzled row)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < G::KSTEPS; ++kk) {
          const int chunk = kk * 16 / G::BOXC, col = kk * 16 % G::BOXC;
          const uint64_t da = desc<HD>(
              qs + chunk * G::QCH + wg * 64 * G::SW + col * 2, 16, SBO);
          const uint64_t db =
              desc<HD>(k_at(s) + chunk * G::KCH + col * 2, 16, SBO);
          wgmma_ss_n64(sacc, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(sacc);

        // online softmax on the fragment, in log2 units
        const int k0 = it * WK;
        const bool masked = k0 + WK - 1 > qw0 ||
                            (window && k0 <= qw0 + 63 - window);
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = (i >> 1) & 1;
          float x = sacc[i] * scale_log2;
          if (masked) {
            const int qpos = row ? qb : qa;
            const int kpos = k0 + 8 * (i >> 2) + c_lane + (i & 1);
            const bool live =
                kpos <= qpos && (!window || kpos > qpos - window);
            x = live ? x : NEG_INF;
          }
          sacc[i] = x;
          mx[row] = fmaxf(mx[row], x);
        }
        float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          corr[r] = exp2f(m[r] - mx[r]);
          m[r] = mx[r];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = (i >> 1) & 1;
          sacc[i] = exp2f(sacc[i] - m[row]);
          sum[row] += sacc[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
          l[r] = l[r] * corr[r] + sum[r];
        }
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) oacc[i] *= corr[(i >> 1) & 1];

        // P as wgmma A fragments: key step kk holds accumulator registers
        // 8 kk .. 8 kk + 7, in the A operand's order; hi and lo halves
        uint32_t ph[16], pl[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float p0 = sacc[2 * i], p1 = sacc[2 * i + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          ph[i] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[i] = pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
        }

        // O += P V, V read MN-major: 16 keys a step, NCH chunks along hd
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WK / 16; ++kk) {
          const uint64_t db = desc<HD>(v_at(s) + kk * 16 * G::SW, G::KCH, SBO);
          wgmma_rs<HD>(oacc, ph + 4 * kk, db);
          wgmma_rs<HD>(oacc, pl + 4 * kk, db);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(oacc);
        reg_fence(ph);
        reg_fence(pl);
      }
      mbar_arrive(empty(s));
    }

    // acc / max(l, 1e-30), rounded once to bfloat16, rows past S not stored
    const size_t q_row = (size_t)H * HD;
    __nv_bfloat16* ob = o + (size_t)b * S * q_row + (size_t)h * HD + c_lane;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = r ? qb : qa;
      if (qpos >= S) continue;
      const float inv = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qpos * q_row + 8 * j) =
            __floats2bfloat162_rn(oacc[4 * j + 2 * r] * inv,
                                  oacc[4 * j + 2 * r + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled, from the libcuda that the CUDA runtime loaded
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// (hd, heads, S, B) view of a (B, S, heads, hd) bfloat16 tensor, boxes of
// (BOXC, 1, rows, 1); out-of-bounds elements read as zeros
template <int HD>
bool encode(EncodeTiled fn, CUtensorMap* map, const void* p, int heads,
            int S, int B, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2,
                                 (cuuint64_t)heads * HD * 2,
                                 (cuuint64_t)S * heads * HD * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Geom<HD>::BOXC, 1, (cuuint32_t)rows,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            HD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int H, int Hkv, int window, float scale,
                 cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap qm, km, vm;
  if (!encode<HD>(fn, &qm, q, H, S, B, WQ) ||
      !encode<HD>(fn, &km, k, Hkv, S, B, WK) ||
      !encode<HD>(fn, &vm, v, Hkv, S, B, WK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_wgmma_kernel<HD>;
  const int smem = Geom<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (S + WQ - 1) / WQ);
  kern<<<grid, WT, smem, stream>>>(qm, km, vm,
                                   static_cast<__nv_bfloat16*>(o), S, H, Hkv,
                                   window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int Hkv, int window, float scale, cudaStream_t st) {
  if constexpr (BF16)
    return launch_wgmma<HD>(q, k, v, o, B, S, H, Hkv, window, scale, st);
  else
    return launch_fma<HD>(q, k, v, o, B, S, H, Hkv, window, scale, st);
}

template <bool BF16>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int Hkv, int hd, int window, float scale,
             cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<BF16, 32>(q, k, v, o, B, S, H, Hkv, window, scale, st);
    case 64:
      return launch<BF16, 64>(q, k, v, o, B, S, H, Hkv, window, scale, st);
    case 80:
      return launch<BF16, 80>(q, k, v, o, B, S, H, Hkv, window, scale, st);
    case 128:
      return launch<BF16, 128>(q, k, v, o, B, S, H, Hkv, window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// is_bf16: 1 for bfloat16 operands (the wgmma body), 0 for float32 (the FMA
// body); scale: hd^-0.5 as the caller rounds it to float32.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int B, int S, int H, int Hkv, int hd,
                          int window, int is_bf16, float scale,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? dispatch<true>(q, k, v, o, B, S, H, Hkv, hd, window,
                                  scale, st)
                 : dispatch<false>(q, k, v, o, B, S, H, Hkv, hd, window,
                                   scale, st);
}

}  // extern "C"
