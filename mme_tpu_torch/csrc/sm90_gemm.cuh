// Hopper (sm_90a) building blocks of the bf16 matrix products in
// fused_mlp.cu, flash_fwd.cu and flash_bwd.cu: TMA tensor maps and loads
// (2-D for the MLP's matrices, 4-D for attention's [B, S, H, D] views), an
// mbarrier ring of shared-memory stages, and wgmma m64n64k16 / m64n128k16
// with fp32 accumulators, A from shared memory or from registers.
//
// A product C[M, Nc] = A[M, K] B[K, Nc] is cut into tiles of kBM x kBN.
// A block has three warpgroups: one thread of the first issues the TMA
// loads of every stage (kBK = 64 deep), the other two each own 64 rows of
// the tile and run wgmma on the stages that have arrived. Each operand may
// be stored K-major (K contiguous: A as [M, K], B as [Nc, K] rows) or
// MN-major (M or Nc contiguous: A as [K, M], B as [K, Nc] rows); wgmma's
// transpose bits read either, so nothing is ever transposed in device
// memory. Tiles use the 128-byte swizzle, which caps a TMA box's inner
// extent at 64 bf16:
//  - K-major operand: one box of 64 (K) x 128 (rows) = 16 KB, row r at byte
//    128 r; a 16-deep wgmma step advances the start address by 32 bytes
//    inside the swizzle atom; 8-row groups are 1024 bytes apart (SBO).
//  - MN-major operand: two boxes of 64 (M or Nc) x 64 (K) = 8 KB each, K
//    row k at byte 128 k; a 16-deep step advances by 2048 bytes; 8-deep K
//    groups are 1024 bytes apart (SBO) and the two 64-wide halves 8192
//    bytes (LBO).
// TMA zero-fills whatever a box reads past the matrix edge, so ragged M,
// Nc and K need no code; the epilogues mask their stores.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                  // tile rows: two warpgroups of 64
constexpr int kBN = 128;                  // tile columns
constexpr int kBK = 64;                   // stage depth: one swizzle row
constexpr int kThreads = 384;             // producer + two consumer groups
constexpr int kConsumers = 256;
constexpr int kTileBytes = kBM * kBK * 2;  // one operand tile, 16 KB
constexpr int kHalfBytes = kTileBytes / 2;  // one 64-wide box, 8 KB

// A TMA tensor map and how the operand is stored.
struct Operand {
  CUtensorMap map;
  int mn;                                 // 1: M (or Nc) contiguous
};

// A [B, S, H, D] view as a 4-D tensor map with boxes of 64 (D) x 64 (S)
// rows. The map's outer dimensions are S, H and B in the order of their
// strides; `pos` holds where each of the three sits (1, 2 or 3).
struct Operand4 {
  CUtensorMap map;
  int pos_s, pos_h, pos_b;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarrier ring ----

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool bar_try_wait(uint32_t bar, uint32_t parity) {
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

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the completion of the barrier's phase of this parity. A phase
// that is still open after 10 s can only be a fault of the ring: the block
// traps, so the launch fails instead of holding the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try_wait(bar, parity)) return;
  const uint64_t start = global_ns();
  while (!bar_try_wait(bar, parity))
    if (global_ns() - start > 10000000000ull) __trap();
}

// Named barrier of the two consumer warpgroups (id 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

template <int N> __device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- TMA ----

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A box of 64 rows s0 .. s0 + 63 and 64 columns d0 .. d0 + 63 of head h,
// batch row b: 8 KB arrive on `bar`, row r at byte 128 r (128-byte
// swizzle); rows past S arrive as zeros.
__device__ __forceinline__ void load_box(const Operand4& op, uint32_t dst,
                                         uint32_t bar, int d0, int s0, int h,
                                         int b) {
  const int c1 = op.pos_s == 1 ? s0 : op.pos_h == 1 ? h : b;
  const int c2 = op.pos_s == 2 ? s0 : op.pos_h == 2 ? h : b;
  const int c3 = op.pos_s == 3 ? s0 : op.pos_h == 3 ? h : b;
  tma_load_4d(dst, &op.map, bar, d0, c1, c2, c3);
}

// One operand tile of a stage: rows (or columns) r0 .. r0 + 127 of the
// operand, depth k0 .. k0 + 63; kTileBytes arrive on `bar` either way.
__device__ __forceinline__ void load_tile(const Operand& op, uint32_t dst,
                                          uint32_t bar, int r0, int k0) {
  if (op.mn) {
    tma_load(dst, &op.map, bar, r0, k0);
    tma_load(dst + kHalfBytes, &op.map, bar, r0 + 64, k0);
  } else {
    tma_load(dst, &op.map, bar, k0, r0);
  }
}

// ---- wgmma ----

__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// A K-major operand at `addr` whose depth is cut into 64-wide boxes `box`
// bytes apart: step kk reads box kk / 4 at byte 32 (kk % 4).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, int kk,
                                                uint32_t box) {
  return sw128_desc(addr + (kk / 4) * box + (kk % 4) * 32, 16);
}

// An MN-major operand at `addr`, K row k at byte 128 k, its 64-wide halves
// `lbo` bytes apart: step kk starts 16 rows (2048 bytes) further on.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, int kk,
                                                 uint32_t lbo) {
  return sw128_desc(addr + kk * 2048, lbo);
}

// Descriptor of 16-deep step kk of a tile at `addr` (MN: the 64-wide half
// at `addr`, the next one LBO further on).
template <int MN>
__device__ __forceinline__ uint64_t step_desc(uint32_t addr, int kk) {
  return MN ? mnmajor_desc(addr, kk, kHalfBytes) : kmajor_desc(addr, kk, 0);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for A fragments in registers: they stay live, and unchanged,
// until the products that read them have finished.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// wgmma forms, bf16 operands and fp32 accumulators. Accumulator layout of
// d[64 x N]: thread 32 w + 4 g + q of the warpgroup holds, in d[4 j + e],
// row 16 w + g + 8 (e >> 1) and column 8 j + 2 q + (e & 1). `acc` = 0
// overwrites d (the first step of a product), 1 adds to it. TA and TB are
// the transpose bits: 1 reads an MN-major operand.

// d[64 x 64] (+)= A B, A and B from shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d[64 x 64] (+)= A B, A from registers (four bf16x2 per thread in the
// accumulator layout of a 64 x 16 tile), B from shared memory.
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
        "n"(TB));
}

// d[64 x 128] (+)= A B, A and B from shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d[64 x 128] (+)= A B, A from registers (four bf16x2 per thread in the
// accumulator layout of a 64 x 16 tile), B from shared memory.
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
        "n"(TB));
}

// d += the 64-deep product of one stage: `a` is the consumer warpgroup's
// 64 rows of the A tile, `b` the B tile.
template <int TA, int TB>
__device__ __forceinline__ void mma_stage(float (&d)[64], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_ss<TA, TB>(d, step_desc<TA>(a, kk), step_desc<TB>(b, kk), 1);
}

// A ring of S stages of `bytes` each, from a 1024-byte aligned base, with
// a full and an empty barrier per stage behind the tiles. Iteration `it`
// (counted over every tile a block walks) uses stage it % S in round
// it / S: the consumers wait for the full barrier's phase of parity
// (it / S) & 1, the producer for the empty barrier's previous phase, which
// a fresh barrier counts as complete.
template <int S, int BYTES>
struct Ring {
  uint32_t base;
  __device__ uint32_t stage(int it) const { return base + (it % S) * BYTES; }
  __device__ uint32_t full(int it) const {
    return base + S * BYTES + 8 * (it % S);
  }
  __device__ uint32_t empty(int it) const {
    return base + S * BYTES + 8 * (S + it % S);
  }
  __device__ uint32_t parity(int it) const { return (it / S) & 1; }
  __host__ __device__ static constexpr size_t bytes() {
    return (size_t)S * BYTES + 16 * S;
  }

  // one thread, before __syncthreads; every consumer thread releases a
  // stage it has read. A stage is full when its bytes have arrived and
  // `arrivals` threads have arrived (the producer's expect_tx is one).
  __device__ void init(int arrivals = 1) const {
    for (int s = 0; s < S; ++s) {
      bar_init(full(s), arrivals);
      bar_init(empty(s), kConsumers);
    }
    bar_init_fence();
  }
  // producer side of iteration `it`: the stage is free, then `tx` bytes
  // are announced on its full barrier
  __device__ uint32_t acquire(int it, uint32_t tx) const {
    bar_wait(empty(it), parity(it) ^ 1);
    bar_expect(full(it), tx);
    return stage(it);
  }
};

// 1024-byte aligned base of the dynamic shared memory (the launch asks for
// 1024 bytes more than the ring and the rest need).
__device__ __forceinline__ uint32_t aligned_smem_base(const void* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, fetched through the runtime so the
// library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The operand of `rows` x `k` (logical: rows are M for A, Nc for B) at
// `ptr`, row stride `ld` elements in memory: K-major stores it as
// [rows][k], MN-major as [k][rows]. TMA needs a 16-byte aligned base and
// a row stride that is a multiple of 16 bytes; false if the driver
// refuses.
inline bool make_operand(Operand* op, const void* ptr, long long rows,
                         long long k, long long ld, int mn) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  op->mn = mn;
  const cuuint64_t dims[2] = {(cuuint64_t)(mn ? rows : k),
                              (cuuint64_t)(mn ? k : rows)};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)(mn ? kBK : kBM)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(&op->map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The [B, S, H, D] bf16 view at `ptr` (strides in elements; D a multiple
// of 64) as a 4-D map with 64 x 64 boxes; false if the driver refuses.
inline bool make_operand4(Operand4* op, const void* ptr, int B, int S, int H,
                          int D, long long sb, long long ss, long long sh) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  // outer dimensions by increasing stride: 0 = S, 1 = H, 2 = B
  const long long stride[3] = {ss, sh, sb};
  const int extent[3] = {S, H, B};
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (stride[order[j]] < stride[order[i]]) {
        const int t = order[i];
        order[i] = order[j];
        order[j] = t;
      }
  cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  int* pos[3] = {&op->pos_s, &op->pos_h, &op->pos_b};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)extent[order[i]];
    strides[i] = (cuuint64_t)stride[order[i]] * sizeof(bf16);
    box[i + 1] = order[i] == 0 ? 64 : 1;
    *pos[order[i]] = i + 1;
  }
  return encode(&op->map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

}  // namespace sm90
