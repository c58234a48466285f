// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// bf16 (the model's path): tiles of [B, S, H, D] views come in by TMA
// (sm90_gemm.cuh), 64 x 64 boxes under the 128-byte swizzle, and every
// product is a wgmma. A tile of `rows` rows and D columns is stored as D / 64
// boxes of `rows` x 128 bytes, one after the other, so the same tile serves
// as a K-major operand (rows contracted over D: S = Q K^T) and as an
// MN-major one (rows contracted: O = P V, dV = P^T dO).
//
// fp32 (the check legs): 64-row tiles staged in shared memory by the
// threads and two warp-level FMA tile products, exact to fp32 rounding (no
// TF32).
//
// Everything is per translation unit (anonymous namespace).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace {

constexpr float kLseMasked = 1e30f;   // LSE of a row whose every score is -inf
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// ================================ bf16 =================================

constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Bytes of a `rows` x D bf16 tile, and of one 64-wide box of it.
template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) { return rows * D * 2; }
__host__ __device__ constexpr int box_bytes(int rows) { return rows * 128; }
__host__ __device__ constexpr int round_kb(int bytes) {
  return (bytes + 1023) / 1024 * 1024;
}

// TMA loads of rows s0 .. s0 + rows - 1 of head h, batch row b, all D
// columns, into the tile at `dst`; tile_bytes<D>(rows) arrive on `bar`.
template <int D>
__device__ __forceinline__ void load_rows(const sm90::Operand4& op,
                                          uint32_t dst, uint32_t bar,
                                          int rows, int s0, int h, int b) {
#pragma unroll
  for (int hd = 0; hd < D / 64; ++hd)
    for (int rc = 0; rc < rows / 64; ++rc)
      sm90::load_box(op, dst + hd * box_bytes(rows) + rc * box_bytes(64), bar,
                     64 * hd, s0 + 64 * rc, h, b);
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values rounded to bf16; `lo` lands in the low half, which the
// tensor cores read as the lower k (or column) index.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 16 K fp32 accumulator rounded to bf16 as the A fragments of K
// wgmma steps: the accumulator's rows and columns are the A operand's rows
// and depth, with no data moving between threads.
template <int K>
__device__ __forceinline__ void to_frags(const float (&s)[8 * K],
                                         uint32_t (&f)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// Store a warpgroup's 64 x D accumulator, times `mul`, as bf16 rows
// row0 + 16 w + g (+ 8) of a [S, H, D] slice, rows below `limit` only.
template <int D>
__device__ __forceinline__ void store_acc(bf16* base, long long row_stride,
                                          int row0, int limit,
                                          const float (&acc)[D / 2],
                                          float mul, int w, int g, int q) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * w + g + 8 * r;
    if (row >= limit) continue;
    bf16* out = base + (long long)row * row_stride + 2 * q;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The two consumer groups take turns at issuing their products (named
// barriers 2 and 3): a group waits for its turn, issues, and hands the turn
// over, so one group's softmax runs while the other's products hold the
// tensor cores.
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(2 + cw) : "memory");
}
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(3 - cw) : "memory");
}

// Raise a kernel's dynamic shared memory limit once per device.
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  static unsigned done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (done >> dev & 1u))) return err;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

// ================================ fp32 =================================

constexpr int kBlockQ = 64;       // query rows per tile
constexpr int kBlockK = 64;       // keys per shared-memory tile
constexpr int kWarps = kBlockQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPStride = kBlockK + 4;  // row pitch of a staged tile

// Row pitch of a shared tile: 4 floats of padding keep every row 16-byte
// aligned and move consecutive rows to different banks.
template <int D> struct Pitch { static constexpr int value = D + 4; };

// Copy `rows` (<= 64) rows of D floats, `row_stride` elements apart, into
// a 64-row shared tile; rows past `rows` are zero-filled. 16-byte vectors.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int rows,
                                          int tid) {
  constexpr int kVecPerRow = D / 4;
  constexpr int P = Pitch<D>::value;
  for (int i = tid; i < kBlockK * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) val = *reinterpret_cast<const float4*>(src + r * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * P + c) = val;
  }
}

// Fragment ownership (the mma.sync m16n8k16 accumulator layout, kept for
// the fp32 FMA kernels): lane = 4 g + t owns rows g and g + 8 of its warp's
// 16 rows and, in every 8-wide column block j, columns 8 j + 2 t and
// 8 j + 2 t + 1. Element e of a 4-vector is row g + 8 (e >> 1), column
// 8 j + 2 t + (e & 1).

// acc[16 x 64] += A[16 x D] B[64 x D]^T. `a_s` is the warp's first row of a
// shared tile, `b_s` a whole 64-row shared tile; both are contracted along
// their rows' D elements.
template <int D>
__device__ __forceinline__ void mm_nt(float (&acc)[8][4], const float* a_s,
                                      const float* b_s, int g, int t) {
  constexpr int P = Pitch<D>::value;
  for (int d = 0; d < D; ++d) {
    const float a_lo = a_s[g * P + d], a_hi = a_s[(g + 8) * P + d];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b_a = b_s[(j * 8 + 2 * t) * P + d];
      const float b_b = b_s[(j * 8 + 2 * t + 1) * P + d];
      acc[j][0] = fmaf(a_lo, b_a, acc[j][0]);
      acc[j][1] = fmaf(a_lo, b_b, acc[j][1]);
      acc[j][2] = fmaf(a_hi, b_a, acc[j][2]);
      acc[j][3] = fmaf(a_hi, b_b, acc[j][3]);
    }
  }
}

// acc[16 x D] += X[16 x 64] B[64 x D], X held in registers in the
// accumulator layout and contracted along its columns, `b_s` a whole 64-row
// shared tile contracted along its rows. X goes through the warp's own
// `stage` tile (16 x kPStride floats), since the contraction needs columns
// that other lanes hold.
template <int D>
__device__ __forceinline__ void mm_nn(float (&acc)[D / 8][4],
                                      const float (&x)[8][4], const float* b_s,
                                      float* stage, int g, int t) {
  constexpr int P = Pitch<D>::value;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      stage[(g + 8 * (e >> 1)) * kPStride + j * 8 + 2 * t + (e & 1)] = x[j][e];
  __syncwarp();
  for (int c = 0; c < kBlockK; ++c) {
    const float x_lo = stage[g * kPStride + c];
    const float x_hi = stage[(g + 8) * kPStride + c];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float b_a = b_s[c * P + n * 8 + 2 * t];
      const float b_b = b_s[c * P + n * 8 + 2 * t + 1];
      acc[n][0] = fmaf(x_lo, b_a, acc[n][0]);
      acc[n][1] = fmaf(x_lo, b_b, acc[n][1]);
      acc[n][2] = fmaf(x_hi, b_a, acc[n][2]);
      acc[n][3] = fmaf(x_hi, b_b, acc[n][3]);
    }
  }
  __syncwarp();
}

}  // namespace
