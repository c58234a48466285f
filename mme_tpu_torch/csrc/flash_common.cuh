// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the 64-row tile geometry, the shared-memory tile loader, the mma.sync
// m16n8k16 wrapper and the two warp-level tile products every kernel body is
// built from. Everything is per translation unit (anonymous namespace).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockQ = 64;       // query rows per tile
constexpr int kBlockK = 64;       // keys per shared-memory tile
constexpr int kWarps = kBlockQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPStride = kBlockK + 4;  // fp32 path: row pitch of a staged tile
constexpr float kLseMasked = 1e30f;

using bf16 = __nv_bfloat16;

// Shared-memory row padding in elements: keeps every row 16-byte aligned
// and moves consecutive rows to different banks.
template <typename T> struct RowPad;
template <> struct RowPad<bf16> { static constexpr int value = 8; };
template <> struct RowPad<float> { static constexpr int value = 4; };

template <typename T, int D>
struct Pitch { static constexpr int value = D + RowPad<T>::value; };

// Copy `rows` (<= 64) rows of D elements, `row_stride` elements apart, into
// a 64-row shared tile; rows past `rows` are zero-filled. 16-byte vectors.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row_stride, int rows,
                                          int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  constexpr int P = Pitch<T, D>::value;
  for (int i = tid; i < kBlockK * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * P + c) = val;
  }
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16; `lo` lands in the low half, which mma
// reads as the lower k (or column) index.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Fragment ownership (the mma.sync m16n8k16 accumulator layout, kept for
// fp32 too): lane = 4 g + t owns rows g and g + 8 of its warp's 16 rows
// and, in every 8-wide column block j, columns 8 j + 2 t and 8 j + 2 t + 1.
// Element e of a 4-vector is row g + 8 (e >> 1), column 8 j + 2 t + (e & 1).

// acc[16 x 64] += A[16 x D] B[64 x D]^T. `a_s` is the warp's first row of a
// shared tile, `b_s` a whole 64-row shared tile; both are contracted along
// their rows' D elements. bf16: tensor cores; fp32: FMAs.
template <typename T, int D>
__device__ __forceinline__ void mm_nt(float (&acc)[8][4], const T* a_s,
                                      const T* b_s, int g, int t) {
  constexpr int P = Pitch<T, D>::value;
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const T* r0 = a_s + g * P + kk * 16 + 2 * t;
      const T* r8 = r0 + 8 * P;
      const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(r0),
                             *reinterpret_cast<const uint32_t*>(r8),
                             *reinterpret_cast<const uint32_t*>(r0 + 8),
                             *reinterpret_cast<const uint32_t*>(r8 + 8)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const T* br = b_s + (j * 8 + g) * P + kk * 16 + 2 * t;
        mma_16816(acc[j], a, *reinterpret_cast<const uint32_t*>(br),
                  *reinterpret_cast<const uint32_t*>(br + 8));
      }
    }
  } else {
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
}

// acc[16 x D] += X[16 x 64] B[64 x D], X held in registers in the
// accumulator layout and contracted along its columns, `b_s` a whole 64-row
// shared tile contracted along its rows. bf16: X is rounded to bf16 and its
// fragments serve as the A operand as they are. fp32: X goes through the
// warp's own `stage` tile (16 x kPStride floats), since the contraction
// needs columns that other lanes hold.
template <typename T, int D>
__device__ __forceinline__ void mm_nn(float (&acc)[D / 8][4],
                                      const float (&x)[8][4], const T* b_s,
                                      float* stage, int g, int t) {
  constexpr int P = Pitch<T, D>::value;
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                             pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                             pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                             pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const T* bc = b_s + (kk * 16 + 2 * t) * P + n * 8 + g;
        mma_16816(acc[n], a, pack_raw(bc[0], bc[P]),
                  pack_raw(bc[8 * P], bc[9 * P]));
      }
    }
  } else {
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
}

}  // namespace
