// Fused transformer MLP for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels mme_tpu/ops/fused_mlp.py::_fwd_kernel and
// ::_bwd_kernel. It computes the same functions, not those kernels' blocks:
//
//   forward   h = x W1^T + b1,  a = act(h),  out = a W2^T + b2
//   backward  h, a recomputed from x;  da = dO W2,  dh = da * act'(h)
//             dx = dh W1,  dW1 = dh^T x,  dW2 = dO^T a,
//             db1 = sum_rows dh,  db2 = sum_rows dO
//
// x, out, dO, dx are [N, H] (row stride given, unit last stride); W1 is
// [F, H] and W2 is [H, F], torch's [out, in] layout, contiguous; b1 [F] and
// b2 [H] are fp32. The type T of x, the weights, out, dx, dW1 and dW2 is
// bf16 or fp32. Every product takes T operands and sums in fp32; `a` and
// `dh` are rounded to T before the products that consume them, the
// activation and its derivative are evaluated in fp32, db1 sums the
// unrounded dh. The [N, F] intermediates h, a, da, dh never reach device
// memory: they live one 64- or 32-column chunk at a time in registers and
// shared memory.
//
// Design: three kernels, no atomics, every output element written once.
//  - mlp_fwd: one block of 8 warps per tile of rows (32 in bf16, 16 in
//    fp32) with the x tile resident in shared memory. It walks F in chunks
//    of 64: h_c = x W1[c]^T over k-tiles of W1 staged through shared
//    memory, bias and activation on the accumulator fragments, a_c through
//    shared memory (each warp owns a column group of h_c and needs every
//    column of a_c), then out += a_c W2[:, c]^T in 256-column slices of H,
//    the [rows, H] accumulator in registers across the 8 warps.
//  - mlp_bwd_dx: the same row tiling with x and dO tiles resident; per
//    chunk it recomputes h_c, computes da_c = dO W2[:, c], forms dh_c and
//    adds dh_c W1[c] to its dx rows (accumulator in registers). It owns its
//    dx rows: the sum over F is a loop inside the block.
//  - mlp_bwd_dw: dW1, dW2 and the bias gradients sum over rows, which the
//    other grid spreads over blocks. One block per (32 columns of F, 256
//    columns of H) keeps its [32, 256] tile of dW1 and [256, 32] tile of
//    dW2 in registers, its tiles of W1 and W2 in shared memory, and walks
//    all row tiles. Recomputing h_c and da_c for its 32 columns of F needs
//    the whole of H, which one block does not hold: the H/256 blocks that
//    share those columns form a thread-block cluster, each contracts its
//    own 256 columns of H from the x and dO slices it stages anyway, and
//    the partial sums are exchanged through distributed shared memory and
//    added in rank order. No work is done twice but the activation, and
//    the result is deterministic without fp32 scratch in device memory. The
//    TPU kernel keeps both whole [H, F] accumulators in VMEM along a
//    sequential grid, which has no counterpart here. Rows past N are
//    zero-filled in x and dO, so they add nothing (dO = 0 gives da = dh = 0).
// The weights are never transposed in device memory: products that contract
// a tile's rows load their fragments transposed (ldmatrix.trans in mlp_nn
// and mlp_tn); every bf16 fragment comes from shared memory through ldmatrix. bf16 products run on mma.sync m16n8k16 with fp32
// accumulation; fp32 keeps the same fragment ownership with FMAs (no TF32).
//
// Bound: forward 4 N H F flops, backward 10 N H F, against the bytes of x,
// the weights and the outputs; every model shape is bound by the tensor
// cores. Right first: no TMA, no wgmma, no pipelined loads, one block per
// SM at the widest shapes.

#include <cooperative_groups.h>

#include "flash_common.cuh"

namespace coop = cooperative_groups;

namespace {

constexpr int kMlpThreads = 256;
constexpr int kMlpWarps = 8;
constexpr int kFc = 64;        // columns of F per chunk (fwd, dx)
constexpr int kSlice = 256;    // columns of H per accumulator slice
constexpr int kFcW = 32;       // columns of F per dW block

enum Act { kGelu = 0, kGeluNew = 1, kRelu = 2, kTanh = 3 };

// Per type: row groups of 16 in the row-tiled kernels (rg) and in the dW
// kernel (rg_w), and the k-tile in which the forward and dx kernels stage
// the weights against their resident x and dO tiles (kt).
template <typename T> struct Cfg;
template <> struct Cfg<bf16> {
  static constexpr int rg = 2, rg_w = 4, kt = 256;
};
template <> struct Cfg<float> {
  static constexpr int rg = 1, rg_w = 2, kt = 128;
};

template <typename T> __host__ __device__ constexpr int pad() {
  return RowPad<T>::value;
}

struct MlpParams {
  const void* x;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  const void* d_o;     // backward only
  void* out;           // forward: out; dx kernel: dx
  void* dw1;
  void* dw2;
  float* db1;
  float* db2;
  int N, H, F, act;
  long long x_stride, do_stride, out_stride;
};

__device__ __forceinline__ float act_f(float x, int act) {
  switch (act) {
    case kGelu:
      return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
    case kGeluNew: {
      const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
      return 0.5f * x * (1.f + tanhf(u));
    }
    case kRelu:
      return fmaxf(x, 0.f);
    default:
      return tanhf(x);
  }
}

__device__ __forceinline__ float act_df(float x, int act) {
  switch (act) {
    case kGelu: {
      const float cdf = 0.5f * (1.f + erff(x * 0.70710678118654752f));
      const float pdf = expf(-0.5f * x * x) * 0.3989422804014327f;
      return cdf + x * pdf;
    }
    case kGeluNew: {
      const float c = 0.7978845608028654f;
      const float u = c * (x + 0.044715f * x * x * x);
      const float th = tanhf(u);
      const float du = c * (1.f + 3.f * 0.044715f * x * x);
      return 0.5f * (1.f + th) + 0.5f * x * (1.f - th * th) * du;
    }
    case kRelu:
      return x > 0.f ? 1.f : 0.f;
    default: {
      const float th = tanhf(x);
      return 1.f - th * th;
    }
  }
}

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}

// Copy `rows` rows of COLS elements, `stride` elements apart, into a shared
// tile of row pitch `pitch`; rows from `valid` on are zero-filled.
template <typename T, int COLS>
__device__ __forceinline__ void stage(T* dst, int pitch, const T* src,
                                      long long stride, int rows, int valid,
                                      int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = COLS / kVec;
  for (int i = tid; i < rows * kVecPerRow; i += kMlpThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      val = *reinterpret_cast<const uint4*>(src + (long long)r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * pitch + c) = val;
  }
}

// Four 8x8 bf16 matrices from shared memory into fragment registers: lane l
// gives the address of row l % 8 of matrix l / 8 (16 bytes, 16-byte
// aligned); lane 4 g + t receives from matrix q, in register q, the
// elements [g][2 t], [g][2 t + 1], or with `trans` [2 t][g], [2 t + 1][g].
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Fragment loads of the bf16 products (NB is even there). With l = 4 g + t,
// lo = l % 8 + 8 ((l / 8) % 2) and hi = 8 (l / 16):
//  - A tile stored [m][k]: matrices (m lo, k lo), (m hi, k lo), (m lo, k hi),
//    (m hi, k hi) are the a0..a3 of mma.m16n8k16;
//  - A tile stored [k][m], transposed on load: (k lo, m lo), (k lo, m hi),
//    (k hi, m lo), (k hi, m hi), again a0..a3;
//  - B tile stored [n][k]: (n j, k lo), (n j, k hi), (n j + 1, k lo),
//    (n j + 1, k hi) are b0, b1 of column block j and of j + 1;
//  - B tile stored [k][n], transposed on load: (k lo, n j), (k hi, n j),
//    (k lo, n j + 1), (k hi, n j + 1), the same four.
__device__ __forceinline__ void a_frag_mk(uint32_t (&af)[4], const bf16* a,
                                          int pa, int i, int kk, int l) {
  ldsm4(af, a + (i * 16 + l % 8 + 8 * ((l / 8) % 2)) * pa + kk * 16 +
                8 * (l / 16));
}

__device__ __forceinline__ void a_frag_km(uint32_t (&af)[4], const bf16* a,
                                          int pa, int i, int kk, int l) {
  ldsm4_trans(af, a + (kk * 16 + l % 8 + 8 * (l / 16)) * pa + i * 16 +
                      8 * ((l / 8) % 2));
}

__device__ __forceinline__ void b_frag_nk(uint32_t (&bf)[4], const bf16* b,
                                          int pb, int j, int kk, int l) {
  ldsm4(bf, b + ((j + l / 16) * 8 + l % 8) * pb + kk * 16 +
                8 * ((l / 8) % 2));
}

__device__ __forceinline__ void b_frag_kn(uint32_t (&bf)[4], const bf16* b,
                                          int pb, int j, int kk, int l) {
  ldsm4_trans(bf, b + (kk * 16 + l % 8 + 8 * ((l / 8) % 2)) * pb +
                      (j + l / 16) * 8);
}

// The three warp-level products. Fragment ownership is the mma.sync
// m16n8k16 accumulator layout (see flash_common.cuh): lane 4 g + t owns rows
// g and g + 8 of each 16-row tile i and columns 2 t, 2 t + 1 of each 8-wide
// block j.

// acc[16 MT x 8 NB] += A[16 MT x K] B[8 NB x K]^T: `a` and `b` point at the
// warp's first row of each operand, both contracted along their rows.
template <typename T, int MT, int NB, int K>
__device__ __forceinline__ void mlp_nt(float (&acc)[MT][NB][4], const T* a,
                                      int pa, const T* b, int pb, int g,
                                      int t) {
  if constexpr (std::is_same<T, bf16>::value) {
    static_assert(NB % 2 == 0, "bf16 products load two column blocks at once");
    const int l = 4 * g + t;
#pragma unroll 4
    for (int kk = 0; kk < K / 16; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) a_frag_mk(af[i], a, pa, i, kk, l);
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        uint32_t bf[4];
        b_frag_nk(bf, b, pb, j, kk, l);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_16816(acc[i][j], af[i], bf[0], bf[1]);
          mma_16816(acc[i][j + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  } else {
#pragma unroll 4
    for (int d = 0; d < K; ++d) {
      float lo[MT], hi[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        lo[i] = a[(i * 16 + g) * pa + d];
        hi[i] = a[(i * 16 + g + 8) * pa + d];
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float b_a = b[(j * 8 + 2 * t) * pb + d];
        const float b_b = b[(j * 8 + 2 * t + 1) * pb + d];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          acc[i][j][0] = fmaf(lo[i], b_a, acc[i][j][0]);
          acc[i][j][1] = fmaf(lo[i], b_b, acc[i][j][1]);
          acc[i][j][2] = fmaf(hi[i], b_a, acc[i][j][2]);
          acc[i][j][3] = fmaf(hi[i], b_b, acc[i][j][3]);
        }
      }
    }
  }
}

// acc[16 MT x 8 NB] += A[16 MT x K] B[K x 8 NB]: `a` as in mlp_nt, `b`
// points at the warp's first column of a tile whose rows are contracted.
template <typename T, int MT, int NB, int K>
__device__ __forceinline__ void mlp_nn(float (&acc)[MT][NB][4], const T* a,
                                      int pa, const T* b, int pb, int g,
                                      int t) {
  if constexpr (std::is_same<T, bf16>::value) {
    static_assert(NB % 2 == 0, "bf16 products load two column blocks at once");
    const int l = 4 * g + t;
#pragma unroll 4
    for (int kk = 0; kk < K / 16; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) a_frag_mk(af[i], a, pa, i, kk, l);
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        uint32_t bf[4];
        b_frag_kn(bf, b, pb, j, kk, l);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_16816(acc[i][j], af[i], bf[0], bf[1]);
          mma_16816(acc[i][j + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  } else {
#pragma unroll 4
    for (int d = 0; d < K; ++d) {
      float lo[MT], hi[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        lo[i] = a[(i * 16 + g) * pa + d];
        hi[i] = a[(i * 16 + g + 8) * pa + d];
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float b_a = b[d * pb + j * 8 + 2 * t];
        const float b_b = b[d * pb + j * 8 + 2 * t + 1];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          acc[i][j][0] = fmaf(lo[i], b_a, acc[i][j][0]);
          acc[i][j][1] = fmaf(lo[i], b_b, acc[i][j][1]);
          acc[i][j][2] = fmaf(hi[i], b_a, acc[i][j][2]);
          acc[i][j][3] = fmaf(hi[i], b_b, acc[i][j][3]);
        }
      }
    }
  }
}

// acc[16 MT x 8 NB] += A^T B with A[K x 16 MT] and B[K x 8 NB]: `a` and `b`
// point at the warp's first column of tiles whose rows are contracted.
template <typename T, int MT, int NB, int K>
__device__ __forceinline__ void mlp_tn(float (&acc)[MT][NB][4], const T* a,
                                      int pa, const T* b, int pb, int g,
                                      int t) {
  if constexpr (std::is_same<T, bf16>::value) {
    static_assert(NB % 2 == 0, "bf16 products load two column blocks at once");
    const int l = 4 * g + t;
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) a_frag_km(af[i], a, pa, i, kk, l);
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        uint32_t bf[4];
        b_frag_kn(bf, b, pb, j, kk, l);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_16816(acc[i][j], af[i], bf[0], bf[1]);
          mma_16816(acc[i][j + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  } else {
#pragma unroll 4
    for (int d = 0; d < K; ++d) {
      float lo[MT], hi[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        lo[i] = a[d * pa + i * 16 + g];
        hi[i] = a[d * pa + i * 16 + g + 8];
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float b_a = b[d * pb + j * 8 + 2 * t];
        const float b_b = b[d * pb + j * 8 + 2 * t + 1];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          acc[i][j][0] = fmaf(lo[i], b_a, acc[i][j][0]);
          acc[i][j][1] = fmaf(lo[i], b_b, acc[i][j][1]);
          acc[i][j][2] = fmaf(hi[i], b_a, acc[i][j][2]);
          acc[i][j][3] = fmaf(hi[i], b_b, acc[i][j][3]);
        }
      }
    }
  }
}

template <int MT, int NB>
__device__ __forceinline__ void zero_acc(float (&x)[MT][NB][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[i][j][e] = 0.f;
}

// Store rows `row + g` and `row + g + 8` (where < limit) of one 16-row
// accumulator tile, columns col0 + 8 j + 2 t (+1), plus an optional bias.
template <typename T, int NB>
__device__ __forceinline__ void store_tile(T* base, long long stride, int row,
                                           int limit, int col0,
                                           const float (&acc)[NB][4],
                                           const float* bias, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + g + 8 * r;
    if (rr >= limit) continue;
    T* out = base + (long long)rr * stride + col0;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int c = j * 8 + 2 * t;
      float x0 = acc[j][2 * r], x1 = acc[j][2 * r + 1];
      if (bias != nullptr) {
        x0 += bias[col0 + c];
        x1 += bias[col0 + c + 1];
      }
      if constexpr (std::is_same<T, bf16>::value) {
        *reinterpret_cast<uint32_t*>(out + c) = pack_bf16(x0, x1);
      } else {
        *reinterpret_cast<float2*>(out + c) = make_float2(x0, x1);
      }
    }
  }
}

// Shared-memory sizes in elements of T.
template <typename T> __host__ __device__ constexpr int w_elems_fwd() {
  constexpr int a = kFc * (Cfg<T>::kt + pad<T>());        // W1 k-tile
  constexpr int b = kSlice * (kFc + pad<T>());            // W2 slice
  return a > b ? a : b;
}
template <typename T> __host__ __device__ constexpr int w_elems_dx() {
  constexpr int a = w_elems_fwd<T>() > Cfg<T>::kt * (kFc + pad<T>())
                        ? w_elems_fwd<T>() : Cfg<T>::kt * (kFc + pad<T>());
  constexpr int b = kFc * (kSlice + pad<T>());            // W1 chunk slice
  return a > b ? a : b;
}
template <typename T> size_t smem_fwd(int H) {
  return sizeof(T) * ((size_t)16 * Cfg<T>::rg * (H + pad<T>()) +
                      w_elems_fwd<T>() +
                      16 * Cfg<T>::rg * (kFc + pad<T>()));
}
template <typename T> size_t smem_dx(int H) {
  return sizeof(T) * ((size_t)2 * 16 * Cfg<T>::rg * (H + pad<T>()) +
                      w_elems_dx<T>() + 16 * Cfg<T>::rg * (kFc + pad<T>()));
}

// h_c = x_tile W1[c]^T for the warp's rows and columns of one 64-column
// chunk: W1 k-tiles staged through `w_s`.
template <typename T, int NB1>
__device__ __forceinline__ void chunk_h(float (&hacc)[1][NB1][4],
                                        const T* x_w, int px, const T* w1_c,
                                        int H, T* w_s, int cg, int g, int t,
                                        int tid) {
  constexpr int KT = Cfg<T>::kt;
  constexpr int PW = KT + pad<T>();
  zero_acc(hacc);
  for (int k0 = 0; k0 < H; k0 += KT) {
    __syncthreads();                       // w_s is free
    stage<T, KT>(w_s, PW, w1_c + k0, H, kFc, kFc, tid);
    __syncthreads();
    mlp_nt<T, 1, NB1, KT>(hacc, x_w + k0, px, w_s + cg * 8 * NB1 * PW, PW, g,
                         t);
  }
}

template <typename T, int NS>
__global__ void __launch_bounds__(kMlpThreads) mlp_fwd(const MlpParams p) {
  constexpr int RG = Cfg<T>::rg, CG = kMlpWarps / RG, BM = 16 * RG;
  constexpr int NB1 = kFc / (8 * CG), NB2 = kSlice / (8 * CG);
  constexpr int H = NS * kSlice;
  constexpr int PX = H + pad<T>(), PA = kFc + pad<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* x_s = reinterpret_cast<T*>(smem_raw);
  T* w_s = x_s + BM * PX;
  T* a_s = w_s + w_elems_fwd<T>();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp / CG, cg = warp % CG;
  const int row0 = blockIdx.x * BM;
  const int valid = min(BM, p.N - row0);
  const T* w1 = static_cast<const T*>(p.w1);
  const T* w2 = static_cast<const T*>(p.w2);

  stage<T, H>(x_s, PX, static_cast<const T*>(p.x) + row0 * p.x_stride,
              p.x_stride, BM, valid, tid);
  float acc[NS][1][NB2][4];
#pragma unroll
  for (int s = 0; s < NS; ++s) zero_acc(acc[s]);

  for (int c0 = 0; c0 < p.F; c0 += kFc) {
    float hacc[1][NB1][4];
    chunk_h<T, NB1>(hacc, x_s + rg * 16 * PX, PX, w1 + (long long)c0 * H, H,
                    w_s, cg, g, t, tid);
#pragma unroll
    for (int j = 0; j < NB1; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cg * 8 * NB1 + j * 8 + 2 * t + (e & 1);
        const int row = rg * 16 + g + 8 * (e >> 1);
        a_s[row * PA + col] =
            from_float<T>(act_f(hacc[0][j][e] + p.b1[c0 + col], p.act));
      }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      __syncthreads();                     // a_s written, w_s free
      stage<T, kFc>(w_s, PA, w2 + (long long)s * kSlice * p.F + c0, p.F,
                    kSlice, kSlice, tid);
      __syncthreads();
      mlp_nt<T, 1, NB2, kFc>(acc[s], a_s + rg * 16 * PA, PA,
                            w_s + cg * 8 * NB2 * PA, PA, g, t);
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
    store_tile<T, NB2>(static_cast<T*>(p.out), p.out_stride,
                       row0 + rg * 16, p.N, s * kSlice + cg * 8 * NB2,
                       acc[s][0], p.b2, g, t);
}

template <typename T, int NS>
__global__ void __launch_bounds__(kMlpThreads) mlp_bwd_dx(const MlpParams p) {
  constexpr int RG = Cfg<T>::rg, CG = kMlpWarps / RG, BM = 16 * RG;
  constexpr int NB1 = kFc / (8 * CG), NB2 = kSlice / (8 * CG);
  constexpr int H = NS * kSlice, KT = Cfg<T>::kt;
  constexpr int PX = H + pad<T>(), PA = kFc + pad<T>();
  constexpr int PS = kSlice + pad<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* x_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = x_s + BM * PX;
  T* w_s = do_s + BM * PX;
  T* dh_s = w_s + w_elems_dx<T>();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp / CG, cg = warp % CG;
  const int row0 = blockIdx.x * BM;
  const int valid = min(BM, p.N - row0);
  const T* w1 = static_cast<const T*>(p.w1);
  const T* w2 = static_cast<const T*>(p.w2);

  stage<T, H>(x_s, PX, static_cast<const T*>(p.x) + row0 * p.x_stride,
              p.x_stride, BM, valid, tid);
  stage<T, H>(do_s, PX, static_cast<const T*>(p.d_o) + row0 * p.do_stride,
              p.do_stride, BM, valid, tid);
  float acc[NS][1][NB2][4];
#pragma unroll
  for (int s = 0; s < NS; ++s) zero_acc(acc[s]);

  for (int c0 = 0; c0 < p.F; c0 += kFc) {
    float hacc[1][NB1][4], da[1][NB1][4];
    chunk_h<T, NB1>(hacc, x_s + rg * 16 * PX, PX, w1 + (long long)c0 * H, H,
                    w_s, cg, g, t, tid);
    zero_acc(da);                          // da_c = dO W2[:, c]
    for (int k0 = 0; k0 < H; k0 += KT) {
      __syncthreads();
      stage<T, kFc>(w_s, PA, w2 + (long long)k0 * p.F + c0, p.F, KT, KT, tid);
      __syncthreads();
      mlp_nn<T, 1, NB1, KT>(da, do_s + rg * 16 * PX + k0, PX,
                           w_s + cg * 8 * NB1, PA, g, t);
    }
#pragma unroll
    for (int j = 0; j < NB1; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cg * 8 * NB1 + j * 8 + 2 * t + (e & 1);
        const int row = rg * 16 + g + 8 * (e >> 1);
        const float h = hacc[0][j][e] + p.b1[c0 + col];
        dh_s[row * PA + col] = from_float<T>(da[0][j][e] * act_df(h, p.act));
      }
#pragma unroll
    for (int s = 0; s < NS; ++s) {         // dx += dh_c W1[c]
      __syncthreads();                     // dh_s written, w_s free
      stage<T, kSlice>(w_s, PS, w1 + (long long)c0 * H + s * kSlice, H, kFc,
                       kFc, tid);
      __syncthreads();
      mlp_nn<T, 1, NB2, kFc>(acc[s], dh_s + rg * 16 * PA, PA,
                            w_s + cg * 8 * NB2, PS, g, t);
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
    store_tile<T, NB2>(static_cast<T*>(p.out), p.out_stride,
                       row0 + rg * 16, p.N, s * kSlice + cg * 8 * NB2,
                       acc[s][0], nullptr, g, t);
}

// dW kernel: resident W1 and W2 tiles, the x and dO slices of one row tile,
// a_c and dh_c, and two exchange buffers of partial h and da (fp32).
template <typename T> constexpr size_t smem_dw() {
  constexpr int BM = 16 * Cfg<T>::rg_w;
  return sizeof(T) * ((size_t)kFcW * (kSlice + pad<T>()) +
                      kSlice * (kFcW + pad<T>()) +
                      2 * BM * (kSlice + pad<T>()) +
                      2 * BM * (kFcW + pad<T>())) +
         sizeof(float) * 2 * 2 * BM * kFcW;
}

// One block per (32 columns of F, 256 columns of H); the NS blocks that
// share the 32 columns of F form one cluster (cluster dims (1, NS, 1), so a
// block's rank is its blockIdx.y). Per row tile each block computes the
// part of h_c and da_c that contracts its own 256 columns of H, publishes
// it in its shared memory, and after a cluster barrier every block adds up
// the NS parts in rank order (so all of them hold the same bits).
template <typename T, int NS>
__global__ void __launch_bounds__(kMlpThreads) mlp_bwd_dw(const MlpParams p) {
  constexpr int RG = Cfg<T>::rg_w, CG = kMlpWarps / RG, BM = 16 * RG;
  constexpr int NBR = kFcW / (8 * CG);     // column blocks of h_c per warp
  constexpr int PF = kFcW + pad<T>(), PS = kSlice + pad<T>();
  constexpr int kPart = BM * kFcW;         // one partial tile, in floats
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w1_s = reinterpret_cast<T*>(smem_raw);  // W1[c0 : +32, h0 : +256]
  T* w2_s = w1_s + kFcW * PS;                // W2[h0 : +256, c0 : +32]
  T* xs_s = w2_s + kSlice * PF;              // x[rows, h0 : +256]
  T* dos_s = xs_s + BM * PS;                 // dO[rows, h0 : +256]
  T* a_s = dos_s + BM * PS;
  T* dh_s = a_s + BM * PF;
  float* ex = reinterpret_cast<float*>(dh_s + BM * PF);  // [2][2][BM][32]
  coop::cluster_group cluster = coop::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp / CG, cg_ = warp % CG;
  const int c0 = blockIdx.x * kFcW, h0 = blockIdx.y * kSlice;
  const int H = p.H;
  const T* x = static_cast<const T*>(p.x);
  const T* d_o = static_cast<const T*>(p.d_o);

  stage<T, kSlice>(w1_s, PS,
                   static_cast<const T*>(p.w1) + (long long)c0 * H + h0, H,
                   kFcW, kFcW, tid);
  stage<T, kFcW>(w2_s, PF,
                 static_cast<const T*>(p.w2) + (long long)h0 * p.F + c0, p.F,
                 kSlice, kSlice, tid);

  // dW1 tile [32 f, 256 h]: warp -> 16 f rows (warp / 4), 64 h columns
  // (warp % 4). dW2 tile [256 h, 32 f]: warp -> 32 h rows, all 32 columns.
  float dw1[1][8][4], dw2[2][4][4];
  zero_acc(dw1);
  zero_acc(dw2);
  float db1[NBR][2];
#pragma unroll
  for (int j = 0; j < NBR; ++j) db1[j][0] = db1[j][1] = 0.f;
  float db2 = 0.f;

  int it = 0;
  for (int m0 = 0; m0 < p.N; m0 += BM, ++it) {
    const int valid = min(BM, p.N - m0);
    __syncthreads();             // the previous tile's products are done
    stage<T, kSlice>(xs_s, PS, x + m0 * p.x_stride + h0, p.x_stride, BM,
                     valid, tid);
    stage<T, kSlice>(dos_s, PS, d_o + m0 * p.do_stride + h0, p.do_stride, BM,
                     valid, tid);
    __syncthreads();
    float hacc[1][NBR][4], da[1][NBR][4];
    zero_acc(hacc);
    zero_acc(da);
    mlp_nt<T, 1, NBR, kSlice>(hacc, xs_s + rg * 16 * PS, PS,
                              w1_s + cg_ * 8 * NBR * PS, PS, g, t);
    mlp_nn<T, 1, NBR, kSlice>(da, dos_s + rg * 16 * PS, PS,
                              w2_s + cg_ * 8 * NBR, PF, g, t);
    // two exchange buffers in turn: a block may write the next tile's parts
    // while a slower one still reads this tile's, and cannot come back to
    // this buffer before that one has passed the next barrier
    float* mine = ex + (it & 1) * 2 * kPart;
#pragma unroll
    for (int j = 0; j < NBR; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cg_ * 8 * NBR + j * 8 + 2 * t + (e & 1);
        const int row = rg * 16 + g + 8 * (e >> 1);
        mine[row * kFcW + col] = hacc[0][j][e];
        mine[kPart + row * kFcW + col] = da[0][j][e];
      }
    cluster.sync();
    const float* part[NS];
#pragma unroll
    for (int r = 0; r < NS; ++r) part[r] = cluster.map_shared_rank(mine, r);
#pragma unroll
    for (int j = 0; j < NBR; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cg_ * 8 * NBR + j * 8 + 2 * t + (e & 1);
        const int row = rg * 16 + g + 8 * (e >> 1);
        float h = p.b1[c0 + col], d = 0.f;
#pragma unroll
        for (int r = 0; r < NS; ++r) {
          h += part[r][row * kFcW + col];
          d += part[r][kPart + row * kFcW + col];
        }
        const float dh = d * act_df(h, p.act);
        a_s[row * PF + col] = from_float<T>(act_f(h, p.act));
        dh_s[row * PF + col] = from_float<T>(dh);
        db1[j][e & 1] += dh;
      }
    __syncthreads();
    // dW1 += dh_c^T x[:, slice],  dW2 += dO[:, slice]^T a_c
    mlp_tn<T, 1, 8, BM>(dw1, dh_s + (warp / 4) * 16, PF,
                        xs_s + (warp % 4) * 64, PS, g, t);
    mlp_tn<T, 2, 4, BM>(dw2, dos_s + warp * 32, PS, a_s, PF, g, t);
    if (blockIdx.x == 0) {
      for (int r = 0; r < BM; ++r) db2 += to_float(dos_s[r * PS + tid]);
    }
  }
  cluster.sync();     // no block leaves while its parts may still be read

  T* dw1_g = static_cast<T*>(p.dw1);
  T* dw2_g = static_cast<T*>(p.dw2);
  store_tile<T, 8>(dw1_g, H, c0 + (warp / 4) * 16, p.F,
                   h0 + (warp % 4) * 64, dw1[0], nullptr, g, t);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    store_tile<T, 4>(dw2_g, p.F, h0 + warp * 32 + i * 16, H, c0, dw2[i],
                     nullptr, g, t);
  if (blockIdx.x == 0) p.db2[h0 + tid] = db2;
  if (blockIdx.y == 0) {
    // this lane's columns, summed over the lanes that share t (rows g) and
    // then over the row groups through shared memory
    float* red = ex;                                 // [RG][32]
#pragma unroll
    for (int j = 0; j < NBR; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        float v = db1[j][b];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) red[rg * kFcW + cg_ * 8 * NBR + j * 8 + 2 * t + b] = v;
      }
    __syncthreads();
    if (tid < kFcW) {
      float v = 0.f;
      for (int r = 0; r < RG; ++r) v += red[r * kFcW + tid];
      p.db1[c0 + tid] = v;
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int NS>
int launch_fwd(const MlpParams& p, cudaStream_t stream) {
  constexpr int BM = 16 * Cfg<T>::rg;
  const size_t smem = smem_fwd<T>(p.H);
  cudaError_t err = allow_smem(mlp_fwd<T, NS>, smem);
  if (err != cudaSuccess) return (int)err;
  mlp_fwd<T, NS><<<(p.N + BM - 1) / BM, kMlpThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int NS>
int launch_bwd(const MlpParams& p, void* dx, long long dx_stride,
               cudaStream_t stream) {
  constexpr int BM = 16 * Cfg<T>::rg;
  MlpParams q = p;
  q.out = dx;
  q.out_stride = dx_stride;
  const size_t smem = smem_dx<T>(p.H);
  cudaError_t err = allow_smem(mlp_bwd_dx<T, NS>, smem);
  if (err != cudaSuccess) return (int)err;
  mlp_bwd_dx<T, NS><<<(p.N + BM - 1) / BM, kMlpThreads, smem, stream>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(mlp_bwd_dw<T, NS>, smem_dw<T>());
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.F / kFcW, NS);
  cfg.blockDim = dim3(kMlpThreads);
  cfg.dynamicSmemBytes = smem_dw<T>();
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = NS;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mlp_bwd_dw<T, NS>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

MlpParams make_params(const void* x, const void* w1, const void* b1,
                      const void* w2, const void* b2, int N, int H, int F,
                      int act, long long x_stride) {
  MlpParams p = {};
  p.x = x; p.w1 = w1; p.w2 = w2;
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.N = N; p.H = H; p.F = F; p.act = act;
  p.x_stride = x_stride;
  return p;
}

bool supported(int N, int H, int F, int act) {
  return N > 0 && H > 0 && H % kSlice == 0 && H <= 4 * kSlice && F > 0 &&
         F % kFc == 0 && act >= 0 && act <= 3;
}

}  // namespace

// Both functions return a cudaError_t value: 0 when every launch was
// accepted, cudaErrorInvalidValue for a shape outside the kernels' range
// (H a multiple of 256 up to 1024, F a multiple of 64). The caller checks
// types, contiguity and 16-byte alignment before calling. Strides are in
// elements.
extern "C" int mme_mlp_fwd(const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, void* out, int N,
                           int H, int F, int act, int is_bf16,
                           long long x_stride, long long out_stride,
                           void* stream) {
  if (!supported(N, H, F, act)) return (int)cudaErrorInvalidValue;
  MlpParams p = make_params(x, w1, b1, w2, b2, N, H, F, act, x_stride);
  p.out = out;
  p.out_stride = out_stride;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ns = H / kSlice;
  if (is_bf16) {
    if (ns == 1) return launch_fwd<bf16, 1>(p, st);
    if (ns == 2) return launch_fwd<bf16, 2>(p, st);
    if (ns == 3) return launch_fwd<bf16, 3>(p, st);
    return launch_fwd<bf16, 4>(p, st);
  }
  if (ns == 1) return launch_fwd<float, 1>(p, st);
  if (ns == 2) return launch_fwd<float, 2>(p, st);
  if (ns == 3) return launch_fwd<float, 3>(p, st);
  return launch_fwd<float, 4>(p, st);
}

extern "C" int mme_mlp_bwd(const void* x, const void* w1, const void* b1,
                           const void* w2, const void* d_o, void* dx,
                           void* dw1, void* dw2, void* db1, void* db2, int N,
                           int H, int F, int act, int is_bf16,
                           long long x_stride, long long do_stride,
                           long long dx_stride, void* stream) {
  if (!supported(N, H, F, act)) return (int)cudaErrorInvalidValue;
  MlpParams p = make_params(x, w1, b1, w2, nullptr, N, H, F, act, x_stride);
  p.d_o = d_o;
  p.do_stride = do_stride;
  p.dw1 = dw1; p.dw2 = dw2;
  p.db1 = static_cast<float*>(db1);
  p.db2 = static_cast<float*>(db2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ns = H / kSlice;
  if (is_bf16) {
    if (ns == 1) return launch_bwd<bf16, 1>(p, dx, dx_stride, st);
    if (ns == 2) return launch_bwd<bf16, 2>(p, dx, dx_stride, st);
    if (ns == 3) return launch_bwd<bf16, 3>(p, dx, dx_stride, st);
    return launch_bwd<bf16, 4>(p, dx, dx_stride, st);
  }
  if (ns == 1) return launch_bwd<float, 1>(p, dx, dx_stride, st);
  if (ns == 2) return launch_bwd<float, 2>(p, dx, dx_stride, st);
  if (ns == 3) return launch_bwd<float, 3>(p, dx, dx_stride, st);
  return launch_bwd<float, 4>(p, dx, dx_stride, st);
}
