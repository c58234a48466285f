// Fused transformer MLP for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels mme_tpu/ops/fused_mlp.py::_fwd_kernel (:105) and
// ::_bwd_kernel (:116). It computes the same functions, not those kernels'
// blocks:
//
//   forward   h = x W1^T + b1,  a = act(h),  out = a W2^T + b2
//   backward  h, a recomputed from x;  da = dO W2,  dh = da * act'(h)
//             dx = dh W1,  dW1 = dh^T x,  dW2 = dO^T a,
//             db1 = sum_rows dh,  db2 = sum_rows dO
//
// x, out, dO, dx are [N, H] (row stride given, unit last stride); W1 is
// [F, H] and W2 is [H, F], torch's [out, in] layout, contiguous; b1 [F] and
// b2 [H] are fp32. Every product takes operands in x's type (bf16 or fp32)
// and sums in fp32; `a` and `dh` are rounded to x's type before the
// products that consume them, the activation and its derivative are
// evaluated in fp32, db1 sums the unrounded dh. No atomics: every output
// element is written once, and two runs give the same bits.
//
// Bound: forward 4 N H F flops, backward 10 N H F, against the bytes of x,
// the weights and the outputs; at every model shape the tensor cores bound
// it (video, N = 11 712, H = 768, F = 3072: 0.112 ms forward and 0.279 ms
// backward at 989 TFLOP/s).
//
// bf16: every product runs on wgmma from operands that TMA brings into a
// ring of shared-memory stages (sm90_gemm.cuh), in persistent blocks of one
// producer and two consumer warpgroups, one block per SM, each walking
// 128 x 128 output tiles. The [N, F] intermediates go through device memory
// as bf16 transients that live for one call, which lets every product tile
// its own output and fill the card (the on-chip chain of the first design
// ran 18 to 366 blocks of 32 rows and re-read both weights per block):
//  - forward, two launches of mlp_gemm: a = act(x W1^T + b1) into the
//    transient (bias and activation in the epilogue, fp32), then
//    out = a W2^T + b2;
//  - backward, two launches: mlp_dual computes h = x W1^T and da = dO W2
//    side by side over H for each (128 rows, 128 columns of F) tile and
//    writes a and dh (bf16) and one fp32 row of column sums of the
//    unrounded dh per 128 rows (summed by the caller, like db2 from dO);
//    then one grouped mlp_gemm launch runs dW1 = dh^T x, dW2 = dO^T a
//    (contracting N) and dx = dh W1 as one list of tiles, longest first.
// Operands keep their layout in device memory: K-major or MN-major per
// product, read through wgmma's transpose bits. On an H100 80GB HBM3 at
// 700 W (time_fused_mlp.py), the video shape's forward takes 0.33 ms (340
// TFLOP/s: fc1 285, fc2 460) and its backward 0.75 ms (368 TFLOP/s:
// mlp_dual 300, the grouped products 515); the short-K launches with the
// heavier epilogues (fc1, mlp_dual) are the slower ones.
//
// fp32: wgmma would take fp32 only as TF32, so fp32 keeps the FMA kernels
// of the first design (mlp_fwd, mlp_bwd_dx, mlp_bwd_dw): the fragment
// layout of mma.sync m16n8k16 computed with FMAs, the [N, F] intermediates
// one 64- or 32-column chunk at a time in registers and shared memory.
//  - mlp_fwd: one block of 8 warps per 16 rows with the x tile resident; it
//    walks F in chunks of 64 (h_c over k-tiles of W1, bias and activation,
//    a_c through shared memory, out += a_c W2[:, c]^T in 256-column
//    slices of H, the accumulator in registers).
//  - mlp_bwd_dx: the same tiling with x and dO resident; per chunk it
//    recomputes h_c, forms da_c and dh_c and adds dh_c W1[c] to its rows.
//  - mlp_bwd_dw: one block per (32 columns of F, 256 columns of H) keeps
//    its tiles of dW1 and dW2 in registers and walks all rows; the H/256
//    blocks that share 32 columns of F form a thread-block cluster and add
//    their partial h_c and da_c through distributed shared memory, in rank
//    order.

#include <cooperative_groups.h>

#include <algorithm>

#include "sm90_gemm.cuh"

namespace coop = cooperative_groups;

namespace {

using sm90::bf16;

enum Act { kGelu = 0, kGeluNew = 1, kRelu = 2, kTanh = 3 };

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

// f(x) and f'(x) together, sharing the transcendental function.
__device__ __forceinline__ void act_fdf(float x, int act, float& f,
                                        float& df) {
  switch (act) {
    case kGelu: {
      const float cdf = 0.5f * (1.f + erff(x * 0.70710678118654752f));
      f = x * cdf;
      df = cdf + x * expf(-0.5f * x * x) * 0.3989422804014327f;
      return;
    }
    case kGeluNew: {
      const float c = 0.7978845608028654f;
      const float th = tanhf(c * (x + 0.044715f * x * x * x));
      f = 0.5f * x * (1.f + th);
      df = 0.5f * (1.f + th) +
           0.5f * x * (1.f - th * th) * c * (1.f + 3.f * 0.044715f * x * x);
      return;
    }
    case kRelu:
      f = fmaxf(x, 0.f);
      df = x > 0.f ? 1.f : 0.f;
      return;
    default: {
      f = tanhf(x);
      df = 1.f - f * f;
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ============================ bf16: wgmma path ============================

using sm90::kBK;
using sm90::kBM;
using sm90::kBN;
using sm90::kHalfBytes;
using sm90::kTileBytes;

constexpr int kDualStages = 3;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
using DualRing = sm90::Ring<kDualStages, 4 * kTileBytes>;

constexpr int kGemmStages = 5;
using GemmRing = sm90::Ring<kGemmStages, 2 * kTileBytes>;

// One product C[m, n] = A B of a grouped launch, stored as bf16 with an
// optional fp32 bias per column (the launch's template argument picks the
// activation, if any).
struct Problem {
  sm90::Operand a, b;
  bf16* out;
  const float* bias;
  long long ld_out;
  int m, n, k;
  int tiles_n;
  int tile_end;        // one past this problem's last tile in the launch
};

struct GemmParams {
  Problem prob[3];
  int count;
};

__device__ __forceinline__ const Problem& problem_of(const GemmParams& p,
                                                     int t, int& local) {
  int q = 0;
  while (q + 1 < p.count && t >= p.prob[q].tile_end) ++q;
  local = t - (q ? p.prob[q - 1].tile_end : 0);
  return p.prob[q];
}

// The consumer warpgroup's 64 rows of one tile: nk stages from iteration
// `it`. One product group stays in flight; a stage is released as soon as
// the products that read it have finished.
template <int TA, int TB>
__device__ __forceinline__ void gemm_mainloop(float (&acc)[64],
                                              const GemmRing& ring, int it,
                                              int nk, int cw) {
  sm90::fence_regs(acc);
  for (int kt = 0; kt < nk; ++kt) {
    sm90::bar_wait(ring.full(it + kt), ring.parity(it + kt));
    __syncwarp();
    const uint32_t st = ring.stage(it + kt);
    sm90::wg_fence();
    sm90::mma_stage<TA, TB>(acc, st + cw * kHalfBytes, st + kTileBytes);
    sm90::wg_commit();
    sm90::wg_wait<1>();
    if (kt > 0) sm90::bar_arrive(ring.empty(it + kt - 1));
  }
  sm90::wg_wait<0>();
  sm90::fence_regs(acc);
  sm90::bar_arrive(ring.empty(it + nk - 1));
}

// Grouped bf16 product: the 128 x 128 tiles of up to three problems in one
// list, walked by persistent blocks in steps of the grid; ACT < 0: no
// activation, and only K-major operands with one.
// Both consumer warpgroups work on every tile, 64 rows each, so every
// stage feeds 128 rows (giving each group whole tiles in turn, from rings
// of their own, measured slower: 3 stages per ring instead of 5, and half
// the blocks idle where a product has fewer tiles than twice the SMs;
// tiles of 128 x 256 measured level and were taken out). The
// activation is a template argument so that the unrolled epilogue holds
// one function's code, not four.
template <int ACT>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    mlp_gemm(const __grid_constant__ GemmParams p) {
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const GemmRing ring{sm90::aligned_smem_base(smem_tiles)};
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  const int total = p.prob[p.count - 1].tile_end;

  if (threadIdx.x < 128) {                 // producer warpgroup
    sm90::regs_dec<kProducerRegs>();
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      int local;
      const Problem& pr = problem_of(p, t, local);
      const int m0 = local / pr.tiles_n * kBM, n0 = local % pr.tiles_n * kBN;
      for (int k0 = 0; k0 < pr.k; k0 += kBK, ++it) {
        const uint32_t st = ring.acquire(it, 2 * kTileBytes);
        sm90::load_tile(pr.a, st, ring.full(it), m0, k0);
        sm90::load_tile(pr.b, st + kTileBytes, ring.full(it), n0, k0);
      }
    }
    return;
  }

  sm90::regs_inc<kConsumerRegs>();
  const int ct = threadIdx.x - 128, cw = ct / 128;
  const int lane = ct % 32;
  const int row_in = 64 * cw + 16 * ((ct % 128) / 32) + lane / 4;
  const int col_in = 2 * (lane % 4);
  int it = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    int local;
    const Problem& pr = problem_of(p, t, local);
    const int m0 = local / pr.tiles_n * kBM, n0 = local % pr.tiles_n * kBN;
    const int nk = (pr.k + kBK - 1) / kBK;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    if constexpr (ACT >= 0) {
      gemm_mainloop<0, 0>(acc, ring, it, nk, cw);
    } else if (pr.a.mn) {
      if (pr.b.mn) gemm_mainloop<1, 1>(acc, ring, it, nk, cw);
      else gemm_mainloop<1, 0>(acc, ring, it, nk, cw);
    } else {
      if (pr.b.mn) gemm_mainloop<0, 1>(acc, ring, it, nk, cw);
      else gemm_mainloop<0, 0>(acc, ring, it, nk, cw);
    }
    it += nk;

#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = n0 + 8 * j + col_in;
      float bias0 = 0.f, bias1 = 0.f;
      if (pr.bias != nullptr) {
        if (c < pr.n) bias0 = pr.bias[c];
        if (c + 1 < pr.n) bias1 = pr.bias[c + 1];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + row_in + 8 * h;
        if (r >= pr.m || c >= pr.n) continue;
        float v0 = acc[4 * j + 2 * h] + bias0;
        float v1 = acc[4 * j + 2 * h + 1] + bias1;
        if constexpr (ACT >= 0) {
          v0 = act_f(v0, ACT);
          v1 = act_f(v1, ACT);
        }
        bf16* o = pr.out + (long long)r * pr.ld_out + c;
        if (c + 1 < pr.n) *reinterpret_cast<uint32_t*>(o) = pack_bf16(v0, v1);
        else *o = __float2bfloat16_rn(v0);
      }
    }
  }
}

// The backward's first pass: per (128 rows, 128 columns of F) tile, h and
// da over all of H side by side, then a, dh and the column sums of dh.
struct DualParams {
  sm90::Operand x, w1, d_o, w2;   // x, dO, W1 K-major; W2 MN-major
  const float* b1;
  bf16* a;                        // [N, F]
  bf16* dh;                       // [N, F]
  float* db1_rows;                // [ceil(N / 128), F]
  int n, f, h, tiles_n, tiles;
};

constexpr size_t kDualRedBytes = 8 * kBN * sizeof(float);

template <int ACT>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    mlp_dual(const __grid_constant__ DualParams p) {
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const DualRing ring{sm90::aligned_smem_base(smem_tiles)};
  // column sums of the eight consumer warps, [8][kBN]
  float* red = reinterpret_cast<float*>(
      smem_tiles + (ring.base - sm90::smem_u32(smem_tiles)) +
      DualRing::bytes());
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x < 128) {
    sm90::regs_dec<kProducerRegs>();
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int m0 = t / p.tiles_n * kBM, n0 = t % p.tiles_n * kBN;
      for (int k0 = 0; k0 < p.h; k0 += kBK, ++it) {
        const uint32_t st = ring.acquire(it, 4 * kTileBytes);
        const uint32_t full = ring.full(it);
        sm90::load_tile(p.x, st, full, m0, k0);
        sm90::load_tile(p.w1, st + kTileBytes, full, n0, k0);
        sm90::load_tile(p.d_o, st + 2 * kTileBytes, full, m0, k0);
        sm90::load_tile(p.w2, st + 3 * kTileBytes, full, n0, k0);
      }
    }
    return;
  }

  sm90::regs_inc<kConsumerRegs>();
  const int ct = threadIdx.x - 128, cw = ct / 128, warp = ct / 32;
  const int lane = ct % 32;
  const int row_in = 64 * cw + 16 * (warp % 4) + lane / 4;
  const int col_in = 2 * (lane % 4);
  const int nk = p.h / kBK;
  int it = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, it += nk) {
    const int tm = t / p.tiles_n;
    const int m0 = tm * kBM, n0 = t % p.tiles_n * kBN;
    float hacc[64], dacc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) hacc[i] = dacc[i] = 0.f;
    sm90::fence_regs(hacc);
    sm90::fence_regs(dacc);
    for (int kt = 0; kt < nk; ++kt) {
      sm90::bar_wait(ring.full(it + kt), ring.parity(it + kt));
      __syncwarp();
      const uint32_t st = ring.stage(it + kt);
      sm90::wg_fence();
      sm90::mma_stage<0, 0>(hacc, st + cw * kHalfBytes, st + kTileBytes);
      sm90::mma_stage<0, 1>(dacc, st + 2 * kTileBytes + cw * kHalfBytes,
                            st + 3 * kTileBytes);
      sm90::wg_commit();
      sm90::wg_wait<1>();
      if (kt > 0) sm90::bar_arrive(ring.empty(it + kt - 1));
    }
    sm90::wg_wait<0>();
    sm90::fence_regs(hacc);
    sm90::fence_regs(dacc);
    sm90::bar_arrive(ring.empty(it + nk - 1));

    // Rows past N read zeros from x and dO: da = 0 there, so dh = 0 and
    // they add nothing to the column sums.
    float csum[16][2];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = n0 + 8 * j + col_in;      // F is a multiple of 64
      const bool in = c < p.f;
      const float bias0 = in ? p.b1[c] : 0.f, bias1 = in ? p.b1[c + 1] : 0.f;
      csum[j][0] = csum[j][1] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float h0 = hacc[4 * j + 2 * h] + bias0;
        const float h1 = hacc[4 * j + 2 * h + 1] + bias1;
        float a0, a1, df0, df1;
        act_fdf(h0, ACT, a0, df0);
        act_fdf(h1, ACT, a1, df1);
        const float d0 = dacc[4 * j + 2 * h] * df0;
        const float d1 = dacc[4 * j + 2 * h + 1] * df1;
        csum[j][0] += d0;
        csum[j][1] += d1;
        const int r = m0 + row_in + 8 * h;
        if (r < p.n && in) {
          const long long off = (long long)r * p.f + c;
          *reinterpret_cast<uint32_t*>(p.a + off) =
              pack_bf16(a0, a1);
          *reinterpret_cast<uint32_t*>(p.dh + off) = pack_bf16(d0, d1);
        }
      }
    }
    // sum over the warp's 16 rows (lanes that share lane % 4), then over
    // the eight warps in a fixed order
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        float v = csum[j][b];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 4) red[warp * kBN + 8 * j + col_in + b] = v;
      }
    sm90::consumers_sync();
    if (ct < kBN && n0 + ct < p.f) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) v += red[w * kBN + ct];
      p.db1_rows[(long long)tm * p.f + n0 + ct] = v;
    }
    sm90::consumers_sync();               // `red` is free for the next tile
  }
}

size_t dual_smem() { return 1024 + DualRing::bytes() + kDualRedBytes; }

// One product C[m, n] = A[m, k] B[k, n] as the host describes it: A is
// [m][k] in memory (row stride lda) when K-major, [k][m] when MN-major; B
// is [n][k] when K-major, [k][n] when MN-major; C is [m][n], row stride
// ld_out, plus an optional fp32 bias per column.
struct GemmSpec {
  const void* a;
  long long lda;
  int a_mn;
  const void* b;
  long long ldb;
  int b_mn;
  void* out;
  long long ld_out;
  const float* bias;
  int m, n, k;
};

bool add_problem(GemmParams* p, const GemmSpec& s) {
  Problem& pr = p->prob[p->count];
  if (!sm90::make_operand(&pr.a, s.a, s.m, s.k, s.lda, s.a_mn) ||
      !sm90::make_operand(&pr.b, s.b, s.n, s.k, s.ldb, s.b_mn))
    return false;
  pr.out = static_cast<bf16*>(s.out);
  pr.bias = s.bias;
  pr.ld_out = s.ld_out;
  pr.m = s.m; pr.n = s.n; pr.k = s.k;
  pr.tiles_n = (s.n + kBN - 1) / kBN;
  const int begin = p->count ? p->prob[p->count - 1].tile_end : 0;
  pr.tile_end = begin + (s.m + kBM - 1) / kBM * pr.tiles_n;
  ++p->count;
  return true;
}

template <typename K, typename P>
int launch_persistent(K kernel, const P& params, int tiles, size_t smem,
                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<std::min(tiles, sm90::sm_count()), sm90::kThreads, smem,
           stream>>>(params);
  return (int)cudaGetLastError();
}

// One grouped launch of `count` products (act < 0: none).
int run_gemm(const GemmSpec* specs, int count, int act, cudaStream_t stream) {
  GemmParams p = {};
  for (int i = 0; i < count; ++i) {
    if (act >= 0 && (specs[i].a_mn || specs[i].b_mn))
      return (int)cudaErrorInvalidValue;
    if (!add_problem(&p, specs[i])) return (int)cudaErrorInvalidValue;
  }
  const int tiles = p.prob[count - 1].tile_end;
  const size_t smem = 1024 + GemmRing::bytes();
  switch (act) {
    case kGelu:
      return launch_persistent(mlp_gemm<kGelu>, p, tiles, smem, stream);
    case kGeluNew:
      return launch_persistent(mlp_gemm<kGeluNew>, p, tiles, smem, stream);
    case kRelu:
      return launch_persistent(mlp_gemm<kRelu>, p, tiles, smem, stream);
    case kTanh:
      return launch_persistent(mlp_gemm<kTanh>, p, tiles, smem, stream);
    default:
      return launch_persistent(mlp_gemm<-1>, p, tiles, smem, stream);
  }
}

int launch_dual(const DualParams& p, int act, cudaStream_t stream) {
  const size_t smem = dual_smem();
  switch (act) {
    case kGelu:
      return launch_persistent(mlp_dual<kGelu>, p, p.tiles, smem, stream);
    case kGeluNew:
      return launch_persistent(mlp_dual<kGeluNew>, p, p.tiles, smem, stream);
    case kRelu:
      return launch_persistent(mlp_dual<kRelu>, p, p.tiles, smem, stream);
    default:
      return launch_persistent(mlp_dual<kTanh>, p, p.tiles, smem, stream);
  }
}

// ============================ fp32: FMA path ============================

constexpr int kMlpThreads = 256;
constexpr int kMlpWarps = 8;
constexpr int kPad = 4;        // shared row padding, floats
constexpr int kFc = 64;        // columns of F per chunk (fwd, dx)
constexpr int kSlice = 256;    // columns of H per accumulator slice
constexpr int kFcW = 32;       // columns of F per dW block
constexpr int kRg = 1;         // 16-row groups per block (fwd, dx)
constexpr int kRgW = 2;        // 16-row groups per block (dW)
constexpr int kKt = 128;       // k-tile of the staged weights (fwd, dx)

struct MlpParams {
  const float* x;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  const float* d_o;    // backward only
  float* out;          // forward: out; dx kernel: dx
  float* dw1;
  float* dw2;
  float* db1;
  float* db2;
  int N, H, F, act;
  long long x_stride, do_stride, out_stride;
};

// Copy `rows` rows of COLS floats, `stride` apart, into a shared tile of row
// pitch `pitch`; rows from `valid` on are zero-filled.
template <int COLS>
__device__ __forceinline__ void stage(float* dst, int pitch, const float* src,
                                      long long stride, int rows, int valid,
                                      int tid) {
  constexpr int kVecPerRow = COLS / 4;
  for (int i = tid; i < rows * kVecPerRow; i += kMlpThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid)
      val = *reinterpret_cast<const float4*>(src + (long long)r * stride + c);
    *reinterpret_cast<float4*>(dst + r * pitch + c) = val;
  }
}

// The three warp-level products, in the mma.sync m16n8k16 accumulator
// layout computed with FMAs: lane 4 g + t owns rows g and g + 8 of each
// 16-row tile i and columns 2 t, 2 t + 1 of each 8-wide block j.

// acc[16 MT x 8 NB] += A[16 MT x K] B[8 NB x K]^T: `a` and `b` point at the
// warp's first row of each operand, both contracted along their rows.
template <int MT, int NB, int K>
__device__ __forceinline__ void mlp_nt(float (&acc)[MT][NB][4], const float* a,
                                       int pa, const float* b, int pb, int g,
                                       int t) {
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

// acc[16 MT x 8 NB] += A[16 MT x K] B[K x 8 NB]: `a` as in mlp_nt, `b`
// points at the warp's first column of a tile whose rows are contracted.
template <int MT, int NB, int K>
__device__ __forceinline__ void mlp_nn(float (&acc)[MT][NB][4], const float* a,
                                       int pa, const float* b, int pb, int g,
                                       int t) {
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

// acc[16 MT x 8 NB] += A^T B with A[K x 16 MT] and B[K x 8 NB]: `a` and `b`
// point at the warp's first column of tiles whose rows are contracted.
template <int MT, int NB, int K>
__device__ __forceinline__ void mlp_tn(float (&acc)[MT][NB][4], const float* a,
                                       int pa, const float* b, int pb, int g,
                                       int t) {
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
template <int NB>
__device__ __forceinline__ void store_tile(float* base, long long stride,
                                           int row, int limit, int col0,
                                           const float (&acc)[NB][4],
                                           const float* bias, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + g + 8 * r;
    if (rr >= limit) continue;
    float* out = base + (long long)rr * stride + col0;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int c = j * 8 + 2 * t;
      float x0 = acc[j][2 * r], x1 = acc[j][2 * r + 1];
      if (bias != nullptr) {
        x0 += bias[col0 + c];
        x1 += bias[col0 + c + 1];
      }
      *reinterpret_cast<float2*>(out + c) = make_float2(x0, x1);
    }
  }
}

// Shared-memory sizes in floats.
__host__ __device__ constexpr int w_elems_fwd() {
  return kFc * (kKt + kPad) > kSlice * (kFc + kPad) ? kFc * (kKt + kPad)
                                                    : kSlice * (kFc + kPad);
}
__host__ __device__ constexpr int w_elems_dx() {
  constexpr int a = w_elems_fwd() > kKt * (kFc + kPad) ? w_elems_fwd()
                                                       : kKt * (kFc + kPad);
  return a > kFc * (kSlice + kPad) ? a : kFc * (kSlice + kPad);
}
size_t smem_fwd(int H) {
  return sizeof(float) * ((size_t)16 * kRg * (H + kPad) + w_elems_fwd() +
                          16 * kRg * (kFc + kPad));
}
size_t smem_dx(int H) {
  return sizeof(float) * ((size_t)2 * 16 * kRg * (H + kPad) + w_elems_dx() +
                          16 * kRg * (kFc + kPad));
}

// h_c = x_tile W1[c]^T for the warp's rows and columns of one 64-column
// chunk: W1 k-tiles staged through `w_s`.
template <int NB1>
__device__ __forceinline__ void chunk_h(float (&hacc)[1][NB1][4],
                                        const float* x_w, int px,
                                        const float* w1_c, int H, float* w_s,
                                        int cg, int g, int t, int tid) {
  constexpr int PW = kKt + kPad;
  zero_acc(hacc);
  for (int k0 = 0; k0 < H; k0 += kKt) {
    __syncthreads();                       // w_s is free
    stage<kKt>(w_s, PW, w1_c + k0, H, kFc, kFc, tid);
    __syncthreads();
    mlp_nt<1, NB1, kKt>(hacc, x_w + k0, px, w_s + cg * 8 * NB1 * PW, PW, g,
                        t);
  }
}

template <int NS>
__global__ void __launch_bounds__(kMlpThreads) mlp_fwd(const MlpParams p) {
  constexpr int CG = kMlpWarps / kRg, BM = 16 * kRg;
  constexpr int NB1 = kFc / (8 * CG), NB2 = kSlice / (8 * CG);
  constexpr int H = NS * kSlice;
  constexpr int PX = H + kPad, PA = kFc + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* x_s = reinterpret_cast<float*>(smem_raw);
  float* w_s = x_s + BM * PX;
  float* a_s = w_s + w_elems_fwd();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp / CG, cg = warp % CG;
  const int row0 = blockIdx.x * BM;
  const int valid = min(BM, p.N - row0);

  stage<H>(x_s, PX, p.x + row0 * p.x_stride, p.x_stride, BM, valid, tid);
  float acc[NS][1][NB2][4];
#pragma unroll
  for (int s = 0; s < NS; ++s) zero_acc(acc[s]);

  for (int c0 = 0; c0 < p.F; c0 += kFc) {
    float hacc[1][NB1][4];
    chunk_h<NB1>(hacc, x_s + rg * 16 * PX, PX, p.w1 + (long long)c0 * H, H,
                 w_s, cg, g, t, tid);
#pragma unroll
    for (int j = 0; j < NB1; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cg * 8 * NB1 + j * 8 + 2 * t + (e & 1);
        const int row = rg * 16 + g + 8 * (e >> 1);
        a_s[row * PA + col] = act_f(hacc[0][j][e] + p.b1[c0 + col], p.act);
      }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      __syncthreads();                     // a_s written, w_s free
      stage<kFc>(w_s, PA, p.w2 + (long long)s * kSlice * p.F + c0, p.F,
                 kSlice, kSlice, tid);
      __syncthreads();
      mlp_nt<1, NB2, kFc>(acc[s], a_s + rg * 16 * PA, PA,
                          w_s + cg * 8 * NB2 * PA, PA, g, t);
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
    store_tile<NB2>(p.out, p.out_stride, row0 + rg * 16, p.N,
                    s * kSlice + cg * 8 * NB2, acc[s][0], p.b2, g, t);
}

template <int NS>
__global__ void __launch_bounds__(kMlpThreads) mlp_bwd_dx(const MlpParams p) {
  constexpr int CG = kMlpWarps / kRg, BM = 16 * kRg;
  constexpr int NB1 = kFc / (8 * CG), NB2 = kSlice / (8 * CG);
  constexpr int H = NS * kSlice;
  constexpr int PX = H + kPad, PA = kFc + kPad, PS = kSlice + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* x_s = reinterpret_cast<float*>(smem_raw);
  float* do_s = x_s + BM * PX;
  float* w_s = do_s + BM * PX;
  float* dh_s = w_s + w_elems_dx();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp / CG, cg = warp % CG;
  const int row0 = blockIdx.x * BM;
  const int valid = min(BM, p.N - row0);

  stage<H>(x_s, PX, p.x + row0 * p.x_stride, p.x_stride, BM, valid, tid);
  stage<H>(do_s, PX, p.d_o + row0 * p.do_stride, p.do_stride, BM, valid, tid);
  float acc[NS][1][NB2][4];
#pragma unroll
  for (int s = 0; s < NS; ++s) zero_acc(acc[s]);

  for (int c0 = 0; c0 < p.F; c0 += kFc) {
    float hacc[1][NB1][4], da[1][NB1][4];
    chunk_h<NB1>(hacc, x_s + rg * 16 * PX, PX, p.w1 + (long long)c0 * H, H,
                 w_s, cg, g, t, tid);
    zero_acc(da);                          // da_c = dO W2[:, c]
    for (int k0 = 0; k0 < H; k0 += kKt) {
      __syncthreads();
      stage<kFc>(w_s, PA, p.w2 + (long long)k0 * p.F + c0, p.F, kKt, kKt,
                 tid);
      __syncthreads();
      mlp_nn<1, NB1, kKt>(da, do_s + rg * 16 * PX + k0, PX,
                          w_s + cg * 8 * NB1, PA, g, t);
    }
#pragma unroll
    for (int j = 0; j < NB1; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cg * 8 * NB1 + j * 8 + 2 * t + (e & 1);
        const int row = rg * 16 + g + 8 * (e >> 1);
        const float h = hacc[0][j][e] + p.b1[c0 + col];
        dh_s[row * PA + col] = da[0][j][e] * act_df(h, p.act);
      }
#pragma unroll
    for (int s = 0; s < NS; ++s) {         // dx += dh_c W1[c]
      __syncthreads();                     // dh_s written, w_s free
      stage<kSlice>(w_s, PS, p.w1 + (long long)c0 * H + s * kSlice, H, kFc,
                    kFc, tid);
      __syncthreads();
      mlp_nn<1, NB2, kFc>(acc[s], dh_s + rg * 16 * PA, PA,
                          w_s + cg * 8 * NB2, PS, g, t);
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
    store_tile<NB2>(p.out, p.out_stride, row0 + rg * 16, p.N,
                    s * kSlice + cg * 8 * NB2, acc[s][0], nullptr, g, t);
}

// dW kernel: resident W1 and W2 tiles, the x and dO slices of one row tile,
// a_c and dh_c, and two exchange buffers of partial h and da.
constexpr size_t smem_dw() {
  constexpr int BM = 16 * kRgW;
  return sizeof(float) * ((size_t)kFcW * (kSlice + kPad) +
                          kSlice * (kFcW + kPad) + 2 * BM * (kSlice + kPad) +
                          2 * BM * (kFcW + kPad) + 2 * 2 * BM * kFcW);
}

// One block per (32 columns of F, 256 columns of H); the NS blocks that
// share the 32 columns of F form one cluster (cluster dims (1, NS, 1), so a
// block's rank is its blockIdx.y). Per row tile each block computes the
// part of h_c and da_c that contracts its own 256 columns of H, publishes
// it in its shared memory, and after a cluster barrier every block adds up
// the NS parts in rank order (so all of them hold the same bits).
template <int NS>
__global__ void __launch_bounds__(kMlpThreads) mlp_bwd_dw(const MlpParams p) {
  constexpr int CG = kMlpWarps / kRgW, BM = 16 * kRgW;
  constexpr int NBR = kFcW / (8 * CG);     // column blocks of h_c per warp
  constexpr int PF = kFcW + kPad, PS = kSlice + kPad;
  constexpr int kPart = BM * kFcW;         // one partial tile, in floats
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w1_s = reinterpret_cast<float*>(smem_raw);  // W1[c0 : +32, h0 : +256]
  float* w2_s = w1_s + kFcW * PS;                    // W2[h0 : +256, c0 : +32]
  float* xs_s = w2_s + kSlice * PF;                  // x[rows, h0 : +256]
  float* dos_s = xs_s + BM * PS;                     // dO[rows, h0 : +256]
  float* a_s = dos_s + BM * PS;
  float* dh_s = a_s + BM * PF;
  float* ex = dh_s + BM * PF;                        // [2][2][BM][32]
  coop::cluster_group cluster = coop::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp / CG, cg_ = warp % CG;
  const int c0 = blockIdx.x * kFcW, h0 = blockIdx.y * kSlice;
  const int H = p.H;

  stage<kSlice>(w1_s, PS, p.w1 + (long long)c0 * H + h0, H, kFcW, kFcW, tid);
  stage<kFcW>(w2_s, PF, p.w2 + (long long)h0 * p.F + c0, p.F, kSlice, kSlice,
              tid);

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
    stage<kSlice>(xs_s, PS, p.x + m0 * p.x_stride + h0, p.x_stride, BM, valid,
                  tid);
    stage<kSlice>(dos_s, PS, p.d_o + m0 * p.do_stride + h0, p.do_stride, BM,
                  valid, tid);
    __syncthreads();
    float hacc[1][NBR][4], da[1][NBR][4];
    zero_acc(hacc);
    zero_acc(da);
    mlp_nt<1, NBR, kSlice>(hacc, xs_s + rg * 16 * PS, PS,
                           w1_s + cg_ * 8 * NBR * PS, PS, g, t);
    mlp_nn<1, NBR, kSlice>(da, dos_s + rg * 16 * PS, PS, w2_s + cg_ * 8 * NBR,
                           PF, g, t);
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
        a_s[row * PF + col] = act_f(h, p.act);
        dh_s[row * PF + col] = dh;
        db1[j][e & 1] += dh;
      }
    __syncthreads();
    // dW1 += dh_c^T x[:, slice],  dW2 += dO[:, slice]^T a_c
    mlp_tn<1, 8, BM>(dw1, dh_s + (warp / 4) * 16, PF, xs_s + (warp % 4) * 64,
                     PS, g, t);
    mlp_tn<2, 4, BM>(dw2, dos_s + warp * 32, PS, a_s, PF, g, t);
    if (blockIdx.x == 0) {
      for (int r = 0; r < BM; ++r) db2 += dos_s[r * PS + tid];
    }
  }
  cluster.sync();     // no block leaves while its parts may still be read

  store_tile<8>(p.dw1, H, c0 + (warp / 4) * 16, p.F, h0 + (warp % 4) * 64,
                dw1[0], nullptr, g, t);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    store_tile<4>(p.dw2, p.F, h0 + warp * 32 + i * 16, H, c0, dw2[i], nullptr,
                  g, t);
  if (blockIdx.x == 0) p.db2[h0 + tid] = db2;
  if (blockIdx.y == 0) {
    // this lane's columns, summed over the lanes that share t (rows g) and
    // then over the row groups through shared memory
    float* red = ex;                                 // [kRgW][32]
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
      for (int r = 0; r < kRgW; ++r) v += red[r * kFcW + tid];
      p.db1[c0 + tid] = v;
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NS>
int launch_fwd_f32(const MlpParams& p, cudaStream_t stream) {
  constexpr int BM = 16 * kRg;
  const size_t smem = smem_fwd(p.H);
  cudaError_t err = allow_smem(mlp_fwd<NS>, smem);
  if (err != cudaSuccess) return (int)err;
  mlp_fwd<NS><<<(p.N + BM - 1) / BM, kMlpThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int NS>
int launch_bwd_f32(const MlpParams& p, float* dx, long long dx_stride,
                   cudaStream_t stream) {
  constexpr int BM = 16 * kRg;
  MlpParams q = p;
  q.out = dx;
  q.out_stride = dx_stride;
  const size_t smem = smem_dx(p.H);
  cudaError_t err = allow_smem(mlp_bwd_dx<NS>, smem);
  if (err != cudaSuccess) return (int)err;
  mlp_bwd_dx<NS><<<(p.N + BM - 1) / BM, kMlpThreads, smem, stream>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(mlp_bwd_dw<NS>, smem_dw());
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.F / kFcW, NS);
  cfg.blockDim = dim3(kMlpThreads);
  cfg.dynamicSmemBytes = smem_dw();
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = NS;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mlp_bwd_dw<NS>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool supported(int N, int H, int F, int act) {
  return N > 0 && H > 0 && H % kSlice == 0 && H <= 4 * kSlice && F > 0 &&
         F % kFc == 0 && act >= 0 && act <= 3;
}

}  // namespace

// Every function returns a cudaError_t value: 0 when every launch was
// accepted, cudaErrorInvalidValue for a shape outside the kernels' range
// (H a multiple of 256 up to 1024, F a multiple of 64) or operands TMA
// cannot describe. The caller checks types, contiguity and 16-byte
// alignment before calling. Strides are in elements.

// The bf16 product C[m, n] = A[m, k] B[k, n] alone (the core of the bf16
// path), C row-major with row stride ldc. a_mn / b_mn say how A and B are
// stored (see add_problem).
extern "C" int mme_gemm_bf16(const void* a, const void* b, void* c, int m,
                             int n, int k, int a_mn, int b_mn, long long lda,
                             long long ldb, long long ldc, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const GemmSpec s = {a, lda, a_mn, b, ldb, b_mn, c, ldc, nullptr, m, n, k};
  return run_gemm(&s, 1, -1, static_cast<cudaStream_t>(stream));
}

// Forward. bf16 goes through `a_buf` ([N, F], contiguous), fp32 ignores it.
extern "C" int mme_mlp_fwd(const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, void* a_buf,
                           void* out, int N, int H, int F, int act,
                           int is_bf16, long long x_stride,
                           long long out_stride, void* stream) {
  if (!supported(N, H, F, act)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const GemmSpec fc1 = {x, x_stride, 0, w1, H, 0, a_buf, F,
                          static_cast<const float*>(b1), N, F, H};
    const GemmSpec fc2 = {a_buf, F, 0, w2, F, 0, out, out_stride,
                          static_cast<const float*>(b2), N, H, F};
    const int err = run_gemm(&fc1, 1, act, st);
    return err != 0 ? err : run_gemm(&fc2, 1, -1, st);
  }
  MlpParams p = {};
  p.x = static_cast<const float*>(x);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const float*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<float*>(out);
  p.N = N; p.H = H; p.F = F; p.act = act;
  p.x_stride = x_stride;
  p.out_stride = out_stride;
  switch (H / kSlice) {
    case 1: return launch_fwd_f32<1>(p, st);
    case 2: return launch_fwd_f32<2>(p, st);
    case 3: return launch_fwd_f32<3>(p, st);
    default: return launch_fwd_f32<4>(p, st);
  }
}

// Backward. bf16: `a_buf` and `dh_buf` are [N, F] transients, db1 receives
// ceil(N / 128) rows of F partial sums and db2 is left to the caller (the
// column sums of dO); fp32 writes db1 and db2 and ignores the transients.
extern "C" int mme_mlp_bwd(const void* x, const void* w1, const void* b1,
                           const void* w2, const void* d_o, void* a_buf,
                           void* dh_buf, void* dx, void* dw1, void* dw2,
                           void* db1, void* db2, int N, int H, int F, int act,
                           int is_bf16, long long x_stride,
                           long long do_stride, long long dx_stride,
                           void* stream) {
  if (!supported(N, H, F, act)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    DualParams d = {};
    if (!sm90::make_operand(&d.x, x, N, H, x_stride, 0) ||
        !sm90::make_operand(&d.w1, w1, F, H, H, 0) ||
        !sm90::make_operand(&d.d_o, d_o, N, H, do_stride, 0) ||
        !sm90::make_operand(&d.w2, w2, F, H, F, 1))
      return (int)cudaErrorInvalidValue;
    d.b1 = static_cast<const float*>(b1);
    d.a = static_cast<bf16*>(a_buf);
    d.dh = static_cast<bf16*>(dh_buf);
    d.db1_rows = static_cast<float*>(db1);
    d.n = N; d.f = F; d.h = H;
    d.tiles_n = (F + kBN - 1) / kBN;
    d.tiles = (N + kBM - 1) / kBM * d.tiles_n;
    // the products that contract N (long) first, then dx
    const GemmSpec g[3] = {
        {dh_buf, F, 1, x, x_stride, 1, dw1, H, nullptr, F, H, N},
        {d_o, do_stride, 1, a_buf, F, 1, dw2, F, nullptr, H, F, N},
        {dh_buf, F, 0, w1, H, 1, dx, dx_stride, nullptr, N, H, F}};
    const int err = launch_dual(d, act, st);
    return err != 0 ? err : run_gemm(g, 3, -1, st);
  }
  MlpParams p = {};
  p.x = static_cast<const float*>(x);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const float*>(w2);
  p.d_o = static_cast<const float*>(d_o);
  p.dw1 = static_cast<float*>(dw1);
  p.dw2 = static_cast<float*>(dw2);
  p.db1 = static_cast<float*>(db1);
  p.db2 = static_cast<float*>(db2);
  p.N = N; p.H = H; p.F = F; p.act = act;
  p.x_stride = x_stride;
  p.do_stride = do_stride;
  float* dxf = static_cast<float*>(dx);
  switch (H / kSlice) {
    case 1: return launch_bwd_f32<1>(p, dxf, dx_stride, st);
    case 2: return launch_bwd_f32<2>(p, dxf, dx_stride, st);
    case 3: return launch_bwd_f32<3>(p, dxf, dx_stride, st);
    default: return launch_bwd_f32<4>(p, dxf, dx_stride, st);
  }
}
