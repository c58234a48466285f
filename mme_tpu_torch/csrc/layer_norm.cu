// LayerNorm forward and backward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels mme_tpu/ops/layer_norm.py:63 _fwd_kernel and
// :73 _bwd_kernel. Over the last axis of x [N, H], with fp32 statistics and
// the fast variance of flax:
//
//   forward   y  = (x - mean) * rstd * scale + bias,
//             rstd = rsqrt(max(0, E[x^2] - mean^2) + eps)
//   backward  xhat = (x - mean) * rstd,  gg = g * scale,
//             dx = rstd * (gg - mean(gg) - xhat * mean(gg * xhat)),
//             dscale = sum over rows of g * xhat,  dbias = sum of g
//
// x, g, y and dx are bf16 or fp32 (y's type may differ from x's, and g's
// too); scale and bias are fp32 or bf16; dscale and dbias are fp32. The
// backward recomputes mean and rstd from x, as the TPU kernel does.
//
// Bound: both kernels are bound by bytes. Per element the forward reads x
// and writes y (4 bytes in bf16) for about 6 fp32 operations, the backward
// reads x and g and writes dx (6 bytes) for about 16: at the card's 3.35
// TB/s and 67 fp32 TFLOP/s the bytes take 5-7 times longer than the
// arithmetic. So the design keeps enough bytes in flight and moves each
// element once:
//
// - Layout. A team of warps takes one row at a time: one warp for H <= 1024
//   (the model's widths), ceil(H / 1024) warps for wider rows, whose
//   partial statistics meet in shared memory. Each thread owns a fixed set
//   of 8-column chunks (one 16-byte vector of bf16, two of fp32): chunk c
//   of the row goes to thread c mod (32 * warps) of the team, at most 4 per
//   thread (3 at H = 768, 4 at 1024, 2 at 512). Nothing is padded to a
//   power of two; only chunks past the row are skipped. Sum and sum of
//   squares are taken in one pass in fp32 and reduced with __shfl_xor_sync.
// - Rows in flight. The grid is persistent: one or two blocks of up to 8
//   warps per SM (one where a team would get fewer than 2 rows), and a
//   team strides over rows. Each team owns a ring of 2 row slots in shared
//   memory that 1-D bulk copies (cp.async.bulk, completing on an mbarrier
//   per slot) fill with x (and g): the first two rows are requested before
//   the block stages its scale and bias, and row r + 1 is on its way while
//   row r is computed, with no register holding it. By Little's law one
//   SM's share of 3.35 TB/s (25 bytes per ns) needs about 25-40 KB in
//   flight at 1-1.5 us of loaded DRAM latency; at H = 768 in bf16, 16 teams
//   keep 24-48 KB of x in flight in the forward and twice that in the
//   backward (x and g). Three or four slots, and several rows per copy,
//   measured no faster on the H100. Rows are re-read from shared memory for
//   each pass, so registers hold only the statistics (and the backward's
//   sums). Outputs go from registers to device memory as 16-byte vectors.
// - The backward's sums. A row's four sums (x, x^2, g * scale and
//   g * scale * x) take one pass and one reduction. Each thread adds
//   g * xhat and g for its own columns over every row its team takes, in
//   registers. At the end the block adds its teams in a fixed order in
//   shared memory and writes one fp32 partial row (dscale, dbias) per
//   block; mme_ln_bwd_reduce, launched by the same entry point, adds those
//   rows in a fixed order. No atomics: the grid depends only on (N, H, SM
//   count), so two runs give the same bits.
//
// The host (ops/layer_norm.py::launch_plan) decides the grid, the team
// shape, the chunks per thread, the ring's slots and the shared memory;
// the kernels take them as they are.

#include "sm90_gemm.cuh"

namespace {

using sm90::bf16;

constexpr int kMaxThreads = 256;       // 8 warps: teams * warps per row
constexpr int kMaxSmem = 232448;       // 227 KB, a block's most
constexpr int kReduceWarps = 16;

struct Params {
  const void* x;       // [n, h]
  const void* g;       // backward: [n, h], the output gradient
  const void* w;       // [h] scale
  const void* b;       // forward: [h] bias
  void* out;           // forward: y [n, h]; backward: dx [n, h]
  float* part;         // backward: [gridDim.x, 2, h] partial sums
  int n, h;
  float eps;
  int w_bf16, b_bf16;
  int teams;           // rows a block takes at once
  int wpr;             // warps per row (team)
  int slots;           // ring slots per team
};

// 8 consecutive elements at element index i (a multiple of 8) of a row
template <int BF>
__device__ __forceinline__ void load8(const void* base, long long i,
                                      float (&v)[8]) {
  if constexpr (BF) {
    const uint4 u =
        *reinterpret_cast<const uint4*>(static_cast<const bf16*>(base) + i);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
    const float4* p =
        reinterpret_cast<const float4*>(static_cast<const float*>(base) + i);
    const float4 a = p[0], c = p[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
  }
}

template <int BF>
__device__ __forceinline__ void store8(void* base, long long i,
                                       const float (&v)[8]) {
  if constexpr (BF) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    *reinterpret_cast<uint4*>(static_cast<bf16*>(base) + i) =
        make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    float4* p = reinterpret_cast<float4*>(static_cast<float*>(base) + i);
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// The warps of one row.
struct Team {
  int id;      // team in the block
  int t;       // thread in the team
  int size;    // 32 * wpr
  int wpr;
};

__device__ __forceinline__ Team make_team(int wpr) {
  Team tm;
  tm.wpr = wpr;
  tm.size = 32 * wpr;
  tm.id = threadIdx.x / tm.size;
  tm.t = threadIdx.x % tm.size;
  return tm;
}

__device__ __forceinline__ void team_sync(const Team& tm) {
  if (tm.wpr == 1) {
    __syncwarp();
  } else {
    // named barriers 1..4 (id 0 is __syncthreads): teams <= 4 when wpr > 1
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + tm.id), "r"(tm.size)
                 : "memory");
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  // every lane ends with the same value: a + b == b + a exactly
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// v summed over the team in one fixed order; `red` holds M * wpr floats of
// this team, written after the previous row's last team barrier
template <int M>
__device__ __forceinline__ void team_sum(const Team& tm, float* red,
                                         float (&v)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) v[i] = warp_sum(v[i]);
  if (tm.wpr == 1) return;
  const int w = tm.t >> 5;
  if ((tm.t & 31) == 0)
#pragma unroll
    for (int i = 0; i < M; ++i) red[M * w + i] = v[i];
  team_sync(tm);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    v[i] = 0.f;
    for (int j = 0; j < tm.wpr; ++j) v[i] += red[M * j + i];
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The block's shared memory, in the order of ops/layer_norm.py::smem_bytes:
// teams x slots row slots, the scale (and the forward's bias) in fp32, 4
// floats of reduction scratch per warp, one mbarrier per slot.
struct Block {
  unsigned char* slots;    // this team's first slot
  float* scale;
  float* bias;
  float* red;              // this team's scratch: 4 floats per warp
  uint32_t bars;           // this team's first mbarrier
  uint32_t slot_bytes;
};

__device__ __forceinline__ Block carve(unsigned char* smem, const Params& p,
                                       const Team& tm, uint32_t slot_bytes,
                                       bool has_bias) {
  Block bl;
  const size_t ring = (size_t)p.teams * p.slots * slot_bytes;
  bl.slot_bytes = slot_bytes;
  bl.slots = smem + (size_t)tm.id * p.slots * slot_bytes;
  bl.scale = reinterpret_cast<float*>(smem + ring);
  bl.bias = has_bias ? bl.scale + p.h : nullptr;
  float* red = bl.scale + (has_bias ? 2 : 1) * p.h;
  bl.red = red + tm.id * 4 * p.wpr;
  bl.bars = sm90::smem_u32(red + p.teams * 4 * p.wpr) + 8u * tm.id * p.slots;
  return bl;
}

// Row `row` of x (and of g) into slot `s` of the team's ring.
__device__ __forceinline__ void fetch(const Params& p, const Block& bl, int s,
                                      int row, uint32_t x_bytes,
                                      uint32_t g_bytes) {
  const uint32_t bar = bl.bars + 8u * s;
  const uint32_t dst = sm90::smem_u32(bl.slots + (size_t)s * bl.slot_bytes);
  sm90::bar_expect(bar, x_bytes + g_bytes);
  bulk_load(dst, static_cast<const unsigned char*>(p.x) + (size_t)row * x_bytes,
            x_bytes, bar);
  if (g_bytes)
    bulk_load(dst + x_bytes,
              static_cast<const unsigned char*>(p.g) + (size_t)row * g_bytes,
              g_bytes, bar);
}

// Each team's leader initialises its slots' mbarriers and starts the copies
// of its first rows; then the block stages the scale (and bias) in shared
// memory as fp32 while those rows are on their way.
__device__ __forceinline__ void block_setup(const Params& p, const Team& tm,
                                            const Block& bl, uint32_t x_bytes,
                                            uint32_t g_bytes) {
  const int stride = gridDim.x * p.teams;
  const int first = blockIdx.x * p.teams + tm.id;
  if (tm.t == 0) {
    for (int i = 0; i < p.slots; ++i) sm90::bar_init(bl.bars + 8u * i, 1);
    sm90::bar_init_fence();
    for (int j = 0; j < p.slots && first + j * stride < p.n; ++j)
      fetch(p, bl, j, first + j * stride, x_bytes, g_bytes);
  }
  for (int i = threadIdx.x; i < p.h; i += blockDim.x) {
    bl.scale[i] = p.w_bf16 ? __bfloat162float(static_cast<const bf16*>(p.w)[i])
                           : static_cast<const float*>(p.w)[i];
    if (bl.bias != nullptr)
      bl.bias[i] = p.b_bf16
                       ? __bfloat162float(static_cast<const bf16*>(p.b)[i])
                       : static_cast<const float*>(p.b)[i];
  }
  __syncthreads();
}

__device__ __forceinline__ void stats(const Params& p, float sum, float sq,
                                      float& mean, float& rstd) {
  mean = sum / (float)p.h;
  const float var = fmaxf(sq / (float)p.h - mean * mean, 0.f);
  rstd = rsqrtf(var + p.eps);
}

// Sum and sum of squares of the team's row in `xs` → mean and rstd.
template <int XBF, int K>
__device__ __forceinline__ void row_stats(const Params& p, const Team& tm,
                                          const void* xs, float* red,
                                          float& mean, float& rstd) {
  const int chunks = p.h >> 3;
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = tm.t + k * tm.size;
    if (c < chunks) {
      float v[8];
      load8<XBF>(xs, 8 * c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sum += v[e];
        sq = fmaf(v[e], v[e], sq);
      }
    }
  }
  float v[2] = {sum, sq};
  team_sum(tm, red, v);
  stats(p, v[0], v[1], mean, rstd);
}

template <int XBF, int YBF, int K>
__global__ void __launch_bounds__(kMaxThreads, 2) mme_ln_fwd(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Team tm = make_team(p.wpr);
  const uint32_t x_bytes = p.h * (XBF ? 2 : 4);
  const Block bl = carve(smem, p, tm, x_bytes, true);
  block_setup(p, tm, bl, x_bytes, 0);
  const int chunks = p.h >> 3;
  const int stride = gridDim.x * p.teams;
  const int first = blockIdx.x * p.teams + tm.id;

  for (int j = 0, r = first; r < p.n; ++j, r += stride) {
    const int s = j % p.slots;
    sm90::bar_wait(bl.bars + 8u * s, (j / p.slots) & 1);
    const void* xs = bl.slots + (size_t)s * bl.slot_bytes;
    float mean, rstd;
    row_stats<XBF, K>(p, tm, xs, bl.red, mean, rstd);
    const long long base = (long long)r * p.h;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = tm.t + k * tm.size;
      if (c < chunks) {
        float v[8], sc[8], bi[8], y[8];
        load8<XBF>(xs, 8 * c, v);
        load8<0>(bl.scale, 8 * c, sc);
        load8<0>(bl.bias, 8 * c, bi);
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = fmaf(v[e] - mean, rstd * sc[e], bi[e]);
        store8<YBF>(p.out, base + 8 * c, y);
      }
    }
    team_sync(tm);                       // every thread is done with slot s
    const int next = r + p.slots * stride;
    if (tm.t == 0 && next < p.n) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fetch(p, bl, s, next, x_bytes, 0);
    }
  }
}

template <int XBF, int GBF, int K>
__global__ void __launch_bounds__(kMaxThreads, 2) mme_ln_bwd(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Team tm = make_team(p.wpr);
  const uint32_t x_bytes = p.h * (XBF ? 2 : 4);
  const uint32_t g_bytes = p.h * (GBF ? 2 : 4);
  const Block bl = carve(smem, p, tm, x_bytes + g_bytes, false);
  block_setup(p, tm, bl, x_bytes, g_bytes);
  const int chunks = p.h >> 3;
  const float inv_h = 1.f / (float)p.h;
  const int stride = gridDim.x * p.teams;
  const int first = blockIdx.x * p.teams + tm.id;

  float ds[K][8], db[K][8];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) ds[k][e] = db[k][e] = 0.f;

  for (int j = 0, r = first; r < p.n; ++j, r += stride) {
    const int s = j % p.slots;
    sm90::bar_wait(bl.bars + 8u * s, (j / p.slots) & 1);
    const unsigned char* xs = bl.slots + (size_t)s * bl.slot_bytes;
    const unsigned char* gs = xs + x_bytes;
    // one pass, one team reduction: sum x, sum x^2, sum gg, sum gg * x;
    // sum gg * xhat = rstd * (sum gg * x - mean * sum gg)
    float v4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = tm.t + k * tm.size;
      if (c < chunks) {
        float v[8], g[8], sc[8];
        load8<XBF>(xs, 8 * c, v);
        load8<GBF>(gs, 8 * c, g);
        load8<0>(bl.scale, 8 * c, sc);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float gg = g[e] * sc[e];
          v4[0] += v[e];
          v4[1] = fmaf(v[e], v[e], v4[1]);
          v4[2] += gg;
          v4[3] = fmaf(gg, v[e], v4[3]);
        }
      }
    }
    team_sum(tm, bl.red, v4);
    float mean, rstd;
    stats(p, v4[0], v4[1], mean, rstd);
    const float s1 = v4[2], s2 = rstd * (v4[3] - mean * v4[2]);
    const float m1 = s1 * inv_h, m2 = s2 * inv_h;
    const long long base = (long long)r * p.h;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = tm.t + k * tm.size;
      if (c < chunks) {
        float v[8], g[8], sc[8], dx[8];
        load8<XBF>(xs, 8 * c, v);
        load8<GBF>(gs, 8 * c, g);
        load8<0>(bl.scale, 8 * c, sc);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xhat = (v[e] - mean) * rstd;
          dx[e] = rstd * (g[e] * sc[e] - m1 - xhat * m2);
          ds[k][e] = fmaf(g[e], xhat, ds[k][e]);
          db[k][e] += g[e];
        }
        store8<XBF>(p.out, base + 8 * c, dx);
      }
    }
    team_sync(tm);                       // every thread is done with slot s
    const int next = r + p.slots * stride;
    if (tm.t == 0 && next < p.n) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fetch(p, bl, s, next, x_bytes, g_bytes);
    }
  }

  // the block's teams in order → one partial row; the ring is free now
  // (every copy issued was waited for) and holds [teams][2][h] fp32
  __syncthreads();
  float* acc = reinterpret_cast<float*>(smem);
  float* mine = acc + (size_t)tm.id * 2 * p.h;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = tm.t + k * tm.size;
    if (c < chunks) {
      store8<0>(mine, 8 * c, ds[k]);
      store8<0>(mine + p.h, 8 * c, db[k]);
    }
  }
  __syncthreads();
  const int cols = 2 * p.h;
  float* out = p.part + (size_t)blockIdx.x * cols;
  for (int i = threadIdx.x; i < cols; i += blockDim.x) {
    float v = acc[i];
    for (int t = 1; t < p.teams; ++t) v += acc[(size_t)t * cols + i];
    out[i] = v;
  }
}

// sums[c] = part[0][c] + part[1][c] + ... in a fixed order: warp w adds
// rows w, w + 16, ..., then warp 0 adds the 16 warps' sums in order.
__global__ void __launch_bounds__(kReduceWarps * 32)
    mme_ln_bwd_reduce(const float* __restrict__ part, int parts, int cols,
                      float* __restrict__ sums) {
  __shared__ float red[kReduceWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float v = 0.f;
  if (c < cols) {
#pragma unroll 4
    for (int i = warp; i < parts; i += kReduceWarps)
      v += part[(size_t)i * cols + c];
  }
  red[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && c < cols) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kReduceWarps; ++i) s += red[i][lane];
    sums[c] = s;
  }
}

// The dynamic shared-memory limit of each instance, raised once per device
// (the instance is a template argument: each has its own record).
template <auto Kernel>
cudaError_t allow_smem() {
  static unsigned done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (done >> dev & 1u))) return err;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

template <auto Kernel>
cudaError_t launch(const Params& p, int grid, int smem, cudaStream_t stream) {
  const cudaError_t err = allow_smem<Kernel>();
  if (err != cudaSuccess) return err;
  Kernel<<<grid, p.teams * p.wpr * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int A, int B>
cudaError_t launch_fwd(const Params& p, int k, int grid, int smem,
                       cudaStream_t s) {
  switch (k) {
    case 1: return launch<mme_ln_fwd<A, B, 1>>(p, grid, smem, s);
    case 2: return launch<mme_ln_fwd<A, B, 2>>(p, grid, smem, s);
    case 3: return launch<mme_ln_fwd<A, B, 3>>(p, grid, smem, s);
    case 4: return launch<mme_ln_fwd<A, B, 4>>(p, grid, smem, s);
  }
  return cudaErrorInvalidValue;
}

template <int A, int B>
cudaError_t launch_bwd(const Params& p, int k, int grid, int smem,
                       cudaStream_t s) {
  switch (k) {
    case 1: return launch<mme_ln_bwd<A, B, 1>>(p, grid, smem, s);
    case 2: return launch<mme_ln_bwd<A, B, 2>>(p, grid, smem, s);
    case 3: return launch<mme_ln_bwd<A, B, 3>>(p, grid, smem, s);
    case 4: return launch<mme_ln_bwd<A, B, 4>>(p, grid, smem, s);
  }
  return cudaErrorInvalidValue;
}

bool valid(const Params& p, int k, int grid, int smem) {
  return p.n > 0 && p.h > 0 && p.h % 8 == 0 && k >= 1 && k <= 4 &&
         grid > 0 && p.teams > 0 && p.wpr > 0 && p.slots >= 1 &&
         p.teams * p.wpr * 32 <= kMaxThreads && (p.wpr == 1 || p.teams <= 4) &&
         k * 32 * p.wpr * 8 >= p.h && smem > 0 && smem <= kMaxSmem;
}

}  // namespace

// Both entry points return a cudaError_t value: 0 when every launch was
// accepted. The caller checks shapes, types and alignment and computes the
// geometry (ops/layer_norm.py::launch_plan); `cfg` holds, in this order, n,
// h, x in bf16, y (g) in bf16, scale in bf16, bias in bf16, the grid, teams
// per block, warps per row, chunks per thread, ring slots and the dynamic
// shared memory per block.
namespace {

Params params(const int* cfg, float eps, int* k, int* grid, int* smem) {
  Params p{};
  p.n = cfg[0]; p.h = cfg[1]; p.eps = eps;
  p.w_bf16 = cfg[4]; p.b_bf16 = cfg[5];
  *grid = cfg[6]; p.teams = cfg[7]; p.wpr = cfg[8]; *k = cfg[9];
  p.slots = cfg[10]; *smem = cfg[11];
  return p;
}

}  // namespace

extern "C" int mme_layer_norm_fwd(const void* x, const void* w, const void* b,
                                  void* y, const int* cfg, float eps,
                                  void* stream) {
  int k, grid, smem;
  Params p = params(cfg, eps, &k, &grid, &smem);
  p.x = x; p.w = w; p.b = b; p.out = y;
  if (!valid(p, k, grid, smem)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cfg[2])
    return (int)(cfg[3] ? launch_fwd<1, 1>(p, k, grid, smem, s)
                        : launch_fwd<1, 0>(p, k, grid, smem, s));
  return (int)(cfg[3] ? launch_fwd<0, 1>(p, k, grid, smem, s)
                      : launch_fwd<0, 0>(p, k, grid, smem, s));
}

// part: [grid, 2, h] fp32 scratch; sums: [2, h] fp32, dscale then dbias.
extern "C" int mme_layer_norm_bwd(const void* g, const void* x, const void* w,
                                  void* dx, void* part, void* sums,
                                  const int* cfg, float eps, void* stream) {
  int k, grid, smem;
  Params p = params(cfg, eps, &k, &grid, &smem);
  p.x = x; p.g = g; p.w = w; p.out = dx;
  p.part = static_cast<float*>(part);
  if (!valid(p, k, grid, smem)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cfg[2] ? (cfg[3] ? launch_bwd<1, 1>(p, k, grid, smem, s)
                       : launch_bwd<1, 0>(p, k, grid, smem, s))
             : (cfg[3] ? launch_bwd<0, 1>(p, k, grid, smem, s)
                       : launch_bwd<0, 0>(p, k, grid, smem, s));
  if (err != cudaSuccess) return (int)err;
  const int cols = 2 * p.h;
  mme_ln_bwd_reduce<<<(cols + 31) / 32, kReduceWarps * 32, 0, s>>>(
      p.part, grid, cols, static_cast<float*>(sums));
  return (int)cudaGetLastError();
}
