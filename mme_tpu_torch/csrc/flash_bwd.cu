// FlashAttention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mme_tpu/ops/flash_attention.py:184 _bwd_kernel
// (launched by _bwd_packed and _bwd_flat) and the delta its wrappers
// compute beside it. It computes the same function, not that kernel's
// blocks. Given the forward's inputs, its output O, its row logsumexp and
// the output gradient dO:
//
//   delta = rowsum(O * dO)                     (fp32, the pre-pass)
//   S  = q k^T / sqrt(D) + bias_k              (fp32, recomputed)
//   P  = exp((S - LSE) - corr)
//   dV = P^T dO                                (P rounded to dO's type)
//   dP = dO V^T
//   dS = P * (dP - delta)                      (rounded to q's type)
//   dK = dS^T q / sqrt(D),  dQ = dS k / sqrt(D)
//
// O and LSE come from the caller ([B, H, Sq] fp32 for LSE), so a ring of
// K/V blocks can pass those of the whole context. `corr` restores what LSE
// lost for a row whose every key carries a mask bias (the finite -0.7
// f32max, or the -1e30 of a key mask or of a ring's padding): LSE =
// fl(max + log n) has lost log n to rounding, and the pre-pass writes
// corr = log n of the bias row for every row with LSE <= -1e30 (0
// elsewhere), so that P is the uniform 1/n of the non-flash path. Keys past
// Sk are excluded by index; a row with the sentinel LSE 1e30 (every score
// -inf) gets P = 0 and no gradient.
//
// q, k, v, O, dO, dQ, dK, dV are [B, S, H, D] tensors addressed through
// their strides (unit last stride), D is 64 or 128, the type bf16 or fp32.
//
// Bound: 10 B H Sq Sk D flops (five tile products) against the bytes of q,
// k, v, O, dO, dQ, dK, dV, LSE and delta; the video tower (S = 1464) is
// bound by the tensor cores, the shorter sequences by memory.
//
// Design: three launches, no atomics, every output element written once,
// so two runs give the same bits.
//  - flash_bwd_prepass: delta and corr, one thread per (query, head).
//  - dkdv: one block per (128-key tile, head, batch row) (64 keys at
//    D = 128). It walks the query tiles in a loop (the TPU kernel's loop
//    too), computes S^T and dP^T with keys on rows, and keeps dK and dV in
//    registers.
//  - dq: one block per (128-query tile, head, batch row), walking the key
//    tiles. It recomputes S and dP with queries on rows and owns its dQ
//    rows. The TPU kernel adds dQ into a block it revisits along a
//    sequential grid axis; blocks here run in parallel, so the sum over key
//    tiles is a loop inside one block and costs a second score recompute
//    (7 tile products instead of 5) in exchange for a deterministic result
//    and no fp32 scratch buffer (about 430 MB per video call).
// bf16 (the model's path): each kernel is one TMA producer thread, a
// producer warp that writes the per-row values of every stage (LSE, delta,
// corr for dkdv; the key bias, -inf past Sk, for dq) and two consumer
// warpgroups of 64 rows on wgmma. The block's own rows (K and V; Q and
// dO) arrive once by TMA, the 64-row tiles it walks through a ring of
// stages. S^T = K Q^T and dP^T = V dO^T (S = Q K^T, dP = dO V^T) read both
// operands from shared memory; dV += P^T dO, dK += dS^T Q and dQ += dS K
// take P and dS from registers as A fragments and read the tile MN-major
// through the transpose bit. dq issues the products of the next key tile
// right behind dQ += dS K, before it waits. (x - LSE - corr) is formed
// before the scale by log2(e), which would overflow for the mask bias.
// fp32 (the check legs): 4 warps on 64-row tiles staged by the threads,
// fp32 FMAs (no TF32).

#include "flash_common.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* d_o;
  const float* bias;   // may be null: no bias
  const float* lse;
  const float* delta;
  const float* corr;   // may be null: no correction
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, H;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long bias_sb;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float scale;
};

// ============================== pre-pass ===============================

constexpr int kPrepassThreads = 256;

struct PrepassParams {
  const void* o;
  const void* d_o;
  const float* lse;
  const float* bias;   // may be null: no correction is written
  float* delta;
  float* corr;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  long long bias_sb;
  int Sq, Sk, H;
};

__device__ __forceinline__ float block_reduce(float x, float* red,
                                              bool is_max) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  __syncthreads();                       // `red` is free
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int i = 1; i < kPrepassThreads / 32; ++i)
    x = is_max ? fmaxf(x, red[i]) : x + red[i];
  return x;
}

// delta and corr [B, H, Sq] of batch row blockIdx.y, one thread per
// (query, head) pair. log n is computed only in blocks that hold a row
// with LSE <= -1e30.
template <typename T, int D>
__global__ void __launch_bounds__(kPrepassThreads)
    flash_bwd_prepass(const PrepassParams p) {
  __shared__ float red[kPrepassThreads / 32];
  const int b = blockIdx.y;
  const int idx = blockIdx.x * kPrepassThreads + threadIdx.x;
  const bool valid = idx < p.Sq * p.H;
  const int i = valid ? idx / p.H : 0, h = valid ? idx % p.H : 0;
  const long long row = ((long long)b * p.H + h) * p.Sq + i;
  if (valid) {
    const T* o = static_cast<const T*>(p.o) + b * p.o_sb + i * p.o_ss + h * p.o_sh;
    const T* d = static_cast<const T*>(p.d_o) + b * p.do_sb + i * p.do_ss +
                 h * p.do_sh;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < D; c += 16 / sizeof(T)) {
      const uint4 x = *reinterpret_cast<const uint4*>(o + c);
      const uint4 y = *reinterpret_cast<const uint4*>(d + c);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (sizeof(T) == 2) {
          const float2 xf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xs[e]));
          const float2 yf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&ys[e]));
          acc = fmaf(xf.x, yf.x, acc);
          acc = fmaf(xf.y, yf.y, acc);
        } else {
          acc = fmaf(__uint_as_float(xs[e]), __uint_as_float(ys[e]), acc);
        }
      }
    }
    p.delta[row] = acc;
  }
  if (p.bias == nullptr) return;
  const bool need = valid && p.lse[row] <= -kLseMasked;
  float log_n = 0.f;
  if (__syncthreads_or(need)) {
    const float* bias = p.bias + b * p.bias_sb;
    float mx = -INFINITY;
    for (int k = threadIdx.x; k < p.Sk; k += kPrepassThreads)
      mx = fmaxf(mx, bias[k]);
    mx = block_reduce(mx, red, true);
    float sum = 0.f;
    for (int k = threadIdx.x; k < p.Sk; k += kPrepassThreads)
      sum += expf(bias[k] - mx);
    log_n = logf(block_reduce(sum, red, false));
  }
  if (valid) p.corr[row] = need ? log_n : 0.f;
}

template <typename T, int D>
int launch_prepass(const PrepassParams& p, int B, cudaStream_t stream) {
  const dim3 grid((p.Sq * p.H + kPrepassThreads - 1) / kPrepassThreads, B);
  flash_bwd_prepass<T, D><<<grid, kPrepassThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// ================================ bf16 =================================

constexpr int kBlockRows = 128;   // rows a block owns: keys (dkdv), queries (dq)
constexpr int kStepRows = 64;     // rows a stage brings: queries (dkdv), keys (dq)

struct TmaParams {
  sm90::Operand4 q, k, v, d_o;
  const float* bias;
  const float* lse;
  const float* delta;
  const float* corr;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  long long bias_sb;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int Sq, Sk, H;
  float scale;
};

template <int D>
struct BwdShape {
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kOwn = tile_bytes<D>(kBlockRows);   // one own tile
  static constexpr int kTile = tile_bytes<D>(kStepRows);   // one stage tile
  // two tiles and up to three fp32 values per row
  static constexpr int kStage = round_kb(2 * kTile + 3 * kStepRows * 4);
  using Ring = sm90::Ring<kStages, kStage>;
  static constexpr size_t kSmem = 1024 + 2 * kOwn + Ring::bytes() + 8;
};

// Shared-memory layout of both kernels: the block's two own tiles, the
// ring, the own tiles' barrier.
template <int D>
struct BwdSmem {
  using F = BwdShape<D>;
  uint32_t base;
  unsigned char* base_ptr;
  typename F::Ring ring;
  uint32_t own_bar;
  __device__ explicit BwdSmem(unsigned char* raw)
      : base(sm90::aligned_smem_base(raw)),
        base_ptr(raw + (base - sm90::smem_u32(raw))),
        ring{base + 2 * F::kOwn},
        own_bar(base + 2 * F::kOwn + F::Ring::bytes()) {}
  // the fp32 row values of a stage, behind its two tiles
  __device__ float* rows(int it) const {
    return reinterpret_cast<float*>(base_ptr + (ring.stage(it) - base) +
                                    2 * F::kTile);
  }
};

// Keys per dK/dV block: 128, 64 to each group, at D = 64; 64 at D = 128,
// where both groups take the same keys and each owns 64 of the columns of
// dK and dV (64 x 128 fp32 of each would not fit beside S^T and dP^T in
// registers).
template <int D>
__host__ __device__ constexpr int dkdv_keys() { return D == 64 ? 128 : 64; }

// dK and dV of one key tile. Accumulator rows are keys, columns queries.
template <int D>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    flash_bwd_dkdv_tma(const __grid_constant__ TmaParams p) {
  using F = BwdShape<D>;
  constexpr int kKeys = dkdv_keys<D>();
  constexpr bool kSplitD = kKeys == 64;
  constexpr int kCols = kSplitD ? 64 : D;       // dK, dV columns per group
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const BwdSmem<D> sm(smem_raw);
  const uint32_t k_s = sm.base, v_s = sm.base + F::kOwn;
  const int k0 = blockIdx.x * kKeys, h = blockIdx.y, b = blockIdx.z;
  const int tiles = (p.Sq + kStepRows - 1) / kStepRows;
  const long long row_bh = ((long long)b * p.H + h) * p.Sq;
  if (threadIdx.x == 0) {
    sm90::bar_init(sm.own_bar, 1);
    sm.ring.init(1 + 32);       // the TMA thread and the row warp
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    sm90::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::bar_expect(sm.own_bar, 2 * tile_bytes<D>(kKeys));
      load_rows<D>(p.k, k_s, sm.own_bar, kKeys, k0, h, b);
      load_rows<D>(p.v, v_s, sm.own_bar, kKeys, k0, h, b);
      for (int it = 0; it < tiles; ++it) {
        const uint32_t st = sm.ring.acquire(it, 2 * F::kTile);
        const uint32_t full = sm.ring.full(it);
        load_rows<D>(p.q, st, full, kStepRows, it * kStepRows, h, b);
        load_rows<D>(p.d_o, st + F::kTile, full, kStepRows, it * kStepRows, h,
                     b);
      }
    } else if (threadIdx.x / 32 == 1) {
      // a padding row gets the sentinel LSE, so its P is 0
      const int lane = threadIdx.x % 32;
      for (int it = 0; it < tiles; ++it) {
        sm90::bar_wait(sm.ring.empty(it), sm.ring.parity(it) ^ 1);
        float* rows = sm.rows(it);
        for (int i = lane; i < kStepRows; i += 32) {
          const int qi = it * kStepRows + i;
          const bool ok = qi < p.Sq;
          rows[i] = ok ? p.lse[row_bh + qi] : kLseMasked;
          rows[kStepRows + i] = ok ? p.delta[row_bh + qi] : 0.f;
          rows[2 * kStepRows + i] =
              ok && p.corr != nullptr ? p.corr[row_bh + qi] : 0.f;
        }
        sm90::bar_arrive(sm.ring.full(it));
      }
    }
    return;
  }

  sm90::regs_inc<kConsumerRegs>();
  const int ct = threadIdx.x - 128, cw = ct / 128;
  const int w = (ct % 128) / 32, lane = ct % 32, g = lane / 4, qd = lane % 4;
  const int key0 = kSplitD ? k0 : k0 + 64 * cw;   // this group's 64 keys
  const int col0 = kSplitD ? 64 * cw : 0;        // and its first column
  const uint32_t ka = k_s + (key0 - k0) * 128;
  const uint32_t va = v_s + (key0 - k0) * 128;
  constexpr int kOwnBox = box_bytes(kKeys), kStepBox = box_bytes(kStepRows);
  float kb[2];                    // the bias of this thread's two keys
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 16 * w + g + 8 * r;
    kb[r] = key >= p.Sk ? -INFINITY
            : p.bias ? p.bias[b * p.bias_sb + key] : 0.f;
  }
  float dk[kCols / 2], dv[kCols / 2];
  zero(dk);
  zero(dv);

  sm90::bar_wait(sm.own_bar, 0);
  for (int it = 0; it < tiles; ++it) {
    sm90::bar_wait(sm.ring.full(it), sm.ring.parity(it));
    const uint32_t qt = sm.ring.stage(it), dot = qt + F::kTile;
    const float* rows = sm.rows(it);
    float s[kStepRows / 2], dp[kStepRows / 2];
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)             // S^T = K Q^T
      sm90::wgmma_ss<0, 0>(s, sm90::kmajor_desc(ka, kk, kOwnBox),
                           sm90::kmajor_desc(qt, kk, kStepBox), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)             // dP^T = V dO^T
      sm90::wgmma_ss<0, 0>(dp, sm90::kmajor_desc(va, kk, kOwnBox),
                           sm90::kmajor_desc(dot, kk, kStepBox), kk > 0);
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
#pragma unroll
    for (int j = 0; j < kStepRows / 8; ++j) {
      const int c = 8 * j + 2 * qd;               // this thread's queries
      const float2 lse = *reinterpret_cast<const float2*>(rows + c);
      const float2 delta = *reinterpret_cast<const float2*>(rows + kStepRows + c);
      const float2 corr =
          *reinterpret_cast<const float2*>(rows + 2 * kStepRows + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e & 1;
        const float x = fmaf(s[4 * j + e], p.scale, kb[e >> 1]);
        const float pr = ex2(((x - (hi ? lse.y : lse.x)) -
                              (hi ? corr.y : corr.x)) * kLog2e);
        s[4 * j + e] = pr;
        dp[4 * j + e] = pr * (dp[4 * j + e] - (hi ? delta.y : delta.x));
      }
    }
    uint32_t pf[kStepRows / 16][4], df[kStepRows / 16][4];
    to_frags(s, pf);
    to_frags(dp, df);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kStepRows / 16; ++kk)     // dV += P^T dO
      sm90::wgmma_rs<1>(dv, pf[kk],
                        sm90::mnmajor_desc(dot + col0 / 64 * kStepBox, kk,
                                           kStepBox), 1);
#pragma unroll
    for (int kk = 0; kk < kStepRows / 16; ++kk)     // dK += dS^T Q
      sm90::wgmma_rs<1>(dk, df[kk],
                        sm90::mnmajor_desc(qt + col0 / 64 * kStepBox, kk,
                                           kStepBox), 1);
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    sm90::fence_frags(pf);
    sm90::fence_frags(df);
    sm90::bar_arrive(sm.ring.empty(it));
  }

  store_acc<kCols>(p.dk + b * p.dk_sb + h * p.dk_sh + col0, p.dk_ss, key0,
                   p.Sk, dk, p.scale, w, g, qd);
  store_acc<kCols>(p.dv + b * p.dv_sb + h * p.dv_sh + col0, p.dv_ss, key0,
                   p.Sk, dv, 1.f, w, g, qd);
}

// dQ of one 128-query tile. Accumulator rows are queries, columns keys.
template <int D>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    flash_bwd_dq_tma(const __grid_constant__ TmaParams p) {
  using F = BwdShape<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const BwdSmem<D> sm(smem_raw);
  const uint32_t q_s = sm.base, do_s = sm.base + F::kOwn;
  const int q0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const int tiles = (p.Sk + kStepRows - 1) / kStepRows;
  if (threadIdx.x == 0) {
    sm90::bar_init(sm.own_bar, 1);
    sm.ring.init(1 + 32);       // the TMA thread and the bias warp
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    sm90::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::bar_expect(sm.own_bar, 2 * F::kOwn);
      load_rows<D>(p.q, q_s, sm.own_bar, kBlockRows, q0, h, b);
      load_rows<D>(p.d_o, do_s, sm.own_bar, kBlockRows, q0, h, b);
      for (int it = 0; it < tiles; ++it) {
        const uint32_t st = sm.ring.acquire(it, 2 * F::kTile);
        const uint32_t full = sm.ring.full(it);
        load_rows<D>(p.k, st, full, kStepRows, it * kStepRows, h, b);
        load_rows<D>(p.v, st + F::kTile, full, kStepRows, it * kStepRows, h,
                     b);
      }
    } else if (threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x % 32;
      const float* bias_g = p.bias ? p.bias + b * p.bias_sb : nullptr;
      for (int it = 0; it < tiles; ++it) {
        sm90::bar_wait(sm.ring.empty(it), sm.ring.parity(it) ^ 1);
        float* bias_s = sm.rows(it);
        for (int i = lane; i < kStepRows; i += 32) {
          const int key = it * kStepRows + i;
          bias_s[i] = key >= p.Sk ? -INFINITY : bias_g ? bias_g[key] : 0.f;
        }
        sm90::bar_arrive(sm.ring.full(it));
      }
    }
    return;
  }

  sm90::regs_inc<kConsumerRegs>();
  const int ct = threadIdx.x - 128, cw = ct / 128;
  const int w = (ct % 128) / 32, lane = ct % 32, g = lane / 4, qd = lane % 4;
  const uint32_t qa = q_s + cw * box_bytes(64);    // this group's 64 queries
  const uint32_t doa = do_s + cw * box_bytes(64);
  constexpr int kOwnBox = box_bytes(kBlockRows), kStepBox = box_bytes(kStepRows);
  // this thread's two query rows; a padding row gets the sentinel LSE
  const long long row_bh = ((long long)b * p.H + h) * p.Sq;
  float lse[2], delta[2], corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 64 * cw + 16 * w + g + 8 * r;
    const bool ok = row < p.Sq;
    lse[r] = ok ? p.lse[row_bh + row] : kLseMasked;
    delta[r] = ok ? p.delta[row_bh + row] : 0.f;
    corr[r] = ok && p.corr != nullptr ? p.corr[row_bh + row] : 0.f;
  }
  float dq[D / 2];
  zero(dq);

  sm90::bar_wait(sm.own_bar, 0);
  float s[kStepRows / 2], dp[kStepRows / 2];
  uint32_t df[kStepRows / 16][4];
  // S = Q K^T and dP = dO V^T of tile `it`, one commit group
  auto scores = [&](int it) {
    const uint32_t kt = sm.ring.stage(it), vt = kt + F::kTile;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss<0, 0>(s, sm90::kmajor_desc(qa, kk, kOwnBox),
                           sm90::kmajor_desc(kt, kk, kStepBox), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss<0, 0>(dp, sm90::kmajor_desc(doa, kk, kOwnBox),
                           sm90::kmajor_desc(vt, kk, kStepBox), kk > 0);
    sm90::wg_commit();
  };
  // The products of tile it + 1 are issued right behind dQ += dS K of tile
  // it, before the group waits for either; the stage of tile it is
  // released when both have ended.
  sm90::bar_wait(sm.ring.full(0), sm.ring.parity(0));
  sm90::wg_fence();
  scores(0);
  for (int it = 0; it < tiles; ++it) {
    const uint32_t kt = sm.ring.stage(it);
    const float* bias_s = sm.rows(it);
    sm90::wg_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    sm90::fence_regs(dq);
    sm90::fence_frags(df);
    if (it > 0) sm90::bar_arrive(sm.ring.empty(it - 1));
#pragma unroll
    for (int j = 0; j < kStepRows / 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * qd);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float x = fmaf(s[4 * j + e], p.scale, (e & 1) ? bb.y : bb.x);
        const float pr = ex2(((x - lse[r]) - corr[r]) * kLog2e);
        dp[4 * j + e] = pr * (dp[4 * j + e] - delta[r]);
      }
    }
    to_frags(dp, df);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kStepRows / 16; ++kk)     // dQ += dS K
      sm90::wgmma_rs<1>(dq, df[kk], sm90::mnmajor_desc(kt, kk, kStepBox), 1);
    sm90::wg_commit();
    if (it + 1 < tiles) {
      sm90::bar_wait(sm.ring.full(it + 1), sm.ring.parity(it + 1));
      scores(it + 1);
    }
  }
  sm90::wg_wait<0>();
  sm90::fence_regs(dq);
  sm90::fence_frags(df);

  store_acc<D>(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, q0 + 64 * cw, p.Sq,
               dq, p.scale, w, g, qd);
}

template <int D>
int launch_tma(const Params& a, cudaStream_t stream) {
  TmaParams p;
  if (!sm90::make_operand4(&p.q, a.q, a.B, a.Sq, a.H, D, a.q_sb, a.q_ss,
                           a.q_sh) ||
      !sm90::make_operand4(&p.k, a.k, a.B, a.Sk, a.H, D, a.k_sb, a.k_ss,
                           a.k_sh) ||
      !sm90::make_operand4(&p.v, a.v, a.B, a.Sk, a.H, D, a.v_sb, a.v_ss,
                           a.v_sh) ||
      !sm90::make_operand4(&p.d_o, a.d_o, a.B, a.Sq, a.H, D, a.do_sb,
                           a.do_ss, a.do_sh))
    return (int)cudaErrorInvalidValue;
  p.bias = a.bias;
  p.lse = a.lse;
  p.delta = a.delta;
  p.corr = a.corr;
  p.dq = static_cast<bf16*>(a.dq);
  p.dk = static_cast<bf16*>(a.dk);
  p.dv = static_cast<bf16*>(a.dv);
  p.bias_sb = a.bias_sb;
  p.dq_sb = a.dq_sb; p.dq_ss = a.dq_ss; p.dq_sh = a.dq_sh;
  p.dk_sb = a.dk_sb; p.dk_ss = a.dk_ss; p.dk_sh = a.dk_sh;
  p.dv_sb = a.dv_sb; p.dv_ss = a.dv_ss; p.dv_sh = a.dv_sh;
  p.Sq = a.Sq; p.Sk = a.Sk; p.H = a.H;
  p.scale = a.scale;
  constexpr size_t smem = BwdShape<D>::kSmem;
  cudaError_t err = allow_smem<flash_bwd_dkdv_tma<D>>(smem);
  if (err == cudaSuccess) err = allow_smem<flash_bwd_dq_tma<D>>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((a.Sk + dkdv_keys<D>() - 1) / dkdv_keys<D>(), a.H, a.B);
  flash_bwd_dkdv_tma<D><<<grid_k, sm90::kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((a.Sq + kBlockRows - 1) / kBlockRows, a.H, a.B);
  flash_bwd_dq_tma<D><<<grid_q, sm90::kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ================================ fp32 =================================

// four 64-row tiles, four 64-float row vectors, one staging tile per warp
template <int D>
constexpr size_t fma_smem_bytes() {
  return (size_t)4 * kBlockK * Pitch<D>::value * sizeof(float) +
         4 * kBlockK * sizeof(float) + kWarps * 16 * kPStride * sizeof(float);
}

template <int D>
struct Smem {
  float *a, *b, *c, *d;      // the four tiles
  float *bias, *lse, *delta, *corr;
  float* stage;              // this warp's staging tile
  __device__ Smem(unsigned char* raw, int warp) {
    constexpr int P = Pitch<D>::value;
    a = reinterpret_cast<float*>(raw);
    b = a + kBlockK * P;
    c = b + kBlockK * P;
    d = c + kBlockK * P;
    bias = d + kBlockK * P;
    lse = bias + kBlockK;
    delta = lse + kBlockK;
    corr = delta + kBlockK;
    stage = corr + kBlockK + warp * 16 * kPStride;
  }
};

template <int N>
__device__ __forceinline__ void zero4(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

// Store this warp's 16 x D accumulator, times `mul`, into rows
// row_base + g and row_base + g + 8 of a [S, H, D] slice (rows < limit).
template <int D>
__device__ __forceinline__ void store_rows(float* base, long long row_stride,
                                           int row_base, int limit,
                                           const float (&acc)[D / 8][4],
                                           float mul, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_base + g + 8 * r;
    if (row >= limit) continue;
    float* out = base + (long long)row * row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(out + n * 8 + 2 * t) =
          make_float2(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
  }
}

// dK and dV of one 64-key tile. Fragment rows are keys, columns queries.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_fma(const Params p) {
  constexpr int P = Pitch<D>::value;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  Smem<D> sm(smem_raw, warp);
  float *k_s = sm.a, *v_s = sm.b, *q_s = sm.c, *do_s = sm.d;

  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvalid = min(kBlockK, p.Sk - k0);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dog = static_cast<const float*>(p.d_o) + b * p.do_sb + h * p.do_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh + k0 * p.k_ss;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh + k0 * p.v_ss;
  const long long row_bh = ((long long)b * p.H + h) * p.Sq;

  load_tile<D>(k_s, kg, p.k_ss, kvalid, tid);
  load_tile<D>(v_s, vg, p.v_ss, kvalid, tid);
  if (tid < kBlockK)
    sm.bias[tid] = (p.bias != nullptr && tid < kvalid)
                       ? p.bias[b * p.bias_sb + k0 + tid] : 0.f;

  float dk[D / 8][4], dv[D / 8][4];
  zero4(dk);
  zero4(dv);
  const float* k_w = k_s + warp * 16 * P;   // this warp's 16 keys
  const float* v_w = v_s + warp * 16 * P;

  const int num_tiles = (p.Sq + kBlockQ - 1) / kBlockQ;
  for (int qt = 0; qt < num_tiles; ++qt) {
    const int q0 = qt * kBlockQ;
    const int qvalid = min(kBlockQ, p.Sq - q0);
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(q_s, qg + q0 * p.q_ss, p.q_ss, qvalid, tid);
    load_tile<D>(do_s, dog + q0 * p.do_ss, p.do_ss, qvalid, tid);
    if (tid < kBlockQ) {
      const bool ok = tid < qvalid;
      // a padding row gets the sentinel LSE, so its P is 0
      sm.lse[tid] = ok ? p.lse[row_bh + q0 + tid] : kLseMasked;
      sm.delta[tid] = ok ? p.delta[row_bh + q0 + tid] : 0.f;
      sm.corr[tid] = (ok && p.corr != nullptr) ? p.corr[row_bh + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    zero4(s);
    mm_nt<D>(s, k_w, q_s, g, t);                 // S^T = K Q^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = warp * 16 + g + 8 * (e >> 1);
        const int qi = j * 8 + 2 * t + (e & 1);
        const float x = s[j][e] * p.scale + sm.bias[key];
        s[j][e] = key < kvalid ? expf((x - sm.lse[qi]) - sm.corr[qi]) : 0.f;
      }
    mm_nn<D>(dv, s, do_s, sm.stage, g, t);       // dV += P^T dO
    zero4(dp);
    mm_nt<D>(dp, v_w, do_s, g, t);               // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = s[j][e] * (dp[j][e] - sm.delta[j * 8 + 2 * t + (e & 1)]);
    mm_nn<D>(dk, dp, q_s, sm.stage, g, t);       // dK += dS^T Q
  }

  float* dkg = static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  float* dvg = static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_rows<D>(dkg, p.dk_ss, k0 + warp * 16, p.Sk, dk, p.scale, g, t);
  store_rows<D>(dvg, p.dv_ss, k0 + warp * 16, p.Sk, dv, 1.f, g, t);
}

// dQ of one 64-query tile. Fragment rows are queries, columns keys.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_fma(const Params p) {
  constexpr int P = Pitch<D>::value;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  Smem<D> sm(smem_raw, warp);
  float *q_s = sm.a, *do_s = sm.b, *k_s = sm.c, *v_s = sm.d;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int qvalid = min(kBlockQ, p.Sq - q0);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const float* dog = static_cast<const float*>(p.d_o) + b * p.do_sb + h * p.do_sh + q0 * p.do_ss;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const long long row_bh = ((long long)b * p.H + h) * p.Sq;

  load_tile<D>(q_s, qg, p.q_ss, qvalid, tid);
  load_tile<D>(do_s, dog, p.do_ss, qvalid, tid);

  // this lane's two query rows
  float lse[2], delta[2], corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const bool ok = row < p.Sq;
    lse[r] = ok ? p.lse[row_bh + row] : kLseMasked;
    delta[r] = ok ? p.delta[row_bh + row] : 0.f;
    corr[r] = (ok && p.corr != nullptr) ? p.corr[row_bh + row] : 0.f;
  }

  float dq[D / 8][4];
  zero4(dq);
  const float* q_w = q_s + warp * 16 * P;   // this warp's 16 queries
  const float* do_w = do_s + warp * 16 * P;

  const int num_tiles = (p.Sk + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < num_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    const int kvalid = min(kBlockK, p.Sk - k0);
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(k_s, kg + k0 * p.k_ss, p.k_ss, kvalid, tid);
    load_tile<D>(v_s, vg + k0 * p.v_ss, p.v_ss, kvalid, tid);
    if (tid < kBlockK)
      sm.bias[tid] = (p.bias != nullptr && tid < kvalid)
                         ? p.bias[b * p.bias_sb + k0 + tid] : 0.f;
    __syncthreads();

    float s[8][4], dp[8][4];
    zero4(s);
    mm_nt<D>(s, q_w, k_s, g, t);                 // S = Q K^T
    zero4(dp);
    mm_nt<D>(dp, do_w, v_s, g, t);               // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        const float x = s[j][e] * p.scale + sm.bias[key];
        const float pr = key < kvalid ? expf((x - lse[r]) - corr[r]) : 0.f;
        dp[j][e] = pr * (dp[j][e] - delta[r]);
      }
    mm_nn<D>(dq, dp, k_s, sm.stage, g, t);       // dQ += dS K
  }

  float* dqg = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_rows<D>(dqg, p.dq_ss, q0 + warp * 16, p.Sq, dq, p.scale, g, t);
}

template <int D>
int launch_fma(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<D>();
  cudaError_t err = allow_smem<flash_bwd_dkdv_fma<D>>(smem);
  if (err == cudaSuccess) err = allow_smem<flash_bwd_dq_fma<D>>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((p.Sk + kBlockK - 1) / kBlockK, p.H, p.B);
  flash_bwd_dkdv_fma<D><<<grid_k, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((p.Sq + kBlockQ - 1) / kBlockQ, p.H, p.B);
  flash_bwd_dq_fma<D><<<grid_q, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int run_prepass(const void* out, const void* d_o, const void* bias,
                const void* lse, void* delta, void* corr, int B, int Sq,
                int Sk, int H, int D, int is_bf16, const long long* s,
                long long bias_sb, cudaStream_t stream) {
  PrepassParams p;
  p.o = out; p.d_o = d_o;
  p.lse = static_cast<const float*>(lse);
  p.bias = static_cast<const float*>(bias);
  p.delta = static_cast<float*>(delta);
  p.corr = static_cast<float*>(corr);
  p.o_sb = s[0]; p.o_ss = s[1]; p.o_sh = s[2];
  p.do_sb = s[3]; p.do_ss = s[4]; p.do_sh = s[5];
  p.bias_sb = bias_sb;
  p.Sq = Sq; p.Sk = Sk; p.H = H;
  if (is_bf16) {
    if (D == 64) return launch_prepass<bf16, 64>(p, B, stream);
    if (D == 128) return launch_prepass<bf16, 128>(p, B, stream);
  } else {
    if (D == 64) return launch_prepass<float, 64>(p, B, stream);
    if (D == 128) return launch_prepass<float, 128>(p, B, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// delta = rowsum(O * dO) and, where `bias` is given, the masked-row
// correction, both [B, H, Sq] fp32. `strides` holds, in elements, the
// (batch, sequence, head) strides of O and dO: 6 values. Returns a
// cudaError_t value.
extern "C" int mme_flash_bwd_prepass(
    const void* out, const void* d_o, const void* bias, const void* lse,
    void* delta, void* corr, int B, int Sq, int Sk, int H, int D,
    int is_bf16, const long long* strides, long long bias_sb, void* stream) {
  return run_prepass(out, d_o, bias, lse, delta, corr, B, Sq, Sk, H, D,
                     is_bf16, strides, bias_sb,
                     static_cast<cudaStream_t>(stream));
}

// The dK/dV and dQ launches alone, from `delta` and `corr` ([B, H, Sq]
// fp32) that the caller computed: a ring of K/V blocks computes them once
// from the global O, LSE and key bias, and calls this once per block.
// `corr` may be null (no correction). Arguments as mme_flash_bwd's.
extern "C" int mme_flash_bwd_main(
    const void* q, const void* k, const void* v, const void* d_o,
    const void* bias, const void* lse, const void* delta, const void* corr,
    void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int D,
    int is_bf16, const long long* strides, long long bias_sb, float scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* s = strides;
  Params p;
  p.q = q; p.k = k; p.v = v; p.d_o = d_o;
  p.bias = static_cast<const float*>(bias);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.corr = static_cast<const float*>(corr);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H;
  p.q_sb = s[0]; p.q_ss = s[1]; p.q_sh = s[2];
  p.k_sb = s[3]; p.k_ss = s[4]; p.k_sh = s[5];
  p.v_sb = s[6]; p.v_ss = s[7]; p.v_sh = s[8];
  p.do_sb = s[12]; p.do_ss = s[13]; p.do_sh = s[14];
  p.dq_sb = s[15]; p.dq_ss = s[16]; p.dq_sh = s[17];
  p.dk_sb = s[18]; p.dk_ss = s[19]; p.dk_sh = s[20];
  p.dv_sb = s[21]; p.dv_ss = s[22]; p.dv_sh = s[23];
  p.bias_sb = bias_sb;
  p.scale = scale;
  if (is_bf16) {
    if (D == 64) return launch_tma<64>(p, st);
    if (D == 128) return launch_tma<128>(p, st);
  } else {
    if (D == 64) return launch_fma<64>(p, st);
    if (D == 128) return launch_fma<128>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Returns a cudaError_t value: 0 when the three launches were accepted.
// The caller checks shapes, strides and alignment before calling.
// `strides` holds, in elements, (batch, sequence, head) strides of q, k, v,
// O, dO, dQ, dK, dV in that order: 24 values. `delta` and `corr` ([B, H,
// Sq] fp32) are written by the pre-pass; `corr` is null when `bias` is.
extern "C" int mme_flash_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* d_o, const void* bias, const void* lse, void* delta,
    void* corr, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
    int D, int is_bf16, const long long* strides, long long bias_sb,
    float scale, void* stream) {
  const long long* s = strides;
  const long long pre[6] = {s[9], s[10], s[11], s[12], s[13], s[14]};
  const int err = run_prepass(out, d_o, bias, lse, delta, corr, B, Sq, Sk,
                              H, D, is_bf16, pre, bias_sb,
                              static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  return mme_flash_bwd_main(q, k, v, d_o, bias, lse, delta,
                            bias != nullptr ? corr : nullptr, dq, dk, dv, B,
                            Sq, Sk, H, D, is_bf16, strides, bias_sb, scale,
                            stream);
}
