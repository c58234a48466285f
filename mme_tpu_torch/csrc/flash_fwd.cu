// FlashAttention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mme_tpu/ops/flash_attention.py:125 _fwd_kernel
// (launched by _fwd_packed and _fwd_flat). It computes the same function,
// not that kernel's blocks:
//
//   O   = softmax(q k^T / sqrt(D) + bias_k) v      [B, Sq, H, D], input type
//   LSE = logsumexp of the same logits             [B, H, Sq], fp32
//
// q, k, v are [B, S, H, D] tensors read through their strides (the last
// stride is 1), so the strided views of the fused QKV projection go in with
// no copy. D is 64 or 128; the element type is bf16 or fp32. bias_k is an
// optional per-key fp32 [B, Sk] (row stride given). Logits, the online
// softmax and the accumulators are fp32. As in the TPU kernel, the
// unnormalised probabilities P are rounded to v's type before the P v
// product, and the denominator sums P in fp32.
//
// Masking: keys of the ragged last tile are excluded by index (score
// -inf), never by a finite bias. A query row whose every key carries the
// finite mask bias of ops/attention.py (-0.7 f32max) therefore gets the
// mean of v, as in the non-flash path; only a row whose every score is
// -inf gets O = 0 and LSE = 1e30 (the TPU kernel's sentinel).
//
// Bound: 4 B H Sq Sk D flops against B (2 Sq + 2 Sk) H D elements moved;
// at the served shapes the video tower (Sq = Sk = 1464) is bound by the
// tensor cores, the shorter sequences by memory (and by the launch).
//
// bf16 design (flash_fwd_tma), the shape of FlashAttention-3's forward:
// one block of three warpgroups per (128-query tile, head, batch row). One
// thread of the producer group loads the Q tile once by TMA and streams K
// and V tiles of 128 keys (64 at D = 128) through a 3-stage ring (4-D
// tensor maps read the strided views as they are); a second producer warp
// writes each stage's key bias, -inf past Sk, so keys of a ragged tile drop
// out by index although TMA fills them with zeros. Each consumer warpgroup
// owns 64 query rows: S = Q K^T is a wgmma with both operands in shared
// memory, the online softmax runs on the accumulator registers with exp2,
// and O += P V is a wgmma with P rounded in place into A fragments and V
// read MN-major through the transpose bit. The P V product of tile j runs
// while the softmax of tile j + 1 is computed, and the stage of tile j is
// released when it ends; the two groups take turns at issuing their
// products, so one group's softmax overlaps the other's products. The row
// maximum is subtracted before the scale by log2(e): the mask bias times
// log2(e) would overflow to -inf.
//
// fp32 design (flash_fwd_fma, the check legs): one block of 4 warps per
// (64-row q tile, head, batch row), K/V tiles of 64 keys staged in shared
// memory by the threads, fp32 FMAs; exact to fp32 rounding (no TF32).

#include "flash_common.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // may be null: no bias
  void* o;
  float* lse;
  int B, Sq, Sk, H;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long bias_sb;
  long long o_sb, o_ss, o_sh;
  float scale;
};

// ================================ bf16 =================================

constexpr int kBlockM = 128;    // query rows per block: two groups of 64

struct TmaParams {
  sm90::Operand4 q, k, v;
  const float* bias;
  bf16* o;
  float* lse;
  long long bias_sb, o_sb, o_ss, o_sh;
  int Sq, Sk, H;
  float scale;
};

// Keys per stage: 128 at D = 64; 64 at D = 128, where 128 keys would not
// leave the registers for S, O and P together.
template <int D>
struct FwdShape {
  static constexpr int kBlockN = D == 64 ? 128 : 64;
  static constexpr int kStages = 3;
  static constexpr int kKV = tile_bytes<D>(kBlockN);        // K or V tile
  static constexpr int kStage = round_kb(2 * kKV + kBlockN * 4);
  static constexpr int kQ = tile_bytes<D>(kBlockM);
  using Ring = sm90::Ring<kStages, kStage>;
  static constexpr size_t kSmem = 1024 + kQ + Ring::bytes() + 8;
};

constexpr int kQBox = box_bytes(kBlockM);

// S = Q K^T of one group's 64 rows (`qa`) and the K tile at `kt`.
template <int D, int BN>
__device__ __forceinline__ void fwd_scores(float (&s)[BN / 2],
                                           uint32_t qa, uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm90::wgmma_ss<0, 0>(s, sm90::kmajor_desc(qa, kk, kQBox),
                         sm90::kmajor_desc(kt, kk, box_bytes(BN)), kk > 0);
}

// O += P V with the V tile at `vt`, read MN-major.
template <int D, int BN>
__device__ __forceinline__ void fwd_pv(float (&o)[D / 2],
                                       uint32_t (&pf)[BN / 16][4],
                                       uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    sm90::wgmma_rs<1>(o, pf[kk], sm90::mnmajor_desc(vt, kk, box_bytes(BN)),
                      1);
}

// Scale, bias and the online softmax update of one tile: s becomes the
// unnormalised P against the new row maxima m; alpha rescales what came
// before, rs is this thread's share of the tile's row sums. The maximum is
// subtracted before the scale by log2(e).
template <int BN>
__device__ __forceinline__ void fwd_softmax(float (&s)[BN / 2],
                                            float (&m)[2],
                                            const float* bias_s, float scale,
                                            int qd, float (&alpha)[2],
                                            float (&rs)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * qd);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = fmaf(s[4 * j + e], scale, (e & 1) ? bb.y : bb.x);
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    base[r] = m_new == -INFINITY ? 0.f : m_new;   // all -inf so far: P = 0
    alpha[r] = ex2((m[r] - base[r]) * kLog2e);
    m[r] = m_new;
    rs[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    s[i] = ex2((s[i] - base[(i >> 1) & 1]) * kLog2e);
    rs[(i >> 1) & 1] += s[i];
  }
}

template <int D>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    flash_fwd_tma(const __grid_constant__ TmaParams p) {
  using F = FwdShape<D>;
  constexpr int kBlockN = F::kBlockN;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = sm90::aligned_smem_base(smem_raw);
  unsigned char* base_ptr = smem_raw + (base - sm90::smem_u32(smem_raw));
  const uint32_t q_s = base;
  const typename F::Ring ring{base + F::kQ};
  const uint32_t q_bar = ring.base + F::Ring::bytes();
  // the key bias of a stage, behind its K and V tiles
  auto bias_of = [&](int it) {
    return reinterpret_cast<float*>(base_ptr + (ring.stage(it) - base) +
                                    2 * F::kKV);
  };
  const int q0 = blockIdx.x * kBlockM, h = blockIdx.y, b = blockIdx.z;
  const int tiles = (p.Sk + kBlockN - 1) / kBlockN;
  if (threadIdx.x == 0) {
    sm90::bar_init(q_bar, 1);
    ring.init(1 + 32);          // the TMA thread and the bias warp
  }
  __syncthreads();

  if (threadIdx.x < 128) {      // producer warpgroup
    sm90::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::bar_expect(q_bar, F::kQ);
      load_rows<D>(p.q, q_s, q_bar, kBlockM, q0, h, b);
      for (int it = 0; it < tiles; ++it) {
        const uint32_t st = ring.acquire(it, 2 * F::kKV);
        load_rows<D>(p.k, st, ring.full(it), kBlockN, it * kBlockN, h, b);
        load_rows<D>(p.v, st + F::kKV, ring.full(it), kBlockN, it * kBlockN,
                     h, b);
      }
    } else if (threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x % 32;
      const float* bias_g = p.bias ? p.bias + b * p.bias_sb : nullptr;
      for (int it = 0; it < tiles; ++it) {
        sm90::bar_wait(ring.empty(it), ring.parity(it) ^ 1);
        float* bias_s = bias_of(it);
        for (int i = lane; i < kBlockN; i += 32) {
          const int key = it * kBlockN + i;
          bias_s[i] = key >= p.Sk ? -INFINITY : bias_g ? bias_g[key] : 0.f;
        }
        sm90::bar_arrive(ring.full(it));
      }
    }
    return;
  }

  sm90::regs_inc<kConsumerRegs>();
  const int ct = threadIdx.x - 128, cw = ct / 128;
  const int w = (ct % 128) / 32, lane = ct % 32, g = lane / 4, qd = lane % 4;
  const uint32_t qa = q_s + cw * box_bytes(64);   // this group's 64 rows

  float s[kBlockN / 2];           // scores, then P, of one tile
  float o[D / 2];                 // unnormalised output rows
  uint32_t pf[kBlockN / 16][4];   // P as bf16 A fragments
  float m[2] = {-INFINITY, -INFINITY};  // running row maxima (rows g, g+8)
  float l[2] = {0.f, 0.f};              // this thread's share of the sums
  zero(o);
  // tiles + 1 turns per group; group 0 takes the first, and group 1 hands
  // over no turn after its last
  if (cw == 1) turn_pass(cw);

  sm90::bar_wait(q_bar, 0);
  sm90::bar_wait(ring.full(0), ring.parity(0));
  turn_wait(cw);
  sm90::wg_fence();
  fwd_scores<D, kBlockN>(s, qa, ring.stage(0));
  sm90::wg_commit();
  turn_pass(cw);
  sm90::wg_wait<0>();
  sm90::fence_regs(s);
  {
    float alpha[2], rs[2];
    fwd_softmax<kBlockN>(s, m, bias_of(0), p.scale, qd, alpha, rs);
    l[0] = rs[0];
    l[1] = rs[1];
    to_frags(s, pf);
  }
  for (int it = 1; it < tiles; ++it) {
    sm90::bar_wait(ring.full(it), ring.parity(it));
    turn_wait(cw);
    sm90::wg_fence();
    fwd_scores<D, kBlockN>(s, qa, ring.stage(it));
    sm90::wg_commit();
    fwd_pv<D, kBlockN>(o, pf, ring.stage(it - 1) + F::kKV);
    sm90::wg_commit();
    turn_pass(cw);
    sm90::wg_wait<1>();           // S of this tile
    sm90::fence_regs(s);
    float alpha[2], rs[2];
    fwd_softmax<kBlockN>(s, m, bias_of(it), p.scale, qd, alpha, rs);
    sm90::wg_wait<0>();           // P V of the previous tile
    sm90::fence_regs(o);
    sm90::fence_frags(pf);
    sm90::bar_arrive(ring.empty(it - 1));
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
    to_frags(s, pf);
  }
  turn_wait(cw);
  sm90::wg_fence();
  fwd_pv<D, kBlockN>(o, pf, ring.stage(tiles - 1) + F::kKV);
  sm90::wg_commit();
  if (cw == 0) turn_pass(cw);
  sm90::wg_wait<0>();
  sm90::fence_regs(o);
  sm90::fence_frags(pf);

  // normalise and store
  const int row0 = q0 + 64 * cw;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = quad_sum(l[r]);
    inv[r] = denom > 0.f ? 1.f / denom : 0.f;
    const int row = row0 + 16 * w + g + 8 * r;
    if (qd == 0 && row < p.Sq)
      p.lse[((long long)b * p.H + h) * p.Sq + row] =
          denom > 0.f ? m[r] + logf(denom) : kLseMasked;
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= inv[(i >> 1) & 1];
  store_acc<D>(p.o + b * p.o_sb + h * p.o_sh, p.o_ss, row0, p.Sq, o, 1.f, w,
               g, qd);
}

template <int D>
int launch_tma(const Params& a, cudaStream_t stream) {
  TmaParams p;
  if (!sm90::make_operand4(&p.q, a.q, a.B, a.Sq, a.H, D, a.q_sb, a.q_ss,
                           a.q_sh) ||
      !sm90::make_operand4(&p.k, a.k, a.B, a.Sk, a.H, D, a.k_sb, a.k_ss,
                           a.k_sh) ||
      !sm90::make_operand4(&p.v, a.v, a.B, a.Sk, a.H, D, a.v_sb, a.v_ss,
                           a.v_sh))
    return (int)cudaErrorInvalidValue;
  p.bias = a.bias;
  p.o = static_cast<bf16*>(a.o);
  p.lse = a.lse;
  p.bias_sb = a.bias_sb;
  p.o_sb = a.o_sb; p.o_ss = a.o_ss; p.o_sh = a.o_sh;
  p.Sq = a.Sq; p.Sk = a.Sk; p.H = a.H;
  p.scale = a.scale;
  constexpr size_t smem = FwdShape<D>::kSmem;
  const cudaError_t err = allow_smem<flash_fwd_tma<D>>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + kBlockM - 1) / kBlockM, a.H, a.B);
  flash_fwd_tma<D><<<grid, sm90::kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ================================ fp32 =================================

template <int D>
constexpr size_t fma_smem_bytes() {
  return (size_t)(kBlockQ + 2 * kBlockK) * Pitch<D>::value * sizeof(float) +
         kBlockK * sizeof(float) + kWarps * 16 * kPStride * sizeof(float);
}

// Fragment ownership: see flash_common.cuh.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_fma(const Params p) {
  constexpr int P = Pitch<D>::value;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* k_s = q_s + kBlockQ * P;
  float* v_s = k_s + kBlockK * P;
  float* bias_s = v_s + kBlockK * P;
  float* p_s = bias_s + kBlockK;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = warp * 16 + g;  // this lane's first row in the q tile

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bias_g = p.bias ? p.bias + b * p.bias_sb : nullptr;

  load_tile<D>(q_s, qg, p.q_ss, min(kBlockQ, p.Sq - q0), tid);
  __syncthreads();

  float m[2] = {-INFINITY, -INFINITY};  // running row maxima (rows g, g+8)
  float l[2] = {0.f, 0.f};              // this lane's share of the denominators
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int num_tiles = (p.Sk + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < num_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    const int kvalid = min(kBlockK, p.Sk - k0);
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(k_s, kg + k0 * p.k_ss, p.k_ss, kvalid, tid);
    load_tile<D>(v_s, vg + k0 * p.v_ss, p.v_ss, kvalid, tid);
    if (tid < kBlockK)
      bias_s[tid] = (bias_g != nullptr && tid < kvalid) ? bias_g[k0 + tid] : 0.f;
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    mm_nt<D>(s, q_s + warp * 16 * P, k_s, g, t);

    // scale + bias; keys past Sk are excluded by index
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + 2 * t + (e & 1);
        s[j][e] = key < kvalid ? s[j][e] * p.scale + bias_s[key] : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }

    // online softmax update
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      base[r] = m_new == -INFINITY ? 0.f : m_new;  // all -inf so far: p = 0
      alpha[r] = expf(m[r] - base[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - base[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P V
    mm_nn<D>(acc, s, v_s, p_s + warp * 16 * kPStride, g, t);
  }

  // normalise and store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = quad_sum(l[r]);
    const int row = q0 + row0 + 8 * r;
    if (row >= p.Sq) continue;
    const float inv = denom > 0.f ? 1.f / denom : 0.f;
    float* orow = static_cast<float*>(p.o) + b * p.o_sb + (long long)row * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * t) =
          make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (t == 0)
      p.lse[((long long)b * p.H + h) * p.Sq + row] =
          denom > 0.f ? m[r] + logf(denom) : kLseMasked;
  }
}

template <int D>
int launch_fma(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<D>();
  const cudaError_t err = allow_smem<flash_fwd_fma<D>>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, p.B);
  flash_fwd_fma<D><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value: 0 when the launch was accepted. The caller
// checks shapes, strides and alignment before calling.
extern "C" int mme_flash_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int B, int Sq, int Sk, int H, int D, int is_bf16,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long bias_sb,
    long long o_sb, long long o_ss, long long o_sh, float scale,
    void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.o = o; p.lse = static_cast<float*>(lse);
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.bias_sb = bias_sb;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64) return launch_tma<64>(p, s);
    if (D == 128) return launch_tma<128>(p, s);
  } else {
    if (D == 64) return launch_fma<64>(p, s);
    if (D == 128) return launch_fma<128>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}
