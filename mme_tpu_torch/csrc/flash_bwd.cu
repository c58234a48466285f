// FlashAttention-2 backward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mme_tpu/ops/flash_attention.py::_bwd_kernel
// (launched by _bwd_packed and _bwd_flat). It computes the same function,
// not that kernel's blocks. Given the forward's inputs, its row logsumexp
// and the output gradient dO:
//
//   S  = q k^T / sqrt(D) + bias_k              (fp32, recomputed)
//   P  = exp((S - LSE) - corr)
//   dV = P^T dO                                (P rounded to dO's type)
//   dP = dO V^T
//   dS = P * (dP - delta)                      (rounded to q's type)
//   dK = dS^T q / sqrt(D),  dQ = dS k / sqrt(D)
//
// delta = rowsum(O * dO) and LSE come from the caller ([B, H, Sq] fp32), as
// the TPU wrapper computes delta outside its kernel; a ring of K/V blocks
// can therefore pass the LSE of the whole context. `corr` (optional,
// [B, H, Sq] fp32) is subtracted after LSE: for a row whose every key
// carries the finite -0.7 f32max mask bias, LSE = fl(max + log n) has lost
// log n to rounding, and the caller passes it here so that P is the uniform
// 1/n of the non-flash path. Keys past Sk are excluded by index; a row with
// the sentinel LSE 1e30 (every score -inf) gets P = 0 and no gradient.
//
// q, k, v, dO, dQ, dK, dV are [B, S, H, D] tensors addressed through their
// strides (unit last stride), D is 64 or 128, the type bf16 or fp32.
//
// Design: two kernels, no atomics, every output element written once.
//  - flash_bwd_dkdv: one block of 4 warps per (64-key tile, head, batch
//    row), each warp owning 16 keys. It walks the query tiles in a loop
//    (the TPU kernel's loop too), computes S^T and dP^T with keys on rows,
//    and keeps dK and dV in registers. Contractions run over queries,
//    which are the columns of the register fragments, so P^T and dS^T feed
//    the tensor cores straight from registers.
//  - flash_bwd_dq: one block per (64-query tile, head, batch row), each
//    warp owning 16 queries, walking the key tiles. It recomputes S and dP
//    with queries on rows (LSE, delta per row live in registers) and owns
//    its dQ rows. The TPU kernel adds dQ into a block it revisits along a
//    sequential grid axis; blocks here run in parallel, so the sum over key
//    tiles is a loop inside one block and costs a second score recompute
//    (7 tile products instead of 5) in exchange for a deterministic result
//    and no fp32 scratch buffer.
// bf16 products run on mma.sync m16n8k16 with fp32 accumulation; fp32 keeps
// the same fragment ownership with FMAs (no TF32).
//
// Bound: 10 B H Sq Sk D flops against the bytes of q, k, v, O, dO, dQ, dK,
// dV, LSE and delta; the video tower (S = 1464) is bound by the tensor
// cores, the shorter sequences by memory. Right first: no TMA, no wgmma,
// no pipelined loads, 16-bit shared-memory reads for the transposed
// operands.

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

// four 64-row tiles, four 64-float row vectors, and for fp32 one staging
// tile per warp
template <typename T, int D>
constexpr size_t smem_bytes() {
  return (size_t)4 * kBlockK * Pitch<T, D>::value * sizeof(T) +
         4 * kBlockK * sizeof(float) +
         (std::is_same<T, float>::value ? kWarps * 16 * kPStride * sizeof(float)
                                        : 0);
}

template <typename T, int D>
struct Smem {
  T *a, *b, *c, *d;          // the four tiles
  float *bias, *lse, *delta, *corr;
  float* stage;              // this warp's staging tile (fp32 only)
  __device__ Smem(unsigned char* raw, int warp) {
    constexpr int P = Pitch<T, D>::value;
    a = reinterpret_cast<T*>(raw);
    b = a + kBlockK * P;
    c = b + kBlockK * P;
    d = c + kBlockK * P;
    bias = reinterpret_cast<float*>(d + kBlockK * P);
    lse = bias + kBlockK;
    delta = lse + kBlockK;
    corr = delta + kBlockK;
    stage = corr + kBlockK + warp * 16 * kPStride;
  }
};

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

// Store this warp's 16 x D accumulator, times `mul`, into rows
// row_base + g and row_base + g + 8 of a [S, H, D] slice (rows < limit).
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, long long row_stride,
                                           int row_base, int limit,
                                           const float (&acc)[D / 8][4],
                                           float mul, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_base + g + 8 * r;
    if (row >= limit) continue;
    T* out = base + (long long)row * row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = acc[n][2 * r] * mul, x1 = acc[n][2 * r + 1] * mul;
      if constexpr (std::is_same<T, bf16>::value) {
        *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t) = pack_bf16(x0, x1);
      } else {
        *reinterpret_cast<float2*>(out + n * 8 + 2 * t) = make_float2(x0, x1);
      }
    }
  }
}

// dK and dV of one 64-key tile. Fragment rows are keys, columns queries.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(const Params p) {
  constexpr int P = Pitch<T, D>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  Smem<T, D> sm(smem_raw, warp);
  T *k_s = sm.a, *v_s = sm.b, *q_s = sm.c, *do_s = sm.d;

  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvalid = min(kBlockK, p.Sk - k0);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dog = static_cast<const T*>(p.d_o) + b * p.do_sb + h * p.do_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh + k0 * p.k_ss;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + k0 * p.v_ss;
  const long long row_bh = ((long long)b * p.H + h) * p.Sq;

  load_tile<T, D>(k_s, kg, p.k_ss, kvalid, tid);
  load_tile<T, D>(v_s, vg, p.v_ss, kvalid, tid);
  if (tid < kBlockK)
    sm.bias[tid] = (p.bias != nullptr && tid < kvalid)
                       ? p.bias[b * p.bias_sb + k0 + tid] : 0.f;

  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);
  const T* k_w = k_s + warp * 16 * P;   // this warp's 16 keys
  const T* v_w = v_s + warp * 16 * P;

  const int num_tiles = (p.Sq + kBlockQ - 1) / kBlockQ;
  for (int qt = 0; qt < num_tiles; ++qt) {
    const int q0 = qt * kBlockQ;
    const int qvalid = min(kBlockQ, p.Sq - q0);
    __syncthreads();  // every warp is done with the previous tile
    load_tile<T, D>(q_s, qg + q0 * p.q_ss, p.q_ss, qvalid, tid);
    load_tile<T, D>(do_s, dog + q0 * p.do_ss, p.do_ss, qvalid, tid);
    if (tid < kBlockQ) {
      const bool ok = tid < qvalid;
      // a padding row gets the sentinel LSE, so its P is 0
      sm.lse[tid] = ok ? p.lse[row_bh + q0 + tid] : kLseMasked;
      sm.delta[tid] = ok ? p.delta[row_bh + q0 + tid] : 0.f;
      sm.corr[tid] = (ok && p.corr != nullptr) ? p.corr[row_bh + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    zero(s);
    mm_nt<T, D>(s, k_w, q_s, g, t);              // S^T = K Q^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = warp * 16 + g + 8 * (e >> 1);
        const int qi = j * 8 + 2 * t + (e & 1);
        const float x = s[j][e] * p.scale + sm.bias[key];
        s[j][e] = key < kvalid ? expf((x - sm.lse[qi]) - sm.corr[qi]) : 0.f;
      }
    mm_nn<T, D>(dv, s, do_s, sm.stage, g, t);    // dV += P^T dO
    zero(dp);
    mm_nt<T, D>(dp, v_w, do_s, g, t);            // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = s[j][e] * (dp[j][e] - sm.delta[j * 8 + 2 * t + (e & 1)]);
    mm_nn<T, D>(dk, dp, q_s, sm.stage, g, t);    // dK += dS^T Q
  }

  T* dkg = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvg = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_rows<T, D>(dkg, p.dk_ss, k0 + warp * 16, p.Sk, dk, p.scale, g, t);
  store_rows<T, D>(dvg, p.dv_ss, k0 + warp * 16, p.Sk, dv, 1.f, g, t);
}

// dQ of one 64-query tile. Fragment rows are queries, columns keys.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(const Params p) {
  constexpr int P = Pitch<T, D>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  Smem<T, D> sm(smem_raw, warp);
  T *q_s = sm.a, *do_s = sm.b, *k_s = sm.c, *v_s = sm.d;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int qvalid = min(kBlockQ, p.Sq - q0);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const T* dog = static_cast<const T*>(p.d_o) + b * p.do_sb + h * p.do_sh + q0 * p.do_ss;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const long long row_bh = ((long long)b * p.H + h) * p.Sq;

  load_tile<T, D>(q_s, qg, p.q_ss, qvalid, tid);
  load_tile<T, D>(do_s, dog, p.do_ss, qvalid, tid);

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
  zero(dq);
  const T* q_w = q_s + warp * 16 * P;   // this warp's 16 queries
  const T* do_w = do_s + warp * 16 * P;

  const int num_tiles = (p.Sk + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < num_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    const int kvalid = min(kBlockK, p.Sk - k0);
    __syncthreads();  // every warp is done with the previous tile
    load_tile<T, D>(k_s, kg + k0 * p.k_ss, p.k_ss, kvalid, tid);
    load_tile<T, D>(v_s, vg + k0 * p.v_ss, p.v_ss, kvalid, tid);
    if (tid < kBlockK)
      sm.bias[tid] = (p.bias != nullptr && tid < kvalid)
                         ? p.bias[b * p.bias_sb + k0 + tid] : 0.f;
    __syncthreads();

    float s[8][4], dp[8][4];
    zero(s);
    mm_nt<T, D>(s, q_w, k_s, g, t);              // S = Q K^T
    zero(dp);
    mm_nt<T, D>(dp, do_w, v_s, g, t);            // dP = dO V^T
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
    mm_nn<T, D>(dq, dp, k_s, sm.stage, g, t);    // dQ += dS K
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_rows<T, D>(dqg, p.dq_ss, q0 + warp * 16, p.Sq, dq, p.scale, g, t);
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      flash_bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((p.Sk + kBlockK - 1) / kBlockK, p.H, p.B);
  flash_bwd_dkdv<T, D><<<grid_k, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((p.Sq + kBlockQ - 1) / kBlockQ, p.H, p.B);
  flash_bwd_dq<T, D><<<grid_q, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value: 0 when both launches were accepted. The
// caller checks shapes, strides and alignment before calling. `strides`
// holds, in elements, (batch, sequence, head) strides of q, k, v, dO, dQ,
// dK, dV in that order: 21 values.
extern "C" int mme_flash_bwd(
    const void* q, const void* k, const void* v, const void* d_o,
    const void* bias, const void* lse, const void* delta, const void* corr,
    void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int D,
    int is_bf16, const long long* strides, long long bias_sb, float scale,
    void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.d_o = d_o;
  p.bias = static_cast<const float*>(bias);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.corr = static_cast<const float*>(corr);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H;
  const long long* s = strides;
  p.q_sb = s[0]; p.q_ss = s[1]; p.q_sh = s[2];
  p.k_sb = s[3]; p.k_ss = s[4]; p.k_sh = s[5];
  p.v_sb = s[6]; p.v_ss = s[7]; p.v_sh = s[8];
  p.do_sb = s[9]; p.do_ss = s[10]; p.do_sh = s[11];
  p.dq_sb = s[12]; p.dq_ss = s[13]; p.dq_sh = s[14];
  p.dk_sb = s[15]; p.dk_ss = s[16]; p.dk_sh = s[17];
  p.dv_sb = s[18]; p.dv_ss = s[19]; p.dv_sh = s[20];
  p.bias_sb = bias_sb;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64) return launch<bf16, 64>(p, st);
    if (D == 128) return launch<bf16, 128>(p, st);
  } else {
    if (D == 64) return launch<float, 64>(p, st);
    if (D == 128) return launch<float, 128>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}
