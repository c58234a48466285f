// FlashAttention-2 forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mme_tpu/ops/flash_attention.py::_fwd_kernel
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
// Design: one block of 4 warps per (64-row q tile, head, batch row); each
// warp owns 16 query rows. K/V tiles of 64 keys are staged in shared
// memory and the whole key range is walked in a loop inside the block
// (the TPU's sequential grid axis becomes this loop). For bf16 both
// products run on the tensor cores with mma.sync m16n8k16 (fp32
// accumulate); the S accumulator fragments are reused in registers as the
// A operand of P v. For fp32 the same fragment ownership is kept and the
// products are fp32 FMAs, which keeps the fp32 result exact to fp32
// rounding (no TF32).
//
// Bound: per call 4 B H Sq Sk D flops against B (2 Sq + 2 Sk) H D elements
// moved; at the served shapes the video tower (Sq = Sk = 1464) is bound by
// the tensor cores and the shorter sequences by memory. This first version
// aims at right, not fast: no TMA, no wgmma, no pipelining of the K/V
// loads; each block reads K/V once per tile from L2.

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

template <typename T, int D>
constexpr size_t smem_bytes() {
  return (size_t)(kBlockQ + 2 * kBlockK) * Pitch<T, D>::value * sizeof(T) +
         kBlockK * sizeof(float) +
         (std::is_same<T, float>::value ? kWarps * 16 * kPStride * sizeof(float)
                                        : 0);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fragment ownership: see flash_common.cuh.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int P = Pitch<T, D>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + kBlockQ * P;
  T* v_s = k_s + kBlockK * P;
  float* bias_s = reinterpret_cast<float*>(v_s + kBlockK * P);
  float* p_s = bias_s + kBlockK;  // fp32 path only

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = warp * 16 + g;  // this lane's first row in the q tile

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bias_g = p.bias ? p.bias + b * p.bias_sb : nullptr;

  load_tile<T, D>(q_s, qg, p.q_ss, min(kBlockQ, p.Sq - q0), tid);
  __syncthreads();

  uint32_t qf[D / 16][4];  // bf16: this warp's Q rows as mma A fragments
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const T* r0 = q_s + row0 * P + kk * 16 + 2 * t;
      const T* r8 = r0 + 8 * P;
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(r8);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
    }
  }

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
    load_tile<T, D>(k_s, kg + k0 * p.k_ss, p.k_ss, kvalid, tid);
    load_tile<T, D>(v_s, vg + k0 * p.v_ss, p.v_ss, kvalid, tid);
    if (tid < kBlockK)
      bias_s[tid] = (bias_g != nullptr && tid < kvalid) ? bias_g[k0 + tid] : 0.f;
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const T* kr = k_s + (j * 8 + g) * P + kk * 16 + 2 * t;
          mma_16816(s[j], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                    *reinterpret_cast<const uint32_t*>(kr + 8));
        }
    } else {
      for (int d = 0; d < D; ++d) {
        const float q_lo = q_s[row0 * P + d], q_hi = q_s[(row0 + 8) * P + d];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float k_a = k_s[(j * 8 + 2 * t) * P + d];
          const float k_b = k_s[(j * 8 + 2 * t + 1) * P + d];
          s[j][0] = fmaf(q_lo, k_a, s[j][0]);
          s[j][1] = fmaf(q_lo, k_b, s[j][1]);
          s[j][2] = fmaf(q_hi, k_a, s[j][2]);
          s[j][3] = fmaf(q_hi, k_b, s[j][3]);
        }
      }
    }

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
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const T* vc = v_s + (kk * 16 + 2 * t) * P + n * 8 + g;
          mma_16816(acc[n], a, pack_raw(vc[0], vc[P]),
                    pack_raw(vc[8 * P], vc[9 * P]));
        }
      }
    } else {
      float* pw = p_s + warp * 16 * kPStride;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pw[(g + 8 * (e >> 1)) * kPStride + j * 8 + 2 * t + (e & 1)] = s[j][e];
      __syncwarp();
      for (int key = 0; key < kBlockK; ++key) {
        const float p_lo = pw[g * kPStride + key];
        const float p_hi = pw[(g + 8) * kPStride + key];
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const float v_a = v_s[key * P + n * 8 + 2 * t];
          const float v_b = v_s[key * P + n * 8 + 2 * t + 1];
          acc[n][0] = fmaf(p_lo, v_a, acc[n][0]);
          acc[n][1] = fmaf(p_lo, v_b, acc[n][1]);
          acc[n][2] = fmaf(p_hi, v_a, acc[n][2]);
          acc[n][3] = fmaf(p_hi, v_b, acc[n][3]);
        }
      }
      __syncwarp();
    }
  }

  // normalise and store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = quad_sum(l[r]);
    const int row = q0 + row0 + 8 * r;
    if (row >= p.Sq) continue;
    const float inv = denom > 0.f ? 1.f / denom : 0.f;
    T* orow = static_cast<T*>(p.o) + b * p.o_sb + (long long)row * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = acc[n][2 * r] * inv, x1 = acc[n][2 * r + 1] * inv;
      if constexpr (kBf16) {
        *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) = pack_bf16(x0, x1);
      } else {
        *reinterpret_cast<float2*>(orow + n * 8 + 2 * t) = make_float2(x0, x1);
      }
    }
    if (t == 0)
      p.lse[((long long)b * p.H + h) * p.Sq + row] =
          denom > 0.f ? m[r] + logf(denom) : kLseMasked;
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, p.B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
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
    if (D == 64) return launch<bf16, 64>(p, s);
    if (D == 128) return launch<bf16, 128>(p, s);
  } else {
    if (D == 64) return launch<float, 64>(p, s);
    if (D == 128) return launch<float, 128>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}
