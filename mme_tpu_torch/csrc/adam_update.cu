// Fused AdamW update with bf16 moments over many leaves in one launch, for
// Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mme_tpu/ops/adam_update.py:67 _kernel, which the
// JAX package launches once per leaf. Per element, all arithmetic in fp32:
//
//   m32 = b1 * mu + (1 - b1) * g
//   n32 = b2 * nu + ((1 - b2) * g) * g
//   out = (m32 / bc1) / (sqrt(n32 / bc2) + eps)           (in g's type)
//   mu' = sr_bf16(m32, word & 0xFFFF),  nu' = sr_bf16(n32, word >> 16)
//
// sr_bf16 adds 16 bits of dither to the fp32 bits and keeps the high half.
// The word of element e of a leaf keyed by the 64-bit seed is word e % 4 of
// Philox4x32-10 at counter (e / 4, 0, 0, 0), key (seed low, seed high): a
// function of (seed, e) alone, which ops/adam_update.py::dither_words_plain
// reproduces bit for bit. Every operation rounds to nearest and none is
// contracted into an FMA (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), in
// the order the plain version's torch ops take, so out and the moments
// equal the plain version's bits.
//
// Bound: bytes. Per element g, mu, nu are read and out, mu', nu' written
// once: 16 bytes with an fp32 g, 12 with bf16, against about 12 fp32
// operations and two Philox rounds' worth of integer work per 4 elements.
// At 3.35 TB/s the 619.55 M trainable elements of the TAV model take
// 2.96 ms. The design:
//
// - One launch per optimizer step. The TPU kernel's per-leaf launch cost
//   235 launches (and a size floor that left 512 small leaves to ~24 plain
//   PyTorch kernels each) per step. Here the host packs every leaf into a
//   table of 64-byte records (six pointers, the seed, n and g's type) and
//   one array of first chunks; the table is too large for kernel
//   parameters (32 KB), so the wrapper uploads it with one asynchronous
//   copy from pinned memory on the launch stream before the launch.
// - A leaf is cut into chunks of kChunk elements; block b takes global
//   chunk b. Warp 0 finds the chunk's leaf by a 32-way search over the
//   first-chunk array (two rounds of one coalesced load for up to 1 024
//   leaves) and shares it through shared memory.
// - A thread takes 8 consecutive elements: two 16-byte loads of an fp32 g
//   (one for bf16), one each of mu and nu, two Philox calls (counters
//   e / 4 and e / 4 + 1), and 16-byte stores; streaming loads and stores
//   (ld/st.global.cs), since nothing is read twice. A leaf's ragged end
//   and any leaf whose six base addresses are not all 16-byte aligned take
//   a scalar path with the same words. No shared memory beyond the leaf
//   index, no TMA: one pass, no reuse.
// - In place: out may be g, and mu', nu' may be mu, nu. Each thread reads
//   all of its elements before it writes them, and no two threads share an
//   element, so no pointer is declared __restrict__.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kChunk = 4096;       // elements per block (ops CHUNK)
constexpr int kPerThread = 8;
constexpr int kThreads = kChunk / kPerThread;

// One leaf, as ops/adam_update.py::_table packs it (8 int64 words).
struct alignas(16) Leaf {
  const void* g;
  const uint16_t* mu;
  const uint16_t* nu;
  void* out;
  uint16_t* mu_out;
  uint16_t* nu_out;
  unsigned long long seed;
  long long info;                  // n | (g is bf16) << 32
};
static_assert(sizeof(Leaf) == 64, "the host packs 8 words per leaf");

struct Scalars {
  float b1, omb1, b2, omb2, bc1, bc2, eps;
  int zero_noise;
};

// Philox4x32-10 at counter (c, 0, 0, 0), key (k0, k1).
__device__ __forceinline__ uint4 philox(uint32_t c, uint32_t k0,
                                        uint32_t k1) {
  uint32_t x = c, y = 0, z = 0, w = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, x), lo0 = 0xD2511F53u * x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, z), lo1 = 0xCD9E8D57u * z;
    x = hi1 ^ y ^ k0;
    y = lo1;
    z = hi0 ^ w ^ k1;
    w = lo0;
  }
  return make_uint4(x, y, z, w);
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t h) {
  return __uint_as_float(h << 16);
}

// One element: out in fp32 (the caller casts), moments as bf16 bits.
__device__ __forceinline__ void update(float g, uint32_t mu, uint32_t nu,
                                       uint32_t word, const Scalars& s,
                                       float& out, uint32_t& mu2,
                                       uint32_t& nu2) {
  const float m32 = __fadd_rn(__fmul_rn(s.b1, bf16_bits_to_float(mu)),
                              __fmul_rn(s.omb1, g));
  const float n32 = __fadd_rn(__fmul_rn(s.b2, bf16_bits_to_float(nu)),
                              __fmul_rn(__fmul_rn(s.omb2, g), g));
  out = __fdiv_rn(__fdiv_rn(m32, s.bc1),
                  __fadd_rn(__fsqrt_rn(__fdiv_rn(n32, s.bc2)), s.eps));
  mu2 = (__float_as_uint(m32) + (word & 0xFFFFu)) >> 16;
  nu2 = (__float_as_uint(n32) + (word >> 16)) >> 16;
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Elements e0 .. e0 + 7 of one leaf, kBf16G: g and out are bf16.
template <bool kBf16G>
__device__ __forceinline__ void run8(const Leaf& L, int e0, int n,
                                     const uint32_t (&word)[8],
                                     const Scalars& s) {
  using GT = typename std::conditional<kBf16G, uint16_t, float>::type;
  const GT* gp = static_cast<const GT*>(L.g);
  GT* op = static_cast<GT*>(L.out);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(L.g) |
                          reinterpret_cast<uintptr_t>(L.mu) |
                          reinterpret_cast<uintptr_t>(L.nu) |
                          reinterpret_cast<uintptr_t>(L.out) |
                          reinterpret_cast<uintptr_t>(L.mu_out) |
                          reinterpret_cast<uintptr_t>(L.nu_out);
  const bool aligned = (bases & 15) == 0;
  float g[8], out[8];
  uint32_t mu[8], nu[8], mu2[8], nu2[8];
  if (aligned && e0 + kPerThread <= n) {
    if constexpr (kBf16G) {
      const uint4 v = __ldcs(reinterpret_cast<const uint4*>(gp + e0));
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        g[2 * i] = bf16_bits_to_float(u[i] & 0xFFFFu);
        g[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
      }
    } else {
      const float4 a = __ldcs(reinterpret_cast<const float4*>(gp + e0));
      const float4 b = __ldcs(reinterpret_cast<const float4*>(gp + e0 + 4));
      g[0] = a.x; g[1] = a.y; g[2] = a.z; g[3] = a.w;
      g[4] = b.x; g[5] = b.y; g[6] = b.z; g[7] = b.w;
    }
    const uint4 m = __ldcs(reinterpret_cast<const uint4*>(L.mu + e0));
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(L.nu + e0));
    const uint32_t mw[4] = {m.x, m.y, m.z, m.w};
    const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mu[2 * i] = mw[i] & 0xFFFFu;
      mu[2 * i + 1] = mw[i] >> 16;
      nu[2 * i] = vw[i] & 0xFFFFu;
      nu[2 * i + 1] = vw[i] >> 16;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      update(g[i], mu[i], nu[i], word[i], s, out[i], mu2[i], nu2[i]);
    if constexpr (kBf16G) {
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[i] = bf16_bits(out[2 * i]) | (bf16_bits(out[2 * i + 1]) << 16);
      __stcs(reinterpret_cast<uint4*>(op + e0),
             make_uint4(o[0], o[1], o[2], o[3]));
    } else {
      __stcs(reinterpret_cast<float4*>(op + e0),
             make_float4(out[0], out[1], out[2], out[3]));
      __stcs(reinterpret_cast<float4*>(op + e0 + 4),
             make_float4(out[4], out[5], out[6], out[7]));
    }
    uint32_t mo[4], vo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mo[i] = mu2[2 * i] | (mu2[2 * i + 1] << 16);
      vo[i] = nu2[2 * i] | (nu2[2 * i + 1] << 16);
    }
    __stcs(reinterpret_cast<uint4*>(L.mu_out + e0),
           make_uint4(mo[0], mo[1], mo[2], mo[3]));
    __stcs(reinterpret_cast<uint4*>(L.nu_out + e0),
           make_uint4(vo[0], vo[1], vo[2], vo[3]));
    return;
  }
  // ragged end or an unaligned leaf: one element at a time
  for (int i = 0; i < kPerThread && e0 + i < n; ++i) {
    const int e = e0 + i;
    float gi;
    if constexpr (kBf16G)
      gi = bf16_bits_to_float(gp[e]);
    else
      gi = gp[e];
    float o;
    uint32_t m2, v2;
    update(gi, L.mu[e], L.nu[e], word[i], s, o, m2, v2);
    if constexpr (kBf16G)
      op[e] = static_cast<uint16_t>(bf16_bits(o));
    else
      op[e] = o;
    L.mu_out[e] = static_cast<uint16_t>(m2);
    L.nu_out[e] = static_cast<uint16_t>(v2);
  }
}

// 512 threads, at most 64 registers: two blocks (32 warps) per SM keep
// 64 KB of loads in flight per SM.
__global__ void __launch_bounds__(kThreads, 2)
    mme_adam_update(const Leaf* leaves, const long long* starts,
                    int n_leaves, Scalars s) {
  __shared__ int leaf_of_block;
  const long long chunk = blockIdx.x;
  if (threadIdx.x < 32) {
    // the last leaf whose first chunk is <= chunk; starts[0] == 0
    const int lane = threadIdx.x;
    int lo = 0, hi = n_leaves;
    while (hi - lo > 1) {
      const int step = (hi - lo + 31) >> 5;
      const int j = lo + lane * step;
      const unsigned le =
          __ballot_sync(0xFFFFFFFFu, j < hi && starts[j] <= chunk);
      lo += (31 - __clz(static_cast<int>(le))) * step;
      hi = min(hi, lo + step);
    }
    if (lane == 0) leaf_of_block = lo;
  }
  __syncthreads();
  const int k = leaf_of_block;
  const Leaf L = leaves[k];
  const int n = static_cast<int>(L.info & 0xFFFFFFFFll);
  const int e0 = static_cast<int>(chunk - starts[k]) * kChunk +
                 static_cast<int>(threadIdx.x) * kPerThread;
  if (e0 >= n) return;
  uint32_t word[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (!s.zero_noise) {
    const uint32_t k0 = static_cast<uint32_t>(L.seed);
    const uint32_t k1 = static_cast<uint32_t>(L.seed >> 32);
    const uint32_t c = static_cast<uint32_t>(e0) >> 2;
    const uint4 a = philox(c, k0, k1), b = philox(c + 1, k0, k1);
    word[0] = a.x; word[1] = a.y; word[2] = a.z; word[3] = a.w;
    word[4] = b.x; word[5] = b.y; word[6] = b.z; word[7] = b.w;
  }
  if (L.info >> 32)
    run8<true>(L, e0, n, word, s);
  else
    run8<false>(L, e0, n, word, s);
}

}  // namespace

// table: n_leaves Leaf records, then n_leaves int64 first chunks, in
// device memory written earlier on `stream`; chunks: the total.
extern "C" int mme_adam_update(const void* table, int n_leaves,
                               long long chunks, float b1, float omb1,
                               float b2, float omb2, float bc1, float bc2,
                               float eps, int zero_noise, void* stream) {
  if (n_leaves <= 0 || chunks <= 0 || chunks > INT_MAX ||
      (reinterpret_cast<uintptr_t>(table) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Leaf* leaves = static_cast<const Leaf*>(table);
  const long long* starts = reinterpret_cast<const long long*>(leaves +
                                                               n_leaves);
  const Scalars sc{b1, omb1, b2, omb2, bc1, bc2, eps, zero_noise};
  mme_adam_update<<<static_cast<unsigned>(chunks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(leaves, starts,
                                                         n_leaves, sc);
  return static_cast<int>(cudaGetLastError());
}
