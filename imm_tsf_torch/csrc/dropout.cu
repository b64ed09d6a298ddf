// Flax-mode dropout: flax nn.Dropout's threefry2x32 mask, drawn and applied
// in one pass, forward and backward.
//
// Replaces no Pallas kernel. Under dropout_impl="flax" the JAX package
// draws each site's mask with jax.random.bernoulli from the site's key
// (imm_tsf_tpu/layers/fast_dropout.py:158-163), which XLA fuses with the
// select into elementwise code; this kernel is the port's counterpart:
//
//     site_key = threefry2x32(step_key, (0, site))       // jax.random.fold_in
//     i        = offset + flat index                      // 64-bit
//     (o0, o1) = threefry2x32(site_key, (i >> 32, i & 0xffffffff))
//     u        = bitcast<float>(((o0 ^ o1) >> 9) | 0x3f800000) - 1
//     out[i]   = u < keep_prob ? x[i] / divisor : 0
//
// `site` is flax's hash of the site's scope path and call counter (the
// host computes it, layers/jax_prng.site_hash); the step key is read from
// device memory (two int64 words, each < 2^32), so a captured training
// step replays with the key that the host wrote before the replay. The
// fold runs on the device, once a thread. `offset` places a rank's block
// in the global batch's mask (a data mesh: rank x its numel); the index is
// 64 bits, as JAX's iota_2x32_shape splits it. The backward is the same
// kernel on the incoming gradient: the mask is recomputed, never stored.
//
// `divisor` is keep_prob as the input's type sees it: float32(keep_prob),
// or bf16(keep_prob) for a bf16 input (jnp's weak scalar). The division is
// IEEE (__fdiv_rn; the build has no fast math): x / keep_prob, not x times
// a reciprocal. A bf16 element is divided in float32 and rounded to bf16
// (nearest even), as XLA and torch divide bf16.
//
// Bound on an H100: operations. The site's fold and the key words plus
// their injection constants are a thread's, computed once. An element
// then costs one threefry2x32 block on the INT32 pipe (2 first additions,
// 20 rounds of add, rotate and xor, 5 key injections of 2 additions: 72),
// 3 more for the bits (xor, shift, or) and 2 for the 64-bit index: 77;
// and 3 on the FP32 pipe (u - 1, the compare, the division). Against 8
// bytes moved (float32 in and out), at the card's INT32 rate (132 SMs x 64
// lanes x 1.98 GHz, 16.7 Tops/s) the integer work takes about twice the
// time of the bytes at 3.35 TB/s (chip_smoke.flax_dropout_bound). The
// rotations are funnel shifts (one SHF each). A thread walks a
// grid-stride loop of single elements, neighbouring threads on
// neighbouring addresses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <int R>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, R) ^ x0;
}

// jax._src.prng._threefry2x32_lowering: 20 rounds, a key injection every 4
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k1; x1 += k2 + 1u;
  mix<17>(x0, x1); mix<29>(x0, x1); mix<16>(x0, x1); mix<24>(x0, x1);
  x0 += k2; x1 += k0 + 2u;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k0; x1 += k1 + 3u;
  mix<17>(x0, x1); mix<29>(x0, x1); mix<16>(x0, x1); mix<24>(x0, x1);
  x0 += k1; x1 += k2 + 4u;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k2; x1 += k0 + 5u;
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flax_dropout_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n, uint64_t offset,
                    const int64_t* __restrict__ key, uint32_t site, float keep_prob,
                    float divisor) {
  uint32_t k0 = 0u, k1 = site;  // fold_in(step_key, site)
  threefry2x32(static_cast<uint32_t>(key[0]), static_cast<uint32_t>(key[1]), k0, k1);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; e < n;
       e += stride) {
    const uint64_t i = offset + static_cast<uint64_t>(e);
    uint32_t b0 = static_cast<uint32_t>(i >> 32), b1 = static_cast<uint32_t>(i);
    threefry2x32(k0, k1, b0, b1);
    const float u = __uint_as_float(((b0 ^ b1) >> 9) | 0x3F800000u) - 1.0f;
    const float v = load(x + e);
    store(out + e, u < keep_prob ? __fdiv_rn(v, divisor) : 0.0f);
  }
}

int blocks_for(int64_t n) {
  static int sms_of[64] = {};  // SMs by device ordinal, asked once
  int device = 0;
  cudaGetDevice(&device);
  int& sms = sms_of[device & 63];
  if (sms == 0 && cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != 0)
    sms = 132;
  const int64_t need = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 8;  // 8 blocks of 256 an SM
  return static_cast<int>(need < cap ? need : cap);
}

}  // namespace

// x, out: n elements of float32 (bf16 = 0) or bf16 (bf16 = 1); key: an int64
// [2] device tensor (the step key's two words). Returns cudaGetLastError().
extern "C" int flax_dropout(const void* x, void* out, long long n, long long offset,
                            const void* key, unsigned int site, float keep_prob,
                            float divisor, int bf16, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = blocks_for(n);
  const auto* k = static_cast<const int64_t*>(key);
  if (bf16) {
    flax_dropout_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), n,
        static_cast<uint64_t>(offset), k, site, keep_prob, divisor);
  } else {
    flax_dropout_kernel<float><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n,
        static_cast<uint64_t>(offset), k, site, keep_prob, divisor);
  }
  return static_cast<int>(cudaGetLastError());
}
