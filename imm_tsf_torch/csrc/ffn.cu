// Fused post-norm encoder FFN, forward only, fp32.
//
// Replaces the TPU kernel imm_tsf_tpu/ops/pallas/ffn_kernel.py
// (fused_encoder_ffn -> _ffn_forward_pallas -> _ffn_kernel):
//
//     h   = drop_a(act(x W1 + b1))          # [M, F], never in device memory
//     out = LayerNorm(x + drop_b(h W2 + b2)) * gamma + beta
//
// with act = relu or tanh-approximate GELU, the hash-dropout bits of
// layers/fast_dropout.py computed inline (index row*n_cols + col in
// wrapping uint32 arithmetic, as the TPU kernel does), and the one-pass
// LayerNorm variance E[r^2] - mu^2 with eps 1e-5.
//
// Bound on an H100: operations. At the serving shape (M=8192, D=512,
// F=2048) the two products are 34.4 GFLOP against 34 MB of compulsory
// traffic, far above the fp32 ridge point; the floor is the 67 TFLOP/s
// non-tensor fp32 rate (~0.5 ms). This first version uses plain fp32 FMA
// (no tensor cores, no TMA); wgmma/bf16 are later work.
//
// Design: one block of 256 threads owns kBM=32 rows and keeps their whole
// [32, D] output sum in registers (warp w owns rows 4w..4w+3; lane l owns
// columns l, l+32, ...; D <= kMaxD). It walks F in chunks of kFC: for each
// chunk it computes the [32, kFC] hidden tile from the resident x tile and
// W1 tiles staged through shared memory, applies bias, activation and
// dropout, parks it in shared memory, and accumulates it times the chunk's
// W2 rows into the registers. The epilogue adds bias, dropout and the
// residual and normalises each row with warp shuffles; rows past M are
// masked, so ragged M needs no host padding. Weights arrive in the
// torch.nn.Linear layout (W1^T [F, D], W2^T [D, F]) so the encoder layer
// passes its parameters without a copy; staged tiles are padded by one
// column to keep shared-memory reads free of bank conflicts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32;                       // rows per block
constexpr int kThreads = 256;                 // 8 warps
constexpr int kRows = kBM / (kThreads / 32);  // rows per warp = 4
constexpr int kFC = 128;                      // hidden columns per chunk
constexpr int kKT = 32;                       // depth of one staged weight tile
constexpr int kPad = kKT + 1;                 // padded row of a staged tile
constexpr int kMaxD = 512;
constexpr int kCols = kMaxD / 32;             // output columns per lane
constexpr int kHCols = kFC / 32;              // hidden columns per lane
constexpr float kEps = 1e-5f;

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ bool keep_bit(uint32_t i, uint32_t s0, uint32_t s1,
                                         uint32_t thresh) {
  return fmix(fmix((i * 0x9E3779B1u) ^ s0) ^ s1) < thresh;
}

__device__ __forceinline__ float activation(float a, int act) {
  if (act == 0) return fmaxf(a, 0.f);
  // jax.nn.gelu(approximate=True)
  const float kSqrt2OverPi = 0.7978845608028654f;
  return a * (0.5f * (1.f + tanhf(kSqrt2OverPi * (a + 0.044715f * (a * a * a)))));
}

__global__ void __launch_bounds__(kThreads, 1)
ffn_kernel(const float* __restrict__ x, const float* __restrict__ w1t,
           const float* __restrict__ b1, const float* __restrict__ w2t,
           const float* __restrict__ b2, const float* __restrict__ gamma,
           const float* __restrict__ beta, const long long* __restrict__ salts,
           float* __restrict__ out, int M, int D, int F, float keep_prob,
           uint32_t thresh, int act, int apply_dropout) {
  extern __shared__ float smem[];
  float* xs = smem;              // [kBM][D]   x tile
  float* hs = xs + kBM * D;      // [kBM][kFC] hidden chunk
  float* ws = hs + kBM * kFC;    // staged W1 tile [kFC][kPad] or W2 tile [D][kPad]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * kRows;   // this warp's first row in the tile
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;

  uint32_t s0a = 0, s1a = 0, s0b = 0, s1b = 0;
  if (apply_dropout) {
    s0a = static_cast<uint32_t>(salts[0]);
    s1a = static_cast<uint32_t>(salts[1]);
    s0b = static_cast<uint32_t>(salts[2]);
    s1b = static_cast<uint32_t>(salts[3]);
  }

  for (int i = tid; i < kBM * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    xs[i] = row0 + r < M ? x[(row0 + r) * D + c] : 0.f;
  }

  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;
  __syncthreads();

  for (int f0 = 0; f0 < F; f0 += kFC) {
    // ---- hidden chunk h[32, kFC] = x W1[:, f0:f0+kFC] ----
    float h[kRows][kHCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int q = 0; q < kHCols; ++q) h[r][q] = 0.f;

    for (int k0 = 0; k0 < D; k0 += kKT) {
      for (int i = tid; i < kFC * kKT; i += kThreads) {
        const int f = i / kKT, k = i - f * kKT;  // k fastest: coalesced rows of W1^T
        const int gf = f0 + f, gk = k0 + k;
        ws[f * kPad + k] = (gf < F && gk < D) ? w1t[static_cast<long long>(gf) * D + gk] : 0.f;
      }
      __syncthreads();
      const int kmax = min(kKT, D - k0);
      for (int k = 0; k < kmax; ++k) {
        float xv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) xv[r] = xs[(r0 + r) * D + k0 + k];
#pragma unroll
        for (int q = 0; q < kHCols; ++q) {
          const float wv = ws[(lane + 32 * q) * kPad + k];
#pragma unroll
          for (int r = 0; r < kRows; ++r) h[r][q] = fmaf(xv[r], wv, h[r][q]);
        }
      }
      __syncthreads();
    }

    // bias, activation, hidden dropout; columns past F contribute zero
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const uint32_t row = static_cast<uint32_t>(row0 + r0 + r);
#pragma unroll
      for (int q = 0; q < kHCols; ++q) {
        const int f = lane + 32 * q, gf = f0 + f;
        float v = 0.f;
        if (gf < F) {
          v = activation(h[r][q] + b1[gf], act);
          if (apply_dropout)
            v = keep_bit(row * static_cast<uint32_t>(F) + static_cast<uint32_t>(gf),
                         s0a, s1a, thresh) ? v / keep_prob : 0.f;
        }
        hs[(r0 + r) * kFC + f] = v;
      }
    }
    __syncthreads();

    // ---- acc[32, D] += h W2[f0:f0+kFC, :], kKT hidden rows at a time ----
    for (int s = 0; s < kFC; s += kKT) {
      for (int i = tid; i < D * kKT; i += kThreads) {
        const int c = i / kKT, f = i - c * kKT;  // f fastest: coalesced rows of W2^T
        const int gf = f0 + s + f;
        ws[c * kPad + f] = gf < F ? w2t[static_cast<long long>(c) * F + gf] : 0.f;
      }
      __syncthreads();
      for (int f = 0; f < kKT; ++f) {
        float hv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) hv[r] = hs[(r0 + r) * kFC + s + f];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = lane + 32 * j;
          const float wv = c < D ? ws[c * kPad + f] : 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][j] = fmaf(hv[r], wv, acc[r][j]);
        }
      }
      __syncthreads();
    }
  }

  // ---- epilogue: bias, output dropout, residual, row LayerNorm ----
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long row = row0 + r0 + r;
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + 32 * j;
      if (c < D) {
        float a2 = acc[r][j] + b2[c];
        if (apply_dropout)
          a2 = keep_bit(static_cast<uint32_t>(row) * static_cast<uint32_t>(D) +
                            static_cast<uint32_t>(c), s0b, s1b, thresh)
                   ? a2 / keep_prob : 0.f;
        const float rv = xs[(r0 + r) * D + c] + a2;
        acc[r][j] = rv;
        sum += rv;
        sq += rv * rv;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    const float mu = sum / D;
    const float var = sq / D - mu * mu;
    const float rstd = 1.f / sqrtf(var + kEps);
    if (row < M) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = lane + 32 * j;
        if (c < D) out[row * D + c] = (acc[r][j] - mu) * rstd * gamma[c] + beta[c];
      }
    }
  }
}

size_t smem_bytes(int D) {
  const int staged = (kFC > D ? kFC : D) * kPad;
  return sizeof(float) * (static_cast<size_t>(kBM) * D + kBM * kFC + staged);
}

}  // namespace

extern "C" int ffn_max_d() { return kMaxD; }

extern "C" int ffn_forward(const float* x, const float* w1t, const float* b1,
                           const float* w2t, const float* b2,
                           const float* gamma, const float* beta,
                           const long long* salts, float* out, int M, int D,
                           int F, float keep_prob, unsigned int thresh, int act,
                           int apply_dropout, void* stream) {
  if (D < 1 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  // set on every call: the attribute belongs to the current device's context
  const cudaError_t e = cudaFuncSetAttribute(
      ffn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxD)));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (M + kBM - 1) / kBM;
  ffn_kernel<<<blocks, kThreads, smem_bytes(D), static_cast<cudaStream_t>(stream)>>>(
      x, w1t, b1, w2t, b2, gamma, beta, salts, out, M, D, F, keep_prob, thresh,
      act, apply_dropout);
  return static_cast<int>(cudaGetLastError());
}
