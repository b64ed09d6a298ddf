// Batched matrix exponential, forward only.
//
// Replaces the TPU kernel imm_tsf_tpu/ops/pallas/expm_kernel.py
// (expm_pallas -> _expm_kernel -> expm_value): exp(M) of every matrix of
// M [B, n, n] float32, n <= 64, by the tiered Taylor scheme of expm.cuh
// (Taylor-4 at ||M||inf <= 1/32, else Taylor-12 on M/2^k and the k
// squarings that matrix needs).
//
// Bound on an H100: operations. A matrix costs 2 products (Taylor-4) or
// 5 + k (Taylor-12), 2n^3 FLOPs each, against 8n^2 bytes in and out: at
// n = 64 that is 32-192 FLOPs a byte, above the card's 20 FLOPs a byte in
// float32 outside the tensor cores (67 TFLOP/s over 3.35 TB/s).
//
// Design: one block of 256 threads per matrix, its powers and
// accumulators in five 64 x 68 float buffers of shared memory (87 KB, so
// the kernel opts in above 48 KB); the inf-norm is a block reduction, the
// tier and the squaring count are chosen per matrix, so each matrix runs
// only the products it needs (the TPU kernel chose one tier per batch
// tile). A matrix with n < 64 is zero-padded to 64 in shared memory. At the
// CRU's [64, 64, 64] the grid is 64 blocks, under half of the 132 SMs.
// Plain float32 FMA; tensor cores (TF32 wgmma) would change the float32
// contract the JAX package pins for this expm.

#include "expm.cuh"

namespace {

__global__ void __launch_bounds__(expm::kThreads)
expm_kernel(const float* __restrict__ in, float* __restrict__ out, int n, int max_squarings) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  __shared__ float red[expm::kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * n * n;
  for (int idx = threadIdx.x; idx < expm::kN * expm::kN; idx += expm::kThreads) {
    const int r = idx / expm::kN, c = idx % expm::kN;
    s[r * expm::kLd + c] = (r < n && c < n) ? in[base + r * n + c] : 0.f;
  }
  __syncthreads();
  expm::expm_inplace(s, red, max_squarings);
  for (int idx = threadIdx.x; idx < n * n; idx += expm::kThreads)
    out[base + idx] = s[(idx / n) * expm::kLd + idx % n];
}

}  // namespace

extern "C" int expm_max_n() { return expm::kN; }

// in, out [B, n, n] float32, contiguous; n <= expm_max_n().
extern "C" int expm_forward(const float* in, float* out, int B, int n, int max_squarings,
                            void* stream) {
  if (B < 0 || n <= 0 || n > expm::kN || max_squarings < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(expm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         expm::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  expm_kernel<<<B, expm::kThreads, expm::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      in, out, n, max_squarings);
  return static_cast<int>(cudaGetLastError());
}
