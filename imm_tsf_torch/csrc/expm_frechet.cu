// Batched Frechet derivative of the matrix exponential: the backward of
// the expm on the CRU's default route.
//
// Replaces the TPU kernel imm_tsf_tpu/ops/pallas/expm_kernel.py
// (expm_frechet_pallas -> _expm_frechet_kernel -> frechet_value):
// L_exp(M)[E] of every pair of M, E [B, n, n] float32, n <= 64, by the
// (value, derivative) pair recursion of frechet.cuh: Taylor-12 on M/2^k
// and the k squarings that matrix needs. ops/expm.py calls it with M^T and
// the cotangent G, which gives the expm's adjoint L_exp(M^T)[G].
//
// Bound on an H100: operations. A matrix costs 3 (5 + k) products of 2n^3
// FLOPs against 12n^2 bytes in and out: at n = 64 that is 160 FLOPs a
// byte and more, far above the card's 20 FLOPs a byte in float32 outside
// the tensor cores.
//
// Design: one block of 256 threads per matrix, as kernel #5, its pairs in
// eight 64 x 68 float buffers of shared memory (139,264 bytes: the
// polynomial's pieces overwrite powers that are no longer read, so ten
// live pairs fit). The squaring count is chosen per matrix. At the CRU's
// [32, 64, 64] the grid is 32 blocks on 132 SMs. Plain float32 FMA, as
// kernel #5: the JAX package pins this expm and its derivative to full
// float32.

#include "frechet.cuh"

namespace {

__global__ void __launch_bounds__(expm::kThreads)
frechet_kernel(const float* __restrict__ M, const float* __restrict__ E, float* __restrict__ out,
               int n, int max_squarings) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  __shared__ float red[expm::kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * n * n;
  for (int idx = threadIdx.x; idx < expm::kN * expm::kN; idx += expm::kThreads) {
    const int r = idx / expm::kN, c = idx % expm::kN;
    const bool in = r < n && c < n;
    s[r * expm::kLd + c] = in ? M[base + r * n + c] : 0.f;
    s[expm::kMat + r * expm::kLd + c] = in ? E[base + r * n + c] : 0.f;
  }
  __syncthreads();
  expm::frechet_inplace(s, red, max_squarings);
  for (int idx = threadIdx.x; idx < n * n; idx += expm::kThreads)
    out[base + idx] = s[expm::kMat + (idx / n) * expm::kLd + idx % n];
}

}  // namespace

extern "C" int expm_frechet_max_n() { return expm::kN; }

// M, E, out [B, n, n] float32, contiguous; n <= expm_frechet_max_n().
extern "C" int expm_frechet_forward(const float* M, const float* E, float* out, int B, int n,
                                    int max_squarings, void* stream) {
  if (B < 0 || n <= 0 || n > expm::kN || max_squarings < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(frechet_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         expm::kFrechetSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  frechet_kernel<<<B, expm::kThreads, expm::kFrechetSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(M, E, out, n, max_squarings);
  return static_cast<int>(cudaGetLastError());
}
