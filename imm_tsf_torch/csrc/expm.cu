// Batched matrix exponential, forward only.
//
// Replaces the TPU kernel imm_tsf_tpu/ops/pallas/expm_kernel.py
// (expm_pallas -> _expm_kernel -> expm_value): exp(M) of every matrix of
// M [B, n, n] float32, n <= 64, by the tiered Taylor scheme of expm.cuh
// (Taylor-4 at ||M||inf <= 1/32, else Taylor-12 on M/2^k and the k
// squarings that matrix needs).
//
// Bound on an H100: operations. A matrix costs 2 products (Taylor-4) or
// 5 + k (Taylor-12), 2n^3 FLOPs each (n^3 for a block triangular matrix,
// below), against 8n^2 bytes in and out: at n = 64 that is 16-192 FLOPs a
// byte, above the card's 20 FLOPs a byte in float32 outside the tensor
// cores (67 TFLOP/s over 3.35 TB/s) for all but the Taylor-4 tier.
//
// Design: one block of 128 threads a matrix. It loads the matrix,
// zero-padded to 64 x 64, into the first of five 64 x 68 float buffers
// (87 KB of shared memory) and checks whether the lower-left 32 x 32 block
// is exactly zero (== 0.f; a NaN is not zero):
//   - block triangular: expm.cuh's expm_tri_inplace, three block products
//     a product (half the FMAs of the dense form; bit for bit its result on
//     finite inputs, up to the sign of a zero), a 2 x 4 patch of each of
//     UL, UR and LR a thread. Every n <= 32 and the CRU's Van Loan blocks
//     [[A, Q], [0, -A^T]] dt at lsd 32 (ops/cru_scan.py) take it.
//   - dense: expm.cuh's expm_inplace, an 8 x 4 patch a thread (team.cuh's
//     Cluster<1, false, 128>), two barriers a squaring.
// Both are kernels of this file; neither stands in for the other. The tier
// and the squaring count are chosen per matrix, so each matrix runs only
// the products it needs (the TPU kernel chose one tier per batch tile). At
// the CRU's [64, 64, 64] the grid is 64 blocks, under half of the 132 SMs;
// splitting a matrix over a thread-block cluster to fill the rest was
// measured slower (PERF.md) and is not kept.
// Plain float32 FMA; tensor cores (TF32 wgmma) would change the float32
// contract the JAX package pins for this expm.

#include "team.cuh"

namespace {

using expm::kH;
using expm::kTriThreads;
using Dense = expm::Cluster<1, false, kTriThreads>;  // the dense form on the same 128 threads

__global__ void __launch_bounds__(kTriThreads)
expm_kernel(const float* __restrict__ in, float* __restrict__ out, int n, int max_squarings) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  __shared__ float red[kTriThreads / 32];
  const long long base = static_cast<long long>(blockIdx.x) * n * n;
  bool lower = false;  // a nonzero (or NaN) in the lower-left block
  if (n == expm::kN) {
#pragma unroll 4
    for (int idx = threadIdx.x; idx < expm::kN * expm::kN / 4; idx += kTriThreads) {
      const int r = idx / (expm::kN / 4), c = (idx % (expm::kN / 4)) * 4;
      const float4 v = reinterpret_cast<const float4*>(in + base)[idx];
      *reinterpret_cast<float4*>(s + r * expm::kLd + c) = v;
      if (r >= kH && c < kH) lower |= !(v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f);
    }
  } else {
    for (int idx = threadIdx.x; idx < expm::kN * expm::kN; idx += kTriThreads) {
      const int r = idx / expm::kN, c = idx % expm::kN;
      const float v = (r < n && c < n) ? in[base + r * n + c] : 0.f;
      s[r * expm::kLd + c] = v;
      if (r >= kH && c < kH) lower |= !(v == 0.f);
    }
  }
  const bool tri = __syncthreads_or(lower) == 0;
  const float* E = s;
  if (tri) {
    // the other buffers' lower-left blocks: never written by the
    // triangular form, read here only by the output of buffer 4
    for (int idx = threadIdx.x; idx < kH * kH; idx += kTriThreads)
      s[4 * expm::kMat + (kH + idx / kH) * expm::kLd + idx % kH] = 0.f;
    __syncthreads();
    E = expm::expm_tri_inplace(s, red, max_squarings);
  } else {
    expm::expm_inplace<Dense>(s, red, max_squarings);
  }
  if (n == expm::kN) {
    for (int idx = threadIdx.x; idx < expm::kN * expm::kN / 4; idx += kTriThreads) {
      const int r = idx / (expm::kN / 4), c = (idx % (expm::kN / 4)) * 4;
      reinterpret_cast<float4*>(out + base + r * expm::kN)[c / 4] =
          *reinterpret_cast<const float4*>(E + r * expm::kLd + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < n * n; idx += kTriThreads)
      out[base + idx] = E[(idx / n) * expm::kLd + idx % n];
  }
}

}  // namespace

extern "C" int expm_max_n() { return expm::kN; }

// in, out [B, n, n] float32, contiguous (16-byte aligned); n <= expm_max_n().
extern "C" int expm_forward(const float* in, float* out, int B, int n, int max_squarings,
                            void* stream) {
  if (B < 0 || n <= 0 || n > expm::kN || max_squarings < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(expm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         expm::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  expm_kernel<<<B, kTriThreads, expm::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      in, out, n, max_squarings);
  return static_cast<int>(cudaGetLastError());
}
