// Float32 products on the tensor cores as three TF32 passes (3xTF32), and
// cp.async copies: shared by csrc/attn.cu (kernel #3) and csrc/ffn.cu
// (kernel #2).
//
// One TF32 pass keeps 10 mantissa bits and misses a float32 contract. Each
// float32 operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna's rounding), and a product takes lo*hi, hi*lo and hi*hi,
// accumulated in float32 by mma.sync m16n8k8: the dropped lo*lo term is
// below 2^-21 relative. tests/test_torch_attn_tf32x3.py and
// tests/test_torch_tf32x3_ffn_frechet.py emulate the scheme on the CPU.
//
// Fragments of mma.sync.m16n8k8 (g = lane / 4, t = lane % 4):
//   A 16 x 8, row-major:  a0 A[g][t], a1 A[g + 8][t], a2 A[g][t + 4], a3 A[g + 8][t + 4]
//   B  8 x 8, B[k][n]:    b0 B[t][g], b1 B[t + 4][g]
//   C 16 x 8:             c0 C[g][2t], c1 C[g][2t + 1], c2 C[g + 8][2t], c3 C[g + 8][2t + 1]
// With every operand stored k-contiguous (A as rows of A, B as rows of
// B^T) at a row stride of 4 modulo 32 floats, each fragment load is free
// of bank conflicts.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// the bits of cvt.rna.tf32.f32(x) for finite x (round the magnitude to 10
// mantissa bits, ties away from zero) by two integer operations: the
// conversion instruction issues at 16 a cycle on an SM, these at 64
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 2^-21 relative, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void split4(const float a[4], uint32_t ah[4], uint32_t al[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], ah[i], al[i]);
}

// c[n] += a b[n] for N tiles, a and b[n] already split: lo*hi, hi*lo, then
// hi*hi on each accumulator, each pass over all N tiles before the next, so
// that N independent mma lie between two that share an accumulator
template <int N>
__device__ __forceinline__ void mma_3xtf32(float c[N][4], const uint32_t ah[4],
                                           const uint32_t al[4], const uint32_t bh[N][2],
                                           const uint32_t bl[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], ah, bh[n]);
}

// 16 bytes from global to shared memory; zeros when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

// 4 bytes from global to shared memory; zero when !ok (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace tf32x3
