// One-pass bfloat16 products on the tensor cores (compute_dtype="bfloat16"):
// shared by the one-pass forms of csrc/ffn.cu (kernel #2) and
// csrc/attn.cu (kernel #3); csrc/recavg.cu (kernel #1) takes the rounding.
//
// The JAX package's DEFAULT-precision product rounds each float32 operand
// to bf16 (round to nearest even) and sums the exact products in float32.
// Operands are rounded where their fragments are loaded
// (__floats2bfloat162_rn: RNE, the lower k in the low half), and
// mma.sync accumulates in float32.
//
// Fragments (g = lane / 4, t = lane % 4), two bf16 a register:
//   m16n8k16  A 16 x 16: a0 A[g][2t..2t+1], a1 A[g+8][2t..], a2 A[g][2t+8..], a3 A[g+8][2t+8..]
//             B 16 x 8:  b0 B[2t..2t+1][g], b1 B[2t+8..2t+9][g]
//   m16n8k8   A 16 x 8:  a0 A[g][2t..2t+1], a1 A[g+8][2t..]
//             B 8 x 8:   b0 B[2t..2t+1][g]
//   C 16 x 8 (both):     c0 C[g][2t], c1 C[g][2t+1], c2 C[g+8][2t], c3 C[g+8][2t+1]

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bf16mma {

// bf16(lo) in the low half, bf16(hi) in the high half, each rounded to nearest even
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x rounded to bf16 (nearest even) and widened back
__device__ __forceinline__ float round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void mma16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma8(float c[4], const uint32_t a[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

}  // namespace bf16mma
