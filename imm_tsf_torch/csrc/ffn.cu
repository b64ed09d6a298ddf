// Fused post-norm encoder FFN on the tensor cores in float32 accuracy
// (3xTF32), in the TPU kernel's two forms: eval and training.
//
// Replaces the TPU kernel imm_tsf_tpu/ops/pallas/ffn_kernel.py
// (fused_encoder_ffn -> _ffn_forward_pallas -> _ffn_kernel):
//
//     a1  = x W1 + b1                       # [M, F]
//     h   = drop_a(act(a1))                 # [M, F], never in device memory
//     r   = x + drop_b(h W2 + b2)           # [M, D]
//     out = LayerNorm(r) * gamma + beta
//
// with act = relu or tanh-approximate GELU, the hash-dropout bits of
// layers/fast_dropout.py computed inline (index (row_base + row)*n_cols + col
// in wrapping uint32 arithmetic, as the TPU kernel does for row_base 0; a
// rank of a data mesh passes its first global row), and the one-pass
// LayerNorm variance E[r^2] - mu^2 with eps 1e-5. The training form
// (kResiduals) also writes a1 and r, the residuals of the backward
// (plain PyTorch, kernels/ffn.py:ffn_backward_reference), from the
// registers that hold them; the eval form writes out only, as the JAX
// package skips the residuals in eval.
//
// Bound on an H100: operations. At the serving shape (M=8192, D=512,
// F=2048) the two products are 34.4 GFLOP against 34 MB of compulsory
// traffic (the training form adds 84 MB of a1 and r: 0.025 ms at 3.35
// TB/s). Both run as three TF32 passes on the tensor cores (tf32x3.cuh:
// float32 accuracy), so the floor is 3 x 34.4 GFLOP at the 495 TFLOP/s
// TF32 peak, ~0.21 ms (plain fp32 FMA: ~0.51 ms).
//
// Design. A block of 256 threads (8 warps) owns kBM = 64 rows: 128 blocks
// at M 8192, one wave. It keeps the x tile [64, D] in shared memory for
// the whole call and the [64, D] output sum in registers (warp (wm, wn):
// rows 32 wm.., columns 128 wn.., 2 x 16 mma tiles). It walks F in chunks
// of kFC = 128 hidden columns: for each chunk, GEMM1 computes h[64, 128] =
// x W1[:, chunk] (warp tile 32 x 32) over D in steps of kK1 = 32, then
// bias, activation and hidden dropout park h in shared memory, and GEMM2
// adds h W2[chunk, :] to the output sum in steps of kK2 = 8 hidden rows.
// The weights stream through a ring of kStages = 2 shared-memory stages by
// 16-byte cp.async, a tile ahead of the mma: a W1 tile [128 f][32 d] or a
// W2 tile [512 d][8 f], each 16 KB, in the torch.nn.Linear layout (W1^T
// [F, D], W2^T [D, F]: every operand is read along its reduced dimension,
// so no transpose; each fragment register pair is one 8-byte load, free of
// bank conflicts). Each block reads all of W1 and W2 (8 MB; 1 GB of L2
// traffic a call at M 8192). The x tile and the h chunk leave room for two
// stages only; four stages of half-width chunks (64 hidden columns) sped
// the weight stream but made GEMM1's warp tiles smaller, and were slower
// on the whole (PERF.md). The epilogue adds bias, dropout and the residual
// and normalises each row: a quad of lanes, then the four warps that share
// a row, sum r and r^2 through shared memory. Rows past M are masked, so
// ragged M needs no host padding; columns past D and hidden units past F
// are zero-filled. The training form's stores are a thread's two adjacent
// columns of an mma tile, one 8-byte store where the row allows it.
//
// The bfloat16-weight form (`ffn_forward_bf16w`, compute_dtype="amp_bf16":
// the JAX package hands the TPU kernel float32 x and bf16 W1, b1, W2, b2,
// gamma and beta, which it widens in its body, ffn_kernel.py:76-83) is the
// same kernel with W = __nv_bfloat16: the weight tiles stream as bf16 (half
// the bytes; a 16-byte cp.async carries 8 of them, rows of 40 and 8 halves
// keep the 4-byte fragment loads free of bank conflicts) and are widened
// where the fragments are loaded, the vectors where they are read. A
// widened bf16 is exact in TF32, so its 3xTF32 low part is zero: that pass
// is dropped (the sum is the same bits) and each product takes two passes.
// x, out, a1 and r stay float32.
//
// The one-pass form (`ffn_forward_bf16`, compute_dtype="bfloat16": the
// JAX package's two dots at DEFAULT precision, ffn_kernel.py:76-90) is the
// same kernel with kOnePass on float32 weights: x and W1, then h (after
// the activation and the hidden dropout) and W2, are rounded to bf16
// (nearest even) where their fragments are loaded, and each product is one
// bf16 mma.sync pass with float32 accumulators (bf16mma.cuh): GEMM1
// m16n8k16 over two 16-deep steps of a W1 tile, GEMM2 m16n8k8 over the
// 8-deep W2 tile (a W2 tile of 16 hidden rows would not fit a stage). The
// tiles, the staging, the epilogue (bias, output dropout, residual on the
// float32 x, LayerNorm) and the hash bits are the float32 form's. Its
// products need a third of the 3xTF32 passes at twice TF32's rate: the
// floor at the serving shape is 34.4 GFLOP at 989 TFLOP/s, ~0.035 ms, under
// the weight stream's ~1 GB of L2 reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16mma.cuh"
#include "tf32x3.cuh"

namespace {

using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::mma_tf32;
using tf32x3::split;

constexpr int kBM = 64;                // rows per block
constexpr int kThreads = 256;          // 8 warps: 2 (rows) x 4 (columns)
constexpr int kMaxD = 512;
constexpr int kFC = 128;               // hidden columns per chunk
constexpr int kK1 = 32;                // depth (along D) of a W1 tile
constexpr int kK2 = 8;                 // depth (along F) of a W2 tile
constexpr int kXLd = kMaxD + 8;        // row strides (floats), 8 modulo 32
constexpr int kHLd = kFC + 8;
constexpr int kW1Ld = kK1 + 8;
constexpr int kW2Ld = kK2;
constexpr int kStage = kFC * kW1Ld;    // floats of a stage: a W1 tile (a W2 tile is smaller)
constexpr int kStages = 2;             // weight tiles in flight: kStages - 1 ahead of the mma
constexpr int kNT1 = kFC / 4 / 8;      // GEMM1 mma column tiles of a warp: 4
constexpr int kNT2 = kMaxD / 4 / 8;    // GEMM2 mma column tiles of a warp: 16
constexpr int kSmemFloats = kBM * kXLd + kBM * kHLd + kStages * kStage + 2 * kBM * 4;
constexpr float kEps = 1e-5f;

static_assert(kMaxD * kW2Ld <= kStage, "a W2 tile fits a stage");

// What the kernel reads of a weight type: float32 (split into two TF32
// parts) or bfloat16 (exact in TF32: one part, and no hi x lo pass).
template <typename W>
struct Weights;

template <>
struct Weights<float> {
  static constexpr bool kSplit = true;
  static __device__ __forceinline__ float to_f(float v) { return v; }
};

template <>
struct Weights<__nv_bfloat16> {
  static constexpr bool kSplit = false;
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
};

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

// src[row, col..col + 3] of a row-major matrix (rows x cols, row stride
// ld) into dst, zeros outside the matrix; 16-byte copies when `vec` (cols
// and col multiples of 4, 16-byte aligned rows), else 4-byte copies
__device__ __forceinline__ void copy4(float* dst, const float* src, long long row, int col,
                                      long long rows, int cols, int ld, bool vec) {
  const bool in_row = row < rows;
  if (vec) {
    const bool ok = in_row && col < cols;
    cp_async16(dst, ok ? src + row * ld + col : src, ok);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = in_row && col + j < cols;
      cp_async4(dst + j, ok ? src + row * ld + col + j : src, ok);
    }
  }
}

// a weight tile's 16 bytes of src[row, col..]: copy4 for float32; for
// bfloat16 eight halves, one 16-byte cp.async when `vec`, else plain loads
// (no cp.async moves 2 bytes), which the next __syncthreads publishes
__device__ __forceinline__ void copy_w(float* dst, const float* src, long long row, int col,
                                       long long rows, int cols, int ld, bool vec) {
  copy4(dst, src, row, col, rows, cols, ld, vec);
}

__device__ __forceinline__ void copy_w(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                       long long row, int col, long long rows, int cols, int ld,
                                       bool vec) {
  const bool in_row = row < rows;
  if (vec) {
    const bool ok = in_row && col < cols;
    cp_async16(reinterpret_cast<float*>(dst),
               reinterpret_cast<const float*>(ok ? src + row * ld + col : src), ok);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool ok = in_row && col + j < cols;
      dst[j] = ok ? src[row * ld + col + j] : __float2bfloat16(0.f);
    }
  }
}

// The k of each 8-deep mma step is permuted: fragment column t holds
// k = 2t and column t + 4 holds k = 2t + 1, in A and in B alike (the sum
// over k does not depend on its order), so each fragment register pair is
// one 8-byte load; row strides of 8 modulo 32 floats keep them free of
// bank conflicts.

// a[mi] = rows (16 mi + g, + 8) x k (2t, 2t + 1) of a row-major tile, split
__device__ __forceinline__ void load_a(const float* s, int ld, int g, int t, uint32_t ah[2][4],
                                       uint32_t al[2][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const float* p = s + (16 * mi + g) * ld + 2 * t;
    const float2 lo = *reinterpret_cast<const float2*>(p);
    const float2 hi = *reinterpret_cast<const float2*>(p + 8 * ld);
    split(lo.x, ah[mi][0], al[mi][0]);
    split(hi.x, ah[mi][1], al[mi][1]);
    split(lo.y, ah[mi][2], al[mi][2]);
    split(hi.y, ah[mi][3], al[mi][3]);
  }
}

// b = B[k 2t][g], B[2t + 1][g] of the tile whose B^T rows start at s, split
__device__ __forceinline__ void load_b(const float* s, int ld, int g, int t, uint32_t bh[2],
                                       uint32_t bl[2]) {
  const float2 v = *reinterpret_cast<const float2*>(s + g * ld + 2 * t);
  split(v.x, bh[0], bl[0]);
  split(v.y, bh[1], bl[1]);
}

// the same fragment of a bfloat16 tile: one 4-byte load of B[2t][g] and
// B[2t + 1][g], widened by a shift (exact in TF32, so no low part)
__device__ __forceinline__ void load_b(const __nv_bfloat16* s, int ld, int g, int t,
                                       uint32_t bh[2], uint32_t bl[2]) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(s + g * ld + 2 * t);
  bh[0] = v << 16;
  bh[1] = v & 0xffff0000u;
  bl[0] = bl[1] = 0u;
}

// dst[row, col] and dst[row, col + 1] (col even) of a row-major rows x cols
// matrix, the parts inside it: one 8-byte store when cols is even (then
// col + 1 < cols and the address is 8-byte aligned), else one store each
__device__ __forceinline__ void store_pair(float* dst, long long row, int col, long long rows,
                                           int cols, float v0, float v1) {
  if (row >= rows || col >= cols) return;
  float* p = dst + row * cols + col;
  if ((cols & 1) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (col + 1 < cols) p[1] = v1;
  }
}

// c[mi][n0 + n] += a[mi] b[n] (n < N) in three passes, each over all 2 N
// accumulators before the next; two (no ah bl) when b has no low part
template <int N, int NC, bool kSplitB>
__device__ __forceinline__ void mma_block(float c[2][NC][4], int n0, const uint32_t ah[2][4],
                                          const uint32_t al[2][4], const uint32_t bh[N][2],
                                          const uint32_t bl[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) mma_tf32(c[mi][n0 + n], al[mi], bh[n]);
  if (kSplitB) {
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma_tf32(c[mi][n0 + n], ah[mi], bl[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) mma_tf32(c[mi][n0 + n], ah[mi], bh[n]);
}

// the one-pass form's fragments (bf16mma.cuh), rounded from float32 tiles:
// A rows (16 mi + g, + 8) x k (2t, 2t + 1 | 2t + 8, 2t + 9), 8-byte loads
__device__ __forceinline__ void load_a16(const float* s, int ld, int g, int t, uint32_t a[2][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const float* p = s + (16 * mi + g) * ld + 2 * t;
    const float2 r0 = *reinterpret_cast<const float2*>(p);
    const float2 r1 = *reinterpret_cast<const float2*>(p + 8 * ld);
    const float2 r2 = *reinterpret_cast<const float2*>(p + 8);
    const float2 r3 = *reinterpret_cast<const float2*>(p + 8 * ld + 8);
    a[mi][0] = bf16mma::pack(r0.x, r0.y);
    a[mi][1] = bf16mma::pack(r1.x, r1.y);
    a[mi][2] = bf16mma::pack(r2.x, r2.y);
    a[mi][3] = bf16mma::pack(r3.x, r3.y);
  }
}

// A rows (16 mi + g, + 8) x k (2t, 2t + 1) of an 8-deep step
__device__ __forceinline__ void load_a8(const float* s, int ld, int g, int t, uint32_t a[2][2]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const float* p = s + (16 * mi + g) * ld + 2 * t;
    const float2 r0 = *reinterpret_cast<const float2*>(p);
    const float2 r1 = *reinterpret_cast<const float2*>(p + 8 * ld);
    a[mi][0] = bf16mma::pack(r0.x, r0.y);
    a[mi][1] = bf16mma::pack(r1.x, r1.y);
  }
}

// B[k][g] for k (2t, 2t + 1 | 2t + 8, 2t + 9) of the tile whose B^T rows start at s
__device__ __forceinline__ void load_b16(const float* s, int ld, int g, int t, uint32_t b[2]) {
  const float2 v0 = *reinterpret_cast<const float2*>(s + g * ld + 2 * t);
  const float2 v1 = *reinterpret_cast<const float2*>(s + g * ld + 2 * t + 8);
  b[0] = bf16mma::pack(v0.x, v0.y);
  b[1] = bf16mma::pack(v1.x, v1.y);
}

__device__ __forceinline__ uint32_t load_b8(const float* s, int ld, int g, int t) {
  const float2 v = *reinterpret_cast<const float2*>(s + g * ld + 2 * t);
  return bf16mma::pack(v.x, v.y);
}

// kResiduals: the training form, which also writes a1 [M, F] and r [M, D];
// W: the weights' type (float, or __nv_bfloat16 for the bf16-weight form);
// kOnePass: the one-pass bf16 form (W float)
template <bool kResiduals, typename W, bool kOnePass>
__global__ void __launch_bounds__(kThreads, 1)
ffn_kernel(const float* __restrict__ x, const W* __restrict__ w1t,
           const W* __restrict__ b1, const W* __restrict__ w2t,
           const W* __restrict__ b2, const W* __restrict__ gamma,
           const W* __restrict__ beta, float* __restrict__ out,
           float* __restrict__ a1_out, float* __restrict__ r_out, int M, int D, int F,
           float keep_prob, uint32_t thresh, const long long* __restrict__ salts, int act,
           int apply_dropout, int vec, long long row_base) {
  extern __shared__ float4 smem4[];
  // the hidden site's salts (s0a, s1a) and the output site's (s0b, s1b): the
  // low 32 bits of salts[0..3], read from device memory so that a captured
  // graph reads each replay's own salts
  uint32_t s0a = 0, s1a = 0, s0b = 0, s1b = 0;
  if (apply_dropout) {
    s0a = static_cast<uint32_t>(salts[0]);
    s1a = static_cast<uint32_t>(salts[1]);
    s0b = static_cast<uint32_t>(salts[2]);
    s1b = static_cast<uint32_t>(salts[3]);
  }
  float* xs = reinterpret_cast<float*>(smem4);  // [kBM][kXLd]  x tile
  float* hs = xs + kBM * kXLd;                  // [kBM][kHLd]  hidden chunk
  float* stages = hs + kBM * kHLd;              // kStages x kStage weight tiles (of W)
  float* red_sum = stages + kStages * kStage;   // [kBM][4]     LayerNorm partials
  float* red_sq = red_sum + kBM * 4;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;  // rows 32 wm.., GEMM1 columns 32 wn.., GEMM2 128 wn..
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;

  const int n1 = (D + kK1 - 1) / kK1;              // W1 tiles a chunk
  const int per_chunk = n1 + kFC / kK2;            // and 16 W2 tiles
  const int n_tiles = (F + kFC - 1) / kFC * per_chunk;
  const int nt2 = min(kNT2, max(0, (D - 128 * wn + 7) / 8));  // this warp's GEMM2 column tiles

  // tile i into stage i % kStages: W1^T rows f0.. x columns 32 j.., or W2^T
  // rows 0..511 x columns f0 + 8 s..
  // (a tile's row strides are kW1Ld and kW2Ld elements of W; 16 bytes, kV
  // elements, a copy)
  constexpr int kV = 16 / sizeof(W);
  auto load_tile = [&](int i) {
    W* dst = reinterpret_cast<W*>(stages + (i % kStages) * kStage);
    const int chunk = i / per_chunk, j = i % per_chunk, f0 = chunk * kFC;
    if (j < n1) {
      for (int q = tid; q < kFC * (kK1 / kV); q += kThreads) {
        const int r = q / (kK1 / kV), c = (q % (kK1 / kV)) * kV;
        copy_w(dst + r * kW1Ld + c, w1t, f0 + r, j * kK1 + c, F, D, D, vec);
      }
    } else {
      const int f = f0 + (j - n1) * kK2;
      for (int q = tid; q < kMaxD * (kK2 / kV); q += kThreads) {
        const int d = q / (kK2 / kV), c = (q % (kK2 / kV)) * kV;
        copy_w(dst + d * kW2Ld + c, w2t, d, f + c, D, F, F, vec);
      }
    }
  };

  // the x tile (zeros past M and D), with the first weight tile
  for (int q = tid; q < kBM * (kMaxD / 4); q += kThreads) {
    const int r = q / (kMaxD / 4), c = (q % (kMaxD / 4)) * 4;
    copy4(xs + r * kXLd + c, x, row0 + r, c, M, D, D, vec);
  }

  float acc2[2][kNT2][4], acc1[2][kNT1][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < kNT2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[mi][n][e] = 0.f;

  // one commit group a tile (the first with x), kStages - 1 ahead
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i has arrived for every thread; every warp is done with tile i - 1
    if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);  // into tile i - 1's stage
    cp_async_commit();
    const W* w = reinterpret_cast<const W*>(stages + (i % kStages) * kStage);
    const int chunk = i / per_chunk, j = i % per_chunk, f0 = chunk * kFC;
    if (j < n1) {
      // ---- GEMM1: h[64, 128] += x[:, 32 j..] W1[32 j.., chunk] ----
      if (j == 0) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int n = 0; n < kNT1; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc1[mi][n][e] = 0.f;
      }
      if constexpr (kOnePass) {
#pragma unroll
        for (int kk = 0; kk < kK1; kk += 16) {
          uint32_t a[2][4], b[kNT1][2];
          load_a16(xs + (32 * wm) * kXLd + j * kK1 + kk, kXLd, g, t, a);
#pragma unroll
          for (int n = 0; n < kNT1; ++n)
            load_b16(w + (32 * wn + 8 * n) * kW1Ld + kk, kW1Ld, g, t, b[n]);
#pragma unroll
          for (int n = 0; n < kNT1; ++n)
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) bf16mma::mma16(acc1[mi][n], a[mi], b[n]);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kK1; kk += 8) {
          uint32_t ah[2][4], al[2][4], bh[kNT1][2], bl[kNT1][2];
          load_a(xs + (32 * wm) * kXLd + j * kK1 + kk, kXLd, g, t, ah, al);
#pragma unroll
          for (int n = 0; n < kNT1; ++n)
            load_b(w + (32 * wn + 8 * n) * kW1Ld + kk, kW1Ld, g, t, bh[n], bl[n]);
          mma_block<kNT1, kNT1, Weights<W>::kSplit>(acc1, 0, ah, al, bh, bl);
        }
      }
      if (j == n1 - 1) {
        // bias (the training form stores a1 here), activation, hidden
        // dropout into hs; hidden units past F are 0
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int n = 0; n < kNT1; ++n)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = 32 * wm + 16 * mi + g + 8 * hh;
              const int col = 32 * wn + 8 * n + 2 * t, f = f0 + col;
              float a[2];
#pragma unroll
              for (int q = 0; q < 2; ++q)
                a[q] = f + q < F ? acc1[mi][n][2 * hh + q] + Weights<W>::to_f(b1[f + q]) : 0.f;
              if (kResiduals) store_pair(a1_out, row0 + r, f, M, F, a[0], a[1]);
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                float v = 0.f;
                if (f + q < F) {
                  v = activation(a[q], act);
                  if (apply_dropout)
                    v = keep_bit(static_cast<uint32_t>(row_base + row0 + r) *
                                         static_cast<uint32_t>(F) +
                                     static_cast<uint32_t>(f + q), s0a, s1a, thresh)
                            ? v / keep_prob : 0.f;
                }
                hs[r * kHLd + col + q] = v;
              }
            }
      }
    } else {
      // ---- GEMM2: out[64, D] += h[:, 8 s..] W2[f0 + 8 s.., :] ----
      const int s = j - n1;
      if constexpr (kOnePass) {
        uint32_t a[2][2];
        load_a8(hs + (32 * wm) * kHLd + s * kK2, kHLd, g, t, a);
#pragma unroll
        for (int n0 = 0; n0 < kNT2; n0 += 4) {
          if (n0 < nt2) {
            uint32_t b[4];
#pragma unroll
            for (int n = 0; n < 4; ++n)
              b[n] = load_b8(w + (128 * wn + 8 * (n0 + n)) * kW2Ld, kW2Ld, g, t);
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
              for (int mi = 0; mi < 2; ++mi) bf16mma::mma8(acc2[mi][n0 + n], a[mi], b[n]);
          }
        }
      } else {
        uint32_t ah[2][4], al[2][4];
        load_a(hs + (32 * wm) * kHLd + s * kK2, kHLd, g, t, ah, al);
#pragma unroll
        for (int n0 = 0; n0 < kNT2; n0 += 4) {
          if (n0 < nt2) {
            uint32_t bh[4][2], bl[4][2];
#pragma unroll
            for (int n = 0; n < 4; ++n)
              load_b(w + (128 * wn + 8 * (n0 + n)) * kW2Ld, kW2Ld, g, t, bh[n], bl[n]);
            mma_block<4, kNT2, Weights<W>::kSplit>(acc2, n0, ah, al, bh, bl);
          }
        }
      }
    }
  }

  // ---- epilogue: bias, output dropout, residual, row LayerNorm ----
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, sq[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < kNT2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 32 * wm + 16 * mi + g + 8 * (e >> 1);
        const int c = 128 * wn + 8 * n + 2 * t + (e & 1);
        float rv = 0.f;
        if (c < D) {
          float a2 = acc2[mi][n][e] + Weights<W>::to_f(b2[c]);
          if (apply_dropout)
            a2 = keep_bit(static_cast<uint32_t>(row_base + row0 + r) * static_cast<uint32_t>(D) +
                              static_cast<uint32_t>(c), s0b, s1b, thresh)
                     ? a2 / keep_prob : 0.f;
          rv = xs[r * kXLd + c] + a2;
        }
        acc2[mi][n][e] = rv;
        sum[mi][e >> 1] += rv;
        sq[mi][e >> 1] += rv * rv;
      }
  if (kResiduals) {  // the training form: r, before the LayerNorm
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < kNT2; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          store_pair(r_out, row0 + 32 * wm + 16 * mi + g + 8 * hh, 128 * wn + 8 * n + 2 * t, M,
                     D, acc2[mi][n][2 * hh], acc2[mi][n][2 * hh + 1]);
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        sum[mi][h] += __shfl_xor_sync(0xffffffffu, sum[mi][h], o);
        sq[mi][h] += __shfl_xor_sync(0xffffffffu, sq[mi][h], o);
      }
      if (t == 0) {
        const int r = 32 * wm + 16 * mi + g + 8 * h;
        red_sum[r * 4 + wn] = sum[mi][h];
        red_sq[r * 4 + wn] = sq[mi][h];
      }
    }
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 32 * wm + 16 * mi + g + 8 * h;
      const long long row = row0 + r;
      const float* rs = red_sum + r * 4;
      const float* rq = red_sq + r * 4;
      const float mu = (rs[0] + rs[1] + rs[2] + rs[3]) / D;
      const float var = (rq[0] + rq[1] + rq[2] + rq[3]) / D - mu * mu;
      const float rstd = 1.f / sqrtf(var + kEps);
      if (row >= M) continue;
#pragma unroll
      for (int n = 0; n < kNT2; ++n)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const int c = 128 * wn + 8 * n + 2 * t + (e & 1);
          if (c < D)
            out[row * D + c] = (acc2[mi][n][e] - mu) * rstd * Weights<W>::to_f(gamma[c]) +
                               Weights<W>::to_f(beta[c]);
        }
    }
}

template <typename W, bool kOnePass>
int launch(const float* x, const W* w1t, const W* b1, const W* w2t, const W* b2, const W* gamma,
           const W* beta, float* out, float* a1, float* r, int M, int D, int F, float keep_prob,
           unsigned int thresh, const long long* salts, int act, int apply_dropout, int vec,
           long long row_base, void* stream) {
  if (D < 1 || D > kMaxD || F < 1 || M < 0 || (a1 == nullptr) != (r == nullptr) ||
      (apply_dropout && salts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const int bytes = kSmemFloats * static_cast<int>(sizeof(float));
  const bool train = a1 != nullptr;
  auto kernel = train ? ffn_kernel<true, W, kOnePass> : ffn_kernel<false, W, kOnePass>;
  // set on every call: the attribute belongs to the current device's context
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (M + kBM - 1) / kBM;
  kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, w1t, b1, w2t, b2, gamma, beta, out, a1, r, M, D, F, keep_prob, thresh, salts, act,
      apply_dropout, vec, row_base);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ffn_max_d() { return kMaxD; }

// x [M, D], w1t [F, D], w2t [D, F], b1 [F], b2, gamma, beta [D], out [M, D]
// float32, contiguous; a1 [M, F] and r [M, D] both null (the eval form) or
// both set (the training form writes them). salts: int64 [4] in device
// memory, the hidden site's (s0a, s1a) and the output site's (s0b, s1b) as
// their low 32 bits, read when apply_dropout (may be null otherwise).
// vec: D and F are multiples of 4 and x, w1t and w2t are 16-byte aligned.
// row_base: the global row of x's first row under a data mesh (0 without
// one); the masks hash (row_base + row) * n_cols + col in uint32, the rows
// of the global batch's masks while its M x F stays below 2^32.
extern "C" int ffn_forward(const float* x, const float* w1t, const float* b1,
                           const float* w2t, const float* b2, const float* gamma,
                           const float* beta, float* out, float* a1, float* r, int M, int D,
                           int F, float keep_prob, unsigned int thresh, const long long* salts,
                           int act, int apply_dropout, int vec, long long row_base,
                           void* stream) {
  return launch<float, false>(x, w1t, b1, w2t, b2, gamma, beta, out, a1, r, M, D, F, keep_prob,
                              thresh, salts, act, apply_dropout, vec, row_base, stream);
}

// The one-pass bf16 form (compute_dtype="bfloat16"): as ffn_forward, every
// argument alike (float32 weights), with the operands of both products
// rounded to bf16 and one bf16 mma pass each.
extern "C" int ffn_forward_bf16(const float* x, const float* w1t, const float* b1,
                                const float* w2t, const float* b2, const float* gamma,
                                const float* beta, float* out, float* a1, float* r, int M, int D,
                                int F, float keep_prob, unsigned int thresh,
                                const long long* salts, int act, int apply_dropout, int vec,
                                long long row_base, void* stream) {
  return launch<float, true>(x, w1t, b1, w2t, b2, gamma, beta, out, a1, r, M, D, F, keep_prob,
                             thresh, salts, act, apply_dropout, vec, row_base, stream);
}

// The bfloat16-weight form: as ffn_forward, with w1t, b1, w2t, b2, gamma
// and beta bfloat16 (x, out, a1, r float32). vec: D and F are multiples of
// 8 and x, w1t and w2t are 16-byte aligned.
extern "C" int ffn_forward_bf16w(const float* x, const void* w1t, const void* b1,
                                 const void* w2t, const void* b2, const void* gamma,
                                 const void* beta, float* out, float* a1, float* r, int M, int D,
                                 int F, float keep_prob, unsigned int thresh,
                                 const long long* salts, int act, int apply_dropout, int vec,
                                 long long row_base, void* stream) {
  using B = __nv_bfloat16;
  return launch<B, false>(x, static_cast<const B*>(w1t), static_cast<const B*>(b1),
                          static_cast<const B*>(w2t), static_cast<const B*>(b2),
                          static_cast<const B*>(gamma), static_cast<const B*>(beta), out, a1, r,
                          M, D, F, keep_prob, thresh, salts, act, apply_dropout, vec, row_base,
                          stream);
}
