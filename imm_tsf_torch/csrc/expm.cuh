// Block-wide matrix exponential of one matrix in shared memory, shared by
// csrc/expm.cu (kernel #5, the batched expm), csrc/cru_scan.cu (kernel
// #6, the fused CRU scan, one Van Loan expm per step) and
// csrc/cru_scan_bwd.cu (kernel #7, which recomputes that expm); its
// products are frechet.cuh's too. Two forms: expm_inplace for any matrix
// (#5's dense inputs, #7), and expm_tri_inplace for a matrix whose
// lower-left 32 x 32 block is exactly zero (#5's block triangular inputs,
// #6's Van Loan blocks), described at its definition.
//
// The math of the TPU kernel's `expm_value`
// (imm_tsf_tpu/ops/pallas/expm_kernel.py:54-94), with the tier chosen per
// matrix instead of per batch tile (both tiers truncate below 2.5e-10, far
// under float32 eps, so the function is the same):
//
//   ||M||inf <= 1/32 : Taylor-4,  R = I + M + M^2/2 + M^2 (M/6 + M^2/24)
//                      (2 products)
//   otherwise        : k = min(ceil(log2(max(||M||inf, 1))), max_squarings),
//                      Taylor-12 on M/2^k by Paterson-Stockmeyer
//                      (5 products), then k squarings
//
// The matrix sits zero-padded to 64 x 64 in the first of five 64 x kLd
// float buffers (87,040 bytes of dynamic shared memory; the caller opts in
// above 48 KB). Zero padding changes nothing in the leading n x n block:
// exp([[M, 0], [0, 0]]) = [[exp(M), 0], [0, I]]. The block's 256 threads
// each own a 4 x 4 patch of every product; products read A as float4 along
// its rows and B as float4 along its rows, the row stride of 68 floats
// keeps both free of bank conflicts. Plain float32 FMA: the JAX package
// pins this expm to full float32 (ops/expm.py:23-27) because squarings
// amplify rounding, so TF32 tensor cores are not used.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace expm {

constexpr int kN = 64;                       // matrices are zero-padded to kN x kN
constexpr int kLd = 68;                      // row stride of a shared-memory matrix
constexpr int kMat = kN * kLd;               // floats per shared-memory matrix
constexpr int kThreads = 256;                // 16 x 16 threads, one 4 x 4 patch each
constexpr int kBuffers = 5;
constexpr int kSmemFloats = kBuffers * kMat;
constexpr int kSmemBytes = kSmemFloats * static_cast<int>(sizeof(float));
constexpr int kWarps = kThreads / 32;

// 1/i!, rounded to float as the JAX package's Python floats are
__device__ __forceinline__ float coef(int i) {
  switch (i) {
    case 0: case 1: return 1.f;
    case 2: return 0.5f;
    case 3: return static_cast<float>(1.0 / 6.0);
    case 4: return static_cast<float>(1.0 / 24.0);
    case 5: return static_cast<float>(1.0 / 120.0);
    case 6: return static_cast<float>(1.0 / 720.0);
    case 7: return static_cast<float>(1.0 / 5040.0);
    case 8: return static_cast<float>(1.0 / 40320.0);
    case 9: return static_cast<float>(1.0 / 362880.0);
    case 10: return static_cast<float>(1.0 / 3628800.0);
    case 11: return static_cast<float>(1.0 / 39916800.0);
    default: return static_cast<float>(1.0 / 479001600.0);
  }
}

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The threads that run one matrix function together, and how they share
// its buffers. Block: the whole block of kThreads threads, each on a 4 x 4
// patch (rows row0().., columns col0()..) of every 64 x 64 product, the
// buffers in the block's own shared memory (kernels #4-#6). Another team
// (csrc/cru_scan_bwd.cu splits each product over a thread-block cluster)
// gives the same members: kRows patch rows a thread, row0() and col0(),
// put() (a float4 of the thread's patch into every copy of a buffer),
// sync() (every copy written before any is read), norm() (the inf-norm of
// a buffer, the same value in every thread, synchronised on return), and
// for frechet.cuh kPingPong (its results into free buffers, one barrier a
// product).
struct Block {
  static constexpr int kRows = 4;
  __device__ static int row0() { return (threadIdx.x / 16) * 4; }
  __device__ static int col0() { return (threadIdx.x % 16) * 4; }
  __device__ static void put(float* s, const float4& v) { *reinterpret_cast<float4*>(s) = v; }
  __device__ static void sync() { __syncthreads(); }
  __device__ static float norm(const float* s, float* red);
};

// this thread's patch (rows row0().., columns col0()..) of a buffer
template <class Team = Block>
__device__ __forceinline__ void load_patch(const float* s, float p[Team::kRows][4]) {
  const int r0 = Team::row0(), c0 = Team::col0();
#pragma unroll
  for (int i = 0; i < Team::kRows; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(s + (r0 + i) * kLd + c0);
#pragma unroll
    for (int j = 0; j < 4; ++j) p[i][j] = lane(v, j);
  }
}

template <class Team = Block>
__device__ __forceinline__ void store_patch(float* s, const float p[Team::kRows][4]) {
  const int r0 = Team::row0(), c0 = Team::col0();
#pragma unroll
  for (int i = 0; i < Team::kRows; ++i)
    Team::put(s + (r0 + i) * kLd + c0, make_float4(p[i][0], p[i][1], p[i][2], p[i][3]));
}

// 1 on this thread's patch of the diagonal, 0 elsewhere
template <class Team = Block>
__device__ __forceinline__ float eye(int i, int j) {
  return Team::row0() + i == Team::col0() + j ? 1.f : 0.f;
}

// p += A B on this thread's patch (A, B full kN x kN buffers)
template <class Team = Block>
__device__ __forceinline__ void matmul_acc_patch(const float* __restrict__ A,
                                                 const float* __restrict__ B,
                                                 float p[Team::kRows][4]) {
  const int r0 = Team::row0(), c0 = Team::col0();
#pragma unroll 2
  for (int k = 0; k < kN; k += 4) {
    float4 a[Team::kRows];
#pragma unroll
    for (int i = 0; i < Team::kRows; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (r0 + i) * kLd + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(B + (k + kk) * kLd + c0);
#pragma unroll
      for (int i = 0; i < Team::kRows; ++i) {
        const float av = lane(a[i], kk);
        p[i][0] = fmaf(av, b.x, p[i][0]);
        p[i][1] = fmaf(av, b.y, p[i][1]);
        p[i][2] = fmaf(av, b.z, p[i][2]);
        p[i][3] = fmaf(av, b.w, p[i][3]);
      }
    }
  }
}

// p = A B on this thread's patch
template <class Team = Block>
__device__ __forceinline__ void matmul_patch(const float* __restrict__ A,
                                             const float* __restrict__ B,
                                             float p[Team::kRows][4]) {
#pragma unroll
  for (int i = 0; i < Team::kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) p[i][j] = 0.f;
  matmul_acc_patch<Team>(A, B, p);
}

// max row sum of |M| over the kN x kN buffer; red holds kWarps floats.
// Every thread returns the same value.
__device__ __forceinline__ float inf_norm(const float* s, float* red) {
  const int r = threadIdx.x / 4, quarter = threadIdx.x % 4;  // 64 rows x 4 quarters
  const float4* row = reinterpret_cast<const float4*>(s + r * kLd + quarter * 16);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 v = row[j];
    sum += fabsf(v.x) + fabsf(v.y) + fabsf(v.z) + fabsf(v.w);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) sum = fmaxf(sum, __shfl_xor_sync(0xffffffffu, sum, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = sum;
  __syncthreads();
  float norm = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) norm = fmaxf(norm, red[w]);
  __syncthreads();  // red may be written again
  return norm;
}

__device__ __forceinline__ float Block::norm(const float* s, float* red) {
  return inf_norm(s, red);
}

// max row sum of |M| over a kN x kN buffer by a block of Threads threads
// (kThreads: expm.cuh's inf_norm); red holds Threads / 32 floats. Every
// thread returns the same value.
template <int Threads>
__device__ __forceinline__ float block_inf_norm(const float* s, float* red) {
  if constexpr (Threads == kThreads) {
    return inf_norm(s, red);
  } else {
    constexpr int kParts = Threads / kN;  // threads a row
    static_assert(kParts >= 1 && kParts <= 4 && kN % (4 * kParts) == 0, "threads a row");
    const int r = threadIdx.x / kParts, part = threadIdx.x % kParts;
    const float4* row = reinterpret_cast<const float4*>(s + r * kLd + part * (kN / kParts));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kN / kParts / 4; ++j) {
      const float4 v = row[j];
      sum += fabsf(v.x) + fabsf(v.y) + fabsf(v.z) + fabsf(v.w);
    }
#pragma unroll
    for (int off = 1; off < kParts; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
    for (int off = kParts; off < 32; off <<= 1)
      sum = fmaxf(sum, __shfl_xor_sync(0xffffffffu, sum, off));
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = sum;
    __syncthreads();
    float norm = red[0];
#pragma unroll
    for (int w = 1; w < Threads / 32; ++w) norm = fmaxf(norm, red[w]);
    __syncthreads();  // red may be written again
    return norm;
  }
}

// k = min(ceil(log2(max(norm, 1))), max_squarings), exactly: norm = m 2^e
// with m in [0.5, 1), and ceil(log2(norm)) = e, or e - 1 when m = 0.5
__device__ __forceinline__ int squarings(float norm, int max_squarings) {
  if (!(norm > 1.f)) return 0;
  if (isinf(norm)) return max_squarings;
  int e;
  const float m = frexpf(norm, &e);
  return min(m == 0.5f ? e - 1 : e, max_squarings);
}

// Overwrites buffer 0 of s (the zero-padded matrix M, visible to every
// thread: the caller synchronises after writing it) with exp(M); buffers
// 1-4 are scratch. Every thread of the team must call it; it returns
// synchronised. Returns -1 for the Taylor-4 tier, else the number
// of squarings of the Taylor-12 tier.
template <class Team = Block>
__device__ inline int expm_inplace(float* s, float* red, int max_squarings) {
  constexpr int R = Team::kRows;
  float* M = s;
  float* M2 = s + kMat;
  float* M3 = s + 2 * kMat;
  float* M4 = s + 3 * kMat;
  float* X = s + 4 * kMat;
  float m[R][4], m2[R][4], m3[R][4], p[R][4];

  const float norm = Team::norm(M, red);
  if (norm <= 1.f / 32.f) {
    // Taylor-4: c0 I + c1 M + c2 M2 + M2 (c3 M + c4 M2)
    matmul_patch<Team>(M, M, p);
    store_patch<Team>(M2, p);
    Team::sync();
    load_patch<Team>(M, m);
    load_patch<Team>(M2, m2);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = coef(3) * m[i][j] + coef(4) * m2[i][j];
    store_patch<Team>(X, p);
    Team::sync();
    matmul_patch<Team>(M2, X, p);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p[i][j] = coef(0) * eye<Team>(i, j) + coef(1) * m[i][j] + coef(2) * m2[i][j] + p[i][j];
    store_patch<Team>(M, p);  // no thread reads M after the first product
    Team::sync();
    return -1;
  }

  // Taylor-12 on Ms = M / 2^k (exact: a power of two)
  const int k = squarings(norm, max_squarings);
  const float scale = ldexpf(1.f, -k);
  load_patch<Team>(M, m);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) m[i][j] *= scale;
  store_patch<Team>(M, m);  // each thread rescales its own patch
  Team::sync();
  matmul_patch<Team>(M, M, p);
  store_patch<Team>(M2, p);
  Team::sync();
  matmul_patch<Team>(M2, M, p);
  store_patch<Team>(M3, p);
  matmul_patch<Team>(M2, M2, p);
  store_patch<Team>(M4, p);
  Team::sync();
  load_patch<Team>(M2, m2);
  load_patch<Team>(M3, m3);
  // Paterson-Stockmeyer, base M4: B0 + M4 (B1 + M4 (B2 + c12 M4))
  float m4[R][4];
  load_patch<Team>(M4, m4);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p[i][j] = coef(8) * eye<Team>(i, j) + coef(9) * m[i][j] + coef(10) * m2[i][j] +
                coef(11) * m3[i][j] + coef(12) * m4[i][j];
  store_patch<Team>(X, p);
  Team::sync();
  matmul_patch<Team>(M4, X, p);
  Team::sync();  // X is read by every thread before it is overwritten
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p[i][j] = coef(4) * eye<Team>(i, j) + coef(5) * m[i][j] + coef(6) * m2[i][j] +
                coef(7) * m3[i][j] + p[i][j];
  store_patch<Team>(X, p);
  Team::sync();
  matmul_patch<Team>(M4, X, p);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p[i][j] = coef(0) * eye<Team>(i, j) + coef(1) * m[i][j] + coef(2) * m2[i][j] +
                coef(3) * m3[i][j] + p[i][j];
  store_patch<Team>(M, p);  // nothing reads M after the products that made M2-M4
  Team::sync();
  for (int step = 0; step < k; ++step) {
    matmul_patch<Team>(M, M, p);
    Team::sync();
    store_patch<Team>(M, p);
    Team::sync();
  }
  return k;
}

// ---------------------------------------------------------------------------
// The block-triangular form. A 64 x 64 buffer whose lower-left 32 x 32
// block is exactly zero, X = [[X11, X12], [0, X22]], stays so under
// products, sums and scalings, so every power of it, the Taylor
// polynomials and the squarings are too. Any matrix of n <= 32,
// zero-padded to 64, is one, and so is the Van Loan block
// [[A, Q], [0, -A^T]] dt at lsd = 32; csrc/cru_scan.cu lays out a smaller
// Van Loan block at 32-offsets (A and Q's rows from 0, -A^T and Q's
// columns from 32), so at every lsd <= 32 it is one too.
// A product of two then needs three block products,
//
//   UL = X11 Y11,  UR = X11 Y12 + X12 Y22,  LR = X22 Y22,
//
// 4 (n/2)^3 FMAs instead of n^3, half of expm_inplace's product; the zero
// block is never written (the caller zeroes it once) and never read.
//
// Same function, same rounding: the tiers, the norm (over the whole buffer,
// the zero block adds nothing), the squaring count, the Paterson-Stockmeyer
// steps and the coefficients are expm_inplace's. Each sum keeps the dense
// product's order over its nonzero terms (UR runs k = 0..63 in one chain);
// the terms it skips are products with an exact zero, which leave a finite
// sum unchanged. So on finite inputs the result equals expm_inplace's bit
// for bit, up to the sign of a zero.
//
// One block of kTriThreads = 128 threads runs it. The work is balanced by
// blocks, not rows: UR has twice the depth of UL or LR, so a row split
// would give the threads holding rows 0-31 three quarters of it. Thread t
// owns the same 2 x 4 patch, block rows i = 2 (t / 8), i + 1, block
// columns c = 4 (t % 8) .. c + 3, of all three blocks, UL (i, c),
// UR (i, 32 + c) and LR (32 + i, 32 + c): every thread does 8 (32 + 64 + 32)
// FMAs a k-sweep, and one pass over k reads each row of X once for two
// blocks (k < 32: UL and UR share X11, k >= 32: UR and LR share Y22).
// A product is bound by shared-memory reads: every 16-byte read of a warp
// costs four of the SM's cycles whether its lanes share addresses or not,
// and a thread reads 24 R + 96 of them a product for 512 R FMAs (R rows a
// patch), so R = 2 at 128 threads reads 40 % fewer a FMA than R = 1 at
// 256. Results go into buffers that the product does not read, one
// __syncthreads a product, so the result may end in buffer 0 or buffer 4;
// expm_tri_inplace returns which.

constexpr int kH = kN / 2;            // block size
constexpr int kTriThreads = 128;      // threads of the block that runs the triangular form
constexpr int kTriRows = kH * kH / (4 * kTriThreads);  // rows of a thread's patch in each block
static_assert(kTriRows == 2, "a 2 x 4 patch a thread");

// this thread's first block row and first block column
__device__ __forceinline__ int tri_row() { return (static_cast<int>(threadIdx.x) / 8) * kTriRows; }
__device__ __forceinline__ int tri_col() { return (threadIdx.x % 8) * 4; }

// offset of row ii of this thread's patch of block blk (UL, UR, LR) in a buffer
__device__ __forceinline__ int tri_offset(int blk, int ii) {
  const int i = tri_row() + ii, c = tri_col();
  return blk == 0 ? i * kLd + c : blk == 1 ? i * kLd + kH + c : (kH + i) * kLd + kH + c;
}

__device__ __forceinline__ void tri_load(const float* s, float p[3][kTriRows][4]) {
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int ii = 0; ii < kTriRows; ++ii) {
      const float4 v = *reinterpret_cast<const float4*>(s + tri_offset(b, ii));
#pragma unroll
      for (int j = 0; j < 4; ++j) p[b][ii][j] = lane(v, j);
    }
}

__device__ __forceinline__ void tri_store(float* s, const float p[3][kTriRows][4]) {
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int ii = 0; ii < kTriRows; ++ii)
      *reinterpret_cast<float4*>(s + tri_offset(b, ii)) =
          make_float4(p[b][ii][0], p[b][ii][1], p[b][ii][2], p[b][ii][3]);
}

// 1 on this thread's patch of the diagonal (UL and LR), 0 elsewhere
__device__ __forceinline__ float tri_eye(int b, int ii, int j) {
  return b != 1 && tri_row() + ii == tri_col() + j ? 1.f : 0.f;
}

// p = A B on this thread's patch of the three blocks
__device__ __forceinline__ void tri_matmul(const float* __restrict__ A,
                                           const float* __restrict__ B,
                                           float p[3][kTriRows][4]) {
  constexpr int R = kTriRows;
  const int i = tri_row(), c = tri_col();
  const float* a_up = A + i * kLd;         // rows i..: A11 then A12
  const float* a_lo = A + (kH + i) * kLd;  // rows 32 + i..: A22 at k >= 32
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int ii = 0; ii < R; ++ii)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[b][ii][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < kH; k += 4) {  // UL += A11 B11, UR += A11 B12
    float4 a[R];
#pragma unroll
    for (int ii = 0; ii < R; ++ii) a[ii] = *reinterpret_cast<const float4*>(a_up + ii * kLd + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(B + (k + kk) * kLd + c);
      const float4 b1 = *reinterpret_cast<const float4*>(B + (k + kk) * kLd + kH + c);
#pragma unroll
      for (int ii = 0; ii < R; ++ii) {
        const float av = lane(a[ii], kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[0][ii][j] = fmaf(av, lane(b0, j), p[0][ii][j]);
          p[1][ii][j] = fmaf(av, lane(b1, j), p[1][ii][j]);
        }
      }
    }
  }
#pragma unroll 2
  for (int k = kH; k < kN; k += 4) {  // UR += A12 B22, LR += A22 B22
    float4 a[R], al[R];
#pragma unroll
    for (int ii = 0; ii < R; ++ii) {
      a[ii] = *reinterpret_cast<const float4*>(a_up + ii * kLd + k);
      al[ii] = *reinterpret_cast<const float4*>(a_lo + ii * kLd + k);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(B + (k + kk) * kLd + kH + c);
#pragma unroll
      for (int ii = 0; ii < R; ++ii) {
        const float av = lane(a[ii], kk), alv = lane(al[ii], kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[1][ii][j] = fmaf(av, lane(b, j), p[1][ii][j]);
          p[2][ii][j] = fmaf(alv, lane(b, j), p[2][ii][j]);
        }
      }
    }
  }
}

// expm_inplace for a buffer 0 whose lower-left 32 x 32 block is zero in
// every buffer 0-4 (the caller zeroes it once; nothing here writes it):
// returns the buffer that holds exp(M), buffer 0 or buffer 4. Every thread
// of the block (kTriThreads) must call it; it returns synchronised.
//
// Buffers (b0-b4), each written only where no thread reads it before the
// next __syncthreads: Taylor-4 M2 -> b1, the polynomial factor -> b4, the
// result -> b0. Taylor-12: M / 2^k -> b4, its powers 2-4 -> b1-b3,
// Paterson-Stockmeyer's B2 + c12 M4 -> b0, then -> b1, the sum -> b0, and
// the squarings alternate b0 and b4.
__device__ inline float* expm_tri_inplace(float* s, float* red, int max_squarings) {
  constexpr int R = kTriRows;
  float* b0 = s;
  float* b1 = s + kMat;
  float* b2 = s + 2 * kMat;
  float* b3 = s + 3 * kMat;
  float* b4 = s + 4 * kMat;
  float m[3][R][4], m2[3][R][4], m3[3][R][4], p[3][R][4];

  const float norm = block_inf_norm<kTriThreads>(b0, red);
  if (norm <= 1.f / 32.f) {
    // Taylor-4: c0 I + c1 M + c2 M2 + M2 (c3 M + c4 M2)
    tri_matmul(b0, b0, p);
    tri_store(b1, p);
    __syncthreads();
    tri_load(b0, m);
    tri_load(b1, m2);
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[b][i][j] = coef(3) * m[b][i][j] + coef(4) * m2[b][i][j];
    tri_store(b4, p);
    __syncthreads();
    tri_matmul(b1, b4, p);
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p[b][i][j] = coef(0) * tri_eye(b, i, j) + coef(1) * m[b][i][j] +
                       coef(2) * m2[b][i][j] + p[b][i][j];
    tri_store(b0, p);
    __syncthreads();
    return b0;
  }

  // Taylor-12 on Ms = M / 2^k (exact: a power of two)
  const int k = squarings(norm, max_squarings);
  const float scale = ldexpf(1.f, -k);
  tri_load(b0, m);
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) m[b][i][j] *= scale;
  tri_store(b4, m);
  __syncthreads();
  tri_matmul(b4, b4, p);
  tri_store(b1, p);
  __syncthreads();
  tri_matmul(b1, b4, p);
  tri_store(b2, p);
  tri_matmul(b1, b1, p);
  tri_store(b3, p);
  __syncthreads();
  tri_load(b1, m2);
  tri_load(b2, m3);
  // Paterson-Stockmeyer, base M4: B0 + M4 (B1 + M4 (B2 + c12 M4))
  {
    float m4[3][R][4];
    tri_load(b3, m4);
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p[b][i][j] = coef(8) * tri_eye(b, i, j) + coef(9) * m[b][i][j] +
                       coef(10) * m2[b][i][j] + coef(11) * m3[b][i][j] + coef(12) * m4[b][i][j];
  }
  tri_store(b0, p);
  __syncthreads();
  tri_matmul(b3, b0, p);
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p[b][i][j] = coef(4) * tri_eye(b, i, j) + coef(5) * m[b][i][j] +
                     coef(6) * m2[b][i][j] + coef(7) * m3[b][i][j] + p[b][i][j];
  tri_store(b1, p);
  __syncthreads();
  tri_matmul(b3, b1, p);
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p[b][i][j] = coef(0) * tri_eye(b, i, j) + coef(1) * m[b][i][j] +
                     coef(2) * m2[b][i][j] + coef(3) * m3[b][i][j] + p[b][i][j];
  tri_store(b0, p);
  __syncthreads();
  float* cur = b0;
  float* next = b4;  // M / 2^k, read last by the product that made M^3
  for (int step = 0; step < k; ++step) {
    tri_matmul(cur, cur, p);
    tri_store(next, p);
    __syncthreads();
    float* t = cur;
    cur = next;
    next = t;
  }
  return cur;
}

}  // namespace expm
