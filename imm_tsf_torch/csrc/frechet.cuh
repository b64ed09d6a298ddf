// Frechet derivative of the matrix exponential of one matrix in shared
// memory, by a team of threads (team.cuh's clusters), shared by
// csrc/expm_frechet.cu (kernel #4, the batched Frechet derivative) and
// csrc/cru_scan_bwd.cu (kernel #7, the fused CRU scan backward, one
// Frechet derivative per step).
//
// The math of the TPU kernel's `frechet_value`
// (imm_tsf_tpu/ops/pallas/expm_kernel.py:109-153): L_exp(M)[E] is the
// derivative half of Taylor-12 and k squarings run on (value, derivative)
// pairs, where a pair product is
//
//   (X, dX) (Y, dY) = (X Y, X dY + dX Y)       (3 products)
//
// k = min(ceil(log2(max(||M||inf, 1))), max_squarings) comes from M alone
// and scales both halves by 2^-k (L is linear in E). There is no Taylor-4
// tier. Per matrix: M^2, M^3, M^4 and two Paterson-Stockmeyer products,
// then k squarings: (5 + k) pair products, 3 (5 + k) matrix products.
//
// A team with kPingPong (team.cuh's for kernel #4) writes each product's
// result into a pair that no thread reads in that product, so a product
// takes one barrier instead of two.
//
// Shared memory: eight 64 x kLd buffers (139,264 bytes), in this order:
// X, dX (in: M and E zero-padded to 64 x 64; out: exp(M) and L), then
// the value and derivative of M^2, M^3 and M^4. After M^4 the polynomial
// pieces B0, B1 overwrite M^2, M^3 and the Paterson-Stockmeyer
// accumulator lives in X, dX, so ten live pairs fit in eight buffers.
// Zero padding changes nothing in the leading n x n block: every pair
// stays block diagonal and the padding's derivative stays 0.

#pragma once

#include "expm.cuh"

namespace expm {

constexpr int kFrechetBuffers = 8;
constexpr int kFrechetSmemFloats = kFrechetBuffers * kMat;
constexpr int kFrechetSmemBytes = kFrechetSmemFloats * static_cast<int>(sizeof(float));

// (pv, pd) = (X, dX) (Y, dY) on this thread's patch, the three products in
// one pass over k: each row of X, dX, Y and dY is read from shared memory
// once for all three (pd sums X dY and dX Y term by term).
template <class Team>
__device__ __forceinline__ void pair_product(const float* X, const float* dX, const float* Y,
                                             const float* dY, float pv[Team::kRows][4],
                                             float pd[Team::kRows][4]) {
  constexpr int R = Team::kRows;
  const int r0 = Team::row0(), c0 = Team::col0();
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) pv[i][j] = pd[i][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < kN; k += 4) {
    float4 x[R], dx[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      x[i] = *reinterpret_cast<const float4*>(X + (r0 + i) * kLd + k);
      dx[i] = *reinterpret_cast<const float4*>(dX + (r0 + i) * kLd + k);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 y = *reinterpret_cast<const float4*>(Y + (k + kk) * kLd + c0);
      const float4 dy = *reinterpret_cast<const float4*>(dY + (k + kk) * kLd + c0);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float a = lane(x[i], kk), da = lane(dx[i], kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pv[i][j] = fmaf(a, lane(y, j), pv[i][j]);
          pd[i][j] = fmaf(a, lane(dy, j), pd[i][j]);
          pd[i][j] = fmaf(da, lane(y, j), pd[i][j]);
        }
      }
    }
  }
}

// row i of this thread's patch of a buffer
template <class Team>
__device__ __forceinline__ float* patch_row(float* s, int i) {
  return s + (Team::row0() + i) * kLd + Team::col0();
}

template <class Team>
__device__ __forceinline__ float4 row4(const float* s, int i) {
  return *reinterpret_cast<const float4*>(s + (Team::row0() + i) * kLd + Team::col0());
}

template <class Team>
__device__ __forceinline__ void add_patch(const float* s, float p[Team::kRows][4]) {
  float q[Team::kRows][4];
  load_patch<Team>(s, q);
#pragma unroll
  for (int i = 0; i < Team::kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) p[i][j] += q[i][j];
}

// Buffer 0 holds M and buffer 1 holds E (zero-padded, visible to every
// thread: the caller synchronises after writing them). On return buffer 1
// holds L_exp(M)[E] and buffer 0 exp(M) by Taylor-12; buffers 2-7 are
// scratch. Every thread of the team (expm.cuh) must call it; it returns
// synchronised. Returns the number of squarings.
template <class Team>
__device__ inline int frechet_inplace(float* s, float* red, int max_squarings) {
  constexpr int R = Team::kRows;
  float* X = s;
  float* dX = s + kMat;
  float* V2 = s + 2 * kMat;
  float* D2 = s + 3 * kMat;
  float* V3 = s + 4 * kMat;
  float* D3 = s + 5 * kMat;
  float* V4 = s + 6 * kMat;
  float* D4 = s + 7 * kMat;
  float pv[R][4], pd[R][4];

  const int k = squarings(Team::norm(X, red), max_squarings);
  const float scale = ldexpf(1.f, -k);  // exact: a power of two
  load_patch<Team>(X, pv);
  load_patch<Team>(dX, pd);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pv[i][j] *= scale;
      pd[i][j] *= scale;
    }
  store_patch<Team>(X, pv);  // each thread rescales its own patch
  store_patch<Team>(dX, pd);
  Team::sync();
  pair_product<Team>(X, dX, X, dX, pv, pd);  // M^2
  store_patch<Team>(V2, pv);
  store_patch<Team>(D2, pd);
  Team::sync();
  pair_product<Team>(V2, D2, X, dX, pv, pd);  // M^3
  store_patch<Team>(V3, pv);
  store_patch<Team>(D3, pd);
  pair_product<Team>(V2, D2, V2, D2, pv, pd);  // M^4
  store_patch<Team>(V4, pv);
  store_patch<Team>(D4, pd);
  Team::sync();

  // From here on M, M^2 and M^3 are read only element by element, each
  // thread its own patch: B0 -> (V2, D2), B1 -> (V3, D3) and
  // B2 + c12 M^4 -> (X, dX), one patch row at a time
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float4 x = row4<Team>(X, i), dx = row4<Team>(dX, i);
    const float4 v2 = row4<Team>(V2, i), d2 = row4<Team>(D2, i);
    const float4 v3 = row4<Team>(V3, i), d3 = row4<Team>(D3, i);
    const float4 v4 = row4<Team>(V4, i), d4 = row4<Team>(D4, i);
    float b0v[4], b0d[4], b1v[4], b1d[4], inv[4], ind[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float e = eye<Team>(i, j);
      const float xv = lane(x, j), xd = lane(dx, j), m2 = lane(v2, j), m2d = lane(d2, j);
      const float m3 = lane(v3, j), m3d = lane(d3, j), m4 = lane(v4, j), m4d = lane(d4, j);
      b0v[j] = coef(0) * e + coef(1) * xv + coef(2) * m2 + coef(3) * m3;
      b0d[j] = coef(1) * xd + coef(2) * m2d + coef(3) * m3d;
      b1v[j] = coef(4) * e + coef(5) * xv + coef(6) * m2 + coef(7) * m3;
      b1d[j] = coef(5) * xd + coef(6) * m2d + coef(7) * m3d;
      inv[j] = coef(8) * e + coef(9) * xv + coef(10) * m2 + coef(11) * m3 + coef(12) * m4;
      ind[j] = coef(9) * xd + coef(10) * m2d + coef(11) * m3d + coef(12) * m4d;
    }
    Team::put(patch_row<Team>(V2, i), make_float4(b0v[0], b0v[1], b0v[2], b0v[3]));
    Team::put(patch_row<Team>(D2, i), make_float4(b0d[0], b0d[1], b0d[2], b0d[3]));
    Team::put(patch_row<Team>(V3, i), make_float4(b1v[0], b1v[1], b1v[2], b1v[3]));
    Team::put(patch_row<Team>(D3, i), make_float4(b1d[0], b1d[1], b1d[2], b1d[3]));
    Team::put(patch_row<Team>(X, i), make_float4(inv[0], inv[1], inv[2], inv[3]));
    Team::put(patch_row<Team>(dX, i), make_float4(ind[0], ind[1], ind[2], ind[3]));
  }
  Team::sync();
  pair_product<Team>(V4, D4, X, dX, pv, pd);  // mid = M^4 (B2 + c12 M^4)
  if constexpr (Team::kPingPong) {
    // B1 + mid over B1 (each thread reads and writes its own patch, which
    // no other thread reads before the next barrier), then R = B0 + outer
    // over B0 when k is odd, else over (X, dX), and the squarings
    // alternate between the two pairs, ending in (X, dX): one barrier a
    // product
    add_patch<Team>(V3, pv);
    add_patch<Team>(D3, pd);
    store_patch<Team>(V3, pv);
    store_patch<Team>(D3, pd);
    Team::sync();
    pair_product<Team>(V4, D4, V3, D3, pv, pd);  // outer = M^4 (B1 + mid)
    add_patch<Team>(V2, pv);
    add_patch<Team>(D2, pd);
    float* src = k % 2 ? V2 : X;
    float* dsrc = k % 2 ? D2 : dX;
    float* dst = k % 2 ? X : V2;
    float* ddst = k % 2 ? dX : D2;
    store_patch<Team>(src, pv);
    store_patch<Team>(dsrc, pd);
    Team::sync();
    for (int step = 0; step < k; ++step) {
      pair_product<Team>(src, dsrc, src, dsrc, pv, pd);
      store_patch<Team>(dst, pv);  // every thread read dst in the product before last
      store_patch<Team>(ddst, pd);
      Team::sync();
      float* x = src;
      src = dst;
      dst = x;
      x = dsrc;
      dsrc = ddst;
      ddst = x;
    }
    return k;
  }
  Team::sync();                               // every thread has read X and dX
  add_patch<Team>(V3, pv);                    // B1 + mid
  add_patch<Team>(D3, pd);
  store_patch<Team>(X, pv);
  store_patch<Team>(dX, pd);
  Team::sync();
  pair_product<Team>(V4, D4, X, dX, pv, pd);  // outer = M^4 (B1 + mid)
  Team::sync();
  add_patch<Team>(V2, pv);  // R = B0 + outer
  add_patch<Team>(D2, pd);
  store_patch<Team>(X, pv);
  store_patch<Team>(dX, pd);
  Team::sync();
  for (int step = 0; step < k; ++step) {
    pair_product<Team>(X, dX, X, dX, pv, pd);
    Team::sync();
    store_patch<Team>(X, pv);
    store_patch<Team>(dX, pd);
    Team::sync();
  }
  return k;
}

}  // namespace expm
