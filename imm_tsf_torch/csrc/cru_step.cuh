// The pieces of one CRU Kalman step that the fused scan's forward
// (csrc/cru_scan.cu, kernel #6) and its backward (csrc/cru_scan_bwd.cu,
// kernel #7, which recomputes each step) share, so both run the same
// float32 arithmetic. After imm_tsf_tpu/ops/pallas/cru_scan_kernel.py
// (_update_step, _predict_pieces).

#pragma once

#include "expm.cuh"

namespace cru {

constexpr int kMaxLsd = expm::kN / 2;  // the Van Loan block is 2lsd square
constexpr int kMaxK = 32;              // the softmax runs in one warp

// Kalman update and valid blend of latent pair i (CRUCell.py:277-314):
// the prior (m_u, m_l, cu, cl, cs) of index i and i + lod, the observation
// (y, yv) and valid v give the posterior and the intermediates the
// backward reuses.
struct Update {
  float pm_u, pm_l, pcu, pcl, pcs;  // posterior mean (i, lod + i), covariance diagonals
  float denom, q_upper, q_lower, r;
};

__device__ __forceinline__ Update update(float m_u, float m_l, float c_u, float c_l, float c_s,
                                         float y, float yv, float v) {
  Update o;
  o.denom = c_u + yv;
  o.q_upper = c_u / o.denom;
  o.q_lower = c_s / o.denom;
  o.r = y - m_u;
  const float new_u = m_u + o.q_upper * o.r, new_l = m_l + o.q_lower * o.r;
  const float factor = 1.f - o.q_upper;
  const float ncu = factor * c_u, ncl = c_l - o.q_lower * c_s, ncs = factor * c_s;
  o.pm_u = v * new_u + (1.f - v) * m_u;
  o.pm_l = v * new_l + (1.f - v) * m_l;
  o.pcu = v * ncu + (1.f - v) * c_u;
  o.pcl = v * ncl + (1.f - v) * c_l;
  o.pcs = v * ncs + (1.f - v) * c_s;
  return o;
}

// Transition coefficients softmax(pm W + b) over K (CRUCell.py:440-500).
// Warp 0 calls it; lane k < K writes coeff[k], the other lanes 0. The
// lsd-term sum's loop is unrolled (its order stays), so its reads are
// issued ahead of the FMA chain.
__device__ __forceinline__ void coefficients(const float* pm, const float* W, const float* b,
                                             float* coeff, int lsd, int K) {
  const int lane = threadIdx.x;
  float logit = -INFINITY;
  if (lane < K) {
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < lsd; ++j) acc = fmaf(pm[j], W[j * K + lane], acc);
    logit = acc + b[lane];
  }
  float mx = logit;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float ex = lane < K ? expf(logit - mx) : 0.f;
  float sum = ex;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  coeff[lane] = ex / sum;
}

// Entry (r, c) of the Van Loan block before the dt scale,
// sum_k c_k [[A_k, 0], [0, -A_k^T]] + [[0, diag q], [0, 0]], zero outside
// its 2lsd x 2lsd corner. A_k is row r of matrix k at A + (k lsd + r) lda.
__device__ __forceinline__ float van_loan(int r, int c, const float* coeff, const float* A,
                                          int lda, const float* q, int lsd, int K) {
  const int n2 = 2 * lsd;
  if (r >= n2 || c >= n2) return 0.f;  // padding
  if (r < lsd && c < lsd) {
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(coeff[k], A[(k * lsd + r) * lda + c], acc);
    return acc;
  }
  if (r >= lsd && c >= lsd) {  // -A^T
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(coeff[k], A[(k * lsd + c - lsd) * lda + r - lsd], acc);
    return -acc;
  }
  return (r < lsd && c - lsd == r) ? q[r] : 0.f;
}

}  // namespace cru
