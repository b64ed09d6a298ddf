// The whole CRU Kalman scan in one launch, forward only.
//
// Replaces the TPU kernel imm_tsf_tpu/ops/pallas/cru_scan_kernel.py
// (cru_scan_fwd_pallas -> _cru_fwd_kernel). For each sample, for t = 0..T-1
// with the carry (prior mean m [lsd], covariance diagonals cu, cl, cs [lod]):
//
//   residuals[t] = (m, cu, cl, cs)
//   update + valid blend (CRUCell.py:277-314)    -> post_m, post_cu/cl/cs
//   out[t] = post_m
//   c  = softmax(post_m W + b)                     (K transition bases)
//   Bm = (sum_k c_k [[A_k, 0], [0, -A_k^T]] + [[0, diag q], [0, 0]]) dt
//   E  = exp(Bm), E_A = E[:lsd, :lsd], M2 = E[:lsd, lsd:]  (expm.cuh)
//   m  = E_A post_m
//   P  = ([E_A[:, :lod] post_cu + E_A[:, lod:] post_cs,
//          E_A[:, :lod] post_cs + E_A[:, lod:] post_cl] + M2) E_A^T
//   cu, cl, cs = diag P[:lod, :lod], diag P[lod:, lod:], diag P[:lod, lod:]
//
// Bound on an H100: operations. Each step's 2lsd-square expm (2 or 5 + k
// products of n^3 FLOPs, n = 2lsd = 64 for the CRU preset: the block is
// block upper triangular) dwarfs the bytes: the call reads y, y_var
// [B,T,lod], valid and dt and writes the post-means and residuals,
// 4 B T (3 lsd + 3 lod + 2) bytes in all.
//
// Design: one block of 128 threads per sample walks all T steps with the
// carry in shared memory, so no intermediate reaches device memory. The
// block keeps the expm's five 64 x 68 buffers, the K blocks A_k
// [K, lsd, lsd] (61 KB at K = 15, lsd = 32; their row stride lsd + 1
// keeps the transposed reads free of bank conflicts; the TPU kernel's bigG
// [K, 2lsd, 2lsd] is 245 KB, more than a Hopper block can have), 32 steps
// of observations (staged in one pass, so a step waits on no device-memory
// read) and the carry. A step:
//   - scalar: the Kalman update and the softmax (its sum's loop unrolled);
//     the residuals and post-means go out.
//   - Van Loan block: laid out at 32-offsets, A and Q's rows from 0, -A^T
//     and Q's columns from 32 (a symmetric permutation of the 2lsd-square
//     block zero-padded to 64, whose expm it permutes the same way), so
//     its lower-left 32 x 32 block is zero at every lsd <= 32 (zeroed
//     once, never written). A warp a row (conflict-free A_k reads), a
//     thread 8 entries of each of UL, UR and LR, the K-term sums of UL and
//     LR side by side with all of a basis's reads issued before its FMAs
//     (cru_step.cuh's van_loan arithmetic).
//   - expm: expm.cuh's expm_tri_inplace, half the FMAs of the dense form
//     and bit for bit its result up to the sign of a zero (so #7, which
//     recomputes the step with the dense form on the unpermuted block,
//     sees the same E). A pad step has dt = 0, so Bm = 0 and Taylor-4
//     returns exactly I.
//   - cov: the mean E_A post_m and the 3 lod diagonal entries of P the
//     carry needs, one output a thread (E_A = E[:lsd, :lsd],
//     M2 = E[:lsd, 32:32 + lsd]).
// At B = 64 the grid fills 64 of the 132 SMs; splitting a sample over a
// thread-block cluster to fill the rest was measured slower (PERF.md) and
// is not kept. Plain float32 FMA, as kernel #5.

#include "cru_step.cuh"

namespace {

using cru::kMaxK;
using cru::kMaxLsd;
using expm::kH;
using expm::kTriThreads;

constexpr int kChunk = 32;  // steps of observations staged in shared memory at once

struct Layout {  // dynamic shared memory, in floats
  int e, A, W, m, cu, cl, cs, pm, pcu, pcl, pcs, coeff, bias, q, obs, total;
  __host__ __device__ Layout(int lsd, int K) {
    const int lod = lsd / 2;
    e = 0;                                 // expm buffers; buffer 0 holds Bm
    A = e + expm::kSmemFloats;             // A_k [K][lsd][lsd + 1]
    W = A + K * lsd * (lsd + 1);           // coefficient net weight [lsd][K]
    m = W + lsd * K;                       // carry
    cu = m + lsd;
    cl = cu + lod;
    cs = cl + lod;
    pm = cs + lod;                         // posterior of the step
    pcu = pm + lsd;
    pcl = pcu + lod;
    pcs = pcl + lod;
    coeff = pcs + lod;                     // softmax coefficients [K]
    bias = coeff + kMaxK;
    q = bias + kMaxK;                      // diag of the transition noise [lsd]
    obs = q + lsd;                         // kChunk steps of (valid, dt, y [lod], yv [lod])
    total = obs + kChunk * (2 + 2 * lod);
  }
};


__global__ void __launch_bounds__(kTriThreads)
cru_scan_kernel(const float* __restrict__ y, const float* __restrict__ yv,
                const float* __restrict__ valid, const float* __restrict__ dts,
                const float* __restrict__ W, const float* __restrict__ b,
                const float* __restrict__ A, const float* __restrict__ q,
                const float* __restrict__ icu, const float* __restrict__ icl,
                float* __restrict__ out, float* __restrict__ res_m, float* __restrict__ res_cu,
                float* __restrict__ res_cl, float* __restrict__ res_cs,
                int T, int lod, int K, int max_squarings) {
  constexpr int kT = kTriThreads;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[kT / 32];
  const int lsd = 2 * lod, lda = lsd + 1;
  const Layout L(lsd, K);
  float* e = smem + L.e;
  float* A_s = smem + L.A;
  float* W_s = smem + L.W;
  float* m = smem + L.m;
  float* cu = smem + L.cu;
  float* cl = smem + L.cl;
  float* cs = smem + L.cs;
  float* pm = smem + L.pm;
  float* pcu = smem + L.pcu;
  float* pcl = smem + L.pcl;
  float* pcs = smem + L.pcs;
  float* coeff = smem + L.coeff;
  float* q_s = smem + L.q;
  float* b_s = smem + L.bias;
  float* obs = smem + L.obs;  // [kChunk][valid, dt, y [lod], yv [lod]]
  const int ow = 2 + 2 * lod;
  const int tid = threadIdx.x;
  const long long b_idx = blockIdx.x;  // the block's sample

  for (int idx = tid; idx < expm::kSmemFloats; idx += kT) e[idx] = 0.f;
  for (int idx = tid; idx < K * lsd * lsd; idx += kT) {
    const int k = idx / (lsd * lsd), r = (idx / lsd) % lsd, c = idx % lsd;
    A_s[(k * lsd + r) * lda + c] = A[idx];
  }
  for (int idx = tid; idx < lsd * K; idx += kT) W_s[idx] = W[idx];
  if (tid < K) b_s[tid] = b[tid];
  if (tid < lsd) {
    q_s[tid] = q[tid];
    m[tid] = 0.f;
  }
  if (tid < lod) {
    cu[tid] = icu[tid];
    cl[tid] = icl[tid];
    cs[tid] = 0.f;
  }
  __syncthreads();

  // this thread's entries of the Van Loan block: kE of each of UL, UR and
  // LR, the warps on consecutive rows and a warp's lanes on consecutive
  // columns (the A_k reads are free of bank conflicts), as cru::van_loan
  // sums them at 32-offsets: for UL and LR, A_k[off] is the entry's term of
  // basis k (of -A^T in LR), or off = -1: no sum (padding)
  constexpr int kE = kH * kH / kT;  // entries a thread in each block
  auto entry_row = [&](int u) {  // u = blk kE + n
    return (u / kE == 2 ? kH : 0) + (u % kE) * (kT / 32) + tid / 32;
  };
  auto entry_col = [&](int u) { return (u / kE == 0 ? 0 : kH) + tid % 32; };
  auto entry_off = [&](int u) {  // u in UL or LR
    const int i = entry_row(u) % kH, j = entry_col(u) % kH;  // inside the block
    return i < lsd && j < lsd ? (u / kE == 0 ? i * lda + j : j * lda + i) : -1;
  };
  const int n_out = lsd + 3 * lod;  // the mean and the three covariance diagonals

  for (int t = 0; t < T; ++t) {
    const long long bt = b_idx * T + t;
    if (t % kChunk == 0) {  // the next kChunk steps' observations, in one pass
      const int n = min(kChunk, T - t);
      for (int idx = tid; idx < n * lod; idx += kT) {
        const int u = idx / lod, i = idx % lod;
        obs[u * ow + 2 + i] = y[bt * lod + idx];
        obs[u * ow + 2 + lod + i] = yv[bt * lod + idx];
      }
      for (int u = tid; u < n; u += kT) {
        obs[u * ow] = valid[bt + u];
        obs[u * ow + 1] = dts[bt + u];
      }
      __syncthreads();
    }
    const float* ob = obs + (t % kChunk) * ow;  // valid, dt, y, yv of step t

    // residuals: the prior state entering step t; then the update
    if (tid < lsd) res_m[bt * lsd + tid] = m[tid];
    if (tid < lod) {
      res_cu[bt * lod + tid] = cu[tid];
      res_cl[bt * lod + tid] = cl[tid];
      res_cs[bt * lod + tid] = cs[tid];
      const cru::Update u = cru::update(m[tid], m[lod + tid], cu[tid], cl[tid], cs[tid],
                                        ob[2 + tid], ob[2 + lod + tid], ob[0]);
      pm[tid] = u.pm_u;
      pm[lod + tid] = u.pm_l;
      pcu[tid] = u.pcu;
      pcl[tid] = u.pcl;
      pcs[tid] = u.pcs;
    }
    __syncthreads();
    if (tid < lsd) out[bt * lsd + tid] = pm[tid];

    // transition coefficients: softmax over K of post_m W + b (warp 0)
    if (tid < 32) cru::coefficients(pm, W_s, b_s, coeff, lsd, K);
    __syncthreads();  // the coefficients

    // this thread's entries of Bm = (sum_k c_k G_k + QB) dt into buffer 0
    // (its lower-left block stays zero). Only UL and LR hold K-term sums
    // (UR is diag q at (r, 32 + r), r < lsd, and zero elsewhere); each sum in
    // cru::van_loan's order, a basis's terms all read before its FMAs (a
    // term of an entry with no sum reads A_k[0] and is never used).
    {
      constexpr int kS = 2 * kE;  // UL then LR
      auto sum_entry = [&](int v) { return v < kE ? v : v + kE; };
      int off[kS];
      float acc[kS];
#pragma unroll
      for (int v = 0; v < kS; ++v) {
        off[v] = entry_off(sum_entry(v));
        acc[v] = 0.f;
      }
#pragma unroll 3
      for (int k = 0; k < K; ++k) {
        const float ck = coeff[k];
        const float* Akk = A_s + k * lsd * lda;
        float a[kS];
#pragma unroll
        for (int v = 0; v < kS; ++v) a[v] = Akk[max(off[v], 0)];
#pragma unroll
        for (int v = 0; v < kS; ++v) acc[v] = fmaf(ck, a[v], acc[v]);
      }
      const float dt = ob[1];
#pragma unroll
      for (int u = 0; u < 3 * kE; ++u) {
        const int r = entry_row(u), c = entry_col(u), blk = u / kE, v = u < kE ? u : u - kE;
        const float x = blk == 1   ? (r < lsd && c - kH == r ? q_s[r] : 0.f)
                        : off[v] < 0 ? 0.f
                        : blk == 0   ? acc[v]
                                     : -acc[v];
        e[r * expm::kLd + c] = x * dt;
      }
    }
    __syncthreads();
    const float* E = expm::expm_tri_inplace(e, red, max_squarings);

    // m = E_A post_m, and the three covariance diagonals the carry needs:
    // output tid (mean entry tid < lsd, else a diagonal entry)
    if (tid < lsd) {
      float next = 0.f;
#pragma unroll 4
      for (int j = 0; j < lsd; ++j) next = fmaf(E[tid * expm::kLd + j], pm[j], next);
      m[tid] = next;
    } else if (tid < n_out) {
      const int which = (tid - lsd) / lod, i = (tid - lsd) % lod;  // 0: cu, 1: cl, 2: cs
      const int row = which == 1 ? lod + i : i, col = which == 0 ? i : lod + i;
      const float* ea_row = E + row * expm::kLd;  // E_A[row, :] and M2[row, :] at 32 + ..
      const float* ea_col = E + col * expm::kLd;  // E_A[col, :] (P = Cm E_A^T)
      float next = 0.f;
#pragma unroll 4
      for (int j = 0; j < lsd; ++j) {
        const int jj = j < lod ? j : j - lod;
        const float eu = ea_row[jj], el = ea_row[lod + jj];
        const float cm = (j < lod ? eu * pcu[jj] + el * pcs[jj] : eu * pcs[jj] + el * pcl[jj]) +
                         ea_row[kH + j];
        next = fmaf(cm, ea_col[j], next);
      }
      (which == 0 ? cu : which == 1 ? cl : cs)[i] = next;
    }
    __syncthreads();  // the carry
  }
}

}  // namespace

extern "C" int cru_scan_max_lod() { return kMaxLsd / 2; }
extern "C" int cru_scan_max_k() { return kMaxK; }

// y, yv [B,T,lod]; valid, dts [B,T]; W [2lod,K]; b [K]; A [K,2lod,2lod];
// q [2lod]; icu, icl [lod]; out, res_m [B,T,2lod]; res_cu, res_cl, res_cs
// [B,T,lod]; float32, contiguous.
extern "C" int cru_scan_forward(const float* y, const float* yv, const float* valid,
                                const float* dts, const float* W, const float* b,
                                const float* A, const float* q, const float* icu,
                                const float* icl, float* out, float* res_m, float* res_cu,
                                float* res_cl, float* res_cs, int B, int T, int lod, int K,
                                int max_squarings, void* stream) {
  if (B < 0 || T < 0 || lod <= 0 || 2 * lod > kMaxLsd || K <= 0 || K > kMaxK ||
      max_squarings < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T == 0) return 0;
  const int bytes = Layout(2 * lod, K).total * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(cru_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cru_scan_kernel<<<B, kTriThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      y, yv, valid, dts, W, b, A, q, icu, icl, out, res_m, res_cu, res_cl, res_cs, T, lod, K,
      max_squarings);
  return static_cast<int>(cudaGetLastError());
}
