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
// products of 2n^3 FLOPs, n = 2lsd = 64 for the CRU preset) dwarfs the
// bytes: the call reads y, y_var [B,T,lod], valid and dt and writes the
// post-means and residuals, 4 B T (3 lsd + 3 lod + 2) bytes in all.
//
// Design: one block of 256 threads per sample walks all T steps with the
// carry in shared memory, so no intermediate reaches device memory. The
// Van Loan block [[A, Q], [0, -A^T]] dt is assembled in shared memory each
// step from the K blocks A_k [K, lsd, lsd] (61 KB at K = 15, lsd = 32;
// their row stride lsd + 1 keeps the transposed reads free of bank
// conflicts): the TPU kernel's bigG [K, 2lsd, 2lsd] is 245 KB, more than
// the 227 KB of shared memory a Hopper block can have. The expm is
// expm.cuh's, shared with kernel #5, its tier chosen per sample and step;
// a pad step has dt = 0, so Bm = 0 and Taylor-4 returns exactly I. Of the
// covariance P only the 3 lod diagonal entries that the carry needs are
// computed. At B = 64 the grid fills 64 of the 132 SMs (one block per SM:
// 151 KB of shared memory). Plain float32 FMA, as kernel #5.

#include "cru_step.cuh"

namespace {

using cru::kMaxK;
using cru::kMaxLsd;

struct Layout {  // dynamic shared memory, in floats
  int e, A, W, m, cu, cl, cs, pm, pcu, pcl, pcs, coeff, bias, q, total;
  __host__ __device__ Layout(int lsd, int K) {
    const int lod = lsd / 2;
    e = 0;                                 // expm buffers; buffer 0 holds Bm, then E
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
    total = q + lsd;
  }
};

__global__ void __launch_bounds__(expm::kThreads)
cru_scan_kernel(const float* __restrict__ y, const float* __restrict__ yv,
                const float* __restrict__ valid, const float* __restrict__ dts,
                const float* __restrict__ W, const float* __restrict__ b,
                const float* __restrict__ A, const float* __restrict__ q,
                const float* __restrict__ icu, const float* __restrict__ icl,
                float* __restrict__ out, float* __restrict__ res_m, float* __restrict__ res_cu,
                float* __restrict__ res_cl, float* __restrict__ res_cs,
                int T, int lod, int K, int max_squarings) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[expm::kWarps];
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
  const int tid = threadIdx.x;
  const long long b_idx = blockIdx.x;

  for (int idx = tid; idx < K * lsd * lsd; idx += expm::kThreads) {
    const int k = idx / (lsd * lsd), r = (idx / lsd) % lsd, c = idx % lsd;
    A_s[(k * lsd + r) * lda + c] = A[idx];
  }
  for (int idx = tid; idx < lsd * K; idx += expm::kThreads) W_s[idx] = W[idx];
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

  for (int t = 0; t < T; ++t) {
    const long long bt = b_idx * T + t;
    const float v = valid[bt], dt = dts[bt];

    // residuals: the prior state entering step t; then the update
    if (tid < lsd) res_m[bt * lsd + tid] = m[tid];
    if (tid < lod) {
      res_cu[bt * lod + tid] = cu[tid];
      res_cl[bt * lod + tid] = cl[tid];
      res_cs[bt * lod + tid] = cs[tid];
      const cru::Update u = cru::update(m[tid], m[lod + tid], cu[tid], cl[tid], cs[tid],
                                        y[bt * lod + tid], yv[bt * lod + tid], v);
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
    __syncthreads();

    // Van Loan block Bm = (sum_k c_k G_k + QB) dt in buffer 0, zero-padded
    // to kN x kN (the last expm left exp of the padding there)
    for (int idx = tid; idx < expm::kN * expm::kN; idx += expm::kThreads) {
      const int r = idx / expm::kN, c = idx % expm::kN;
      e[r * expm::kLd + c] = cru::van_loan(r, c, coeff, A_s, lda, q_s, lsd, K) * dt;
    }
    __syncthreads();
    expm::expm_inplace(e, red, max_squarings);

    // m = E_A post_m, and the three covariance diagonals the carry needs
    float next = 0.f;
    if (tid < lsd) {
      for (int j = 0; j < lsd; ++j) next = fmaf(e[tid * expm::kLd + j], pm[j], next);
    } else if (tid >= 64 && tid < 64 + 3 * lod) {
      const int which = (tid - 64) / lod, i = (tid - 64) % lod;  // 0: cu, 1: cl, 2: cs
      const int row = which == 1 ? lod + i : i, col = which == 0 ? i : lod + i;
      const float* ea_row = e + row * expm::kLd;  // E_A[row, :] and M2[row, :]
      const float* ea_col = e + col * expm::kLd;  // E_A[col, :] (P = Cm E_A^T)
      for (int j = 0; j < lsd; ++j) {
        const int jj = j < lod ? j : j - lod;
        const float eu = ea_row[jj], el = ea_row[lod + jj];
        const float cm = (j < lod ? eu * pcu[jj] + el * pcs[jj] : eu * pcs[jj] + el * pcl[jj]) +
                         ea_row[lsd + j];
        next = fmaf(cm, ea_col[j], next);
      }
    }
    __syncthreads();  // every read of the step's posterior and of E is done
    if (tid < lsd) {
      m[tid] = next;
    } else if (tid >= 64 && tid < 64 + 3 * lod) {
      const int which = (tid - 64) / lod, i = (tid - 64) % lod;
      (which == 0 ? cu : which == 1 ? cl : cs)[i] = next;
    }
    __syncthreads();
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
  cru_scan_kernel<<<B, expm::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      y, yv, valid, dts, W, b, A, q, icu, icl, out, res_m, res_cu, res_cl, res_cs, T, lod, K,
      max_squarings);
  return static_cast<int>(cudaGetLastError());
}
