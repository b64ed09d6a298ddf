// Recency-weighted note average for TTF_RecAvg, forward only.
//
// Replaces the TPU kernel imm_tsf_tpu/ops/pallas/fusion_kernels.py
// (recency_weighted_average -> _recavg_pallas -> _recavg_kernel):
//
//     w[n,t] = exp(-(max(t_hat[t] - tau[n], 0) / sigma)^2) * mask[n]
//     E[t,:] = sum_n w[n,t] V[n,:] / max(sum_n w[n,t], 1e-6)
//
// Bound on an H100: bytes. At the serving shape (B=64, N=8, T=24, d=768)
// the call reads V once (1.6 MB) and writes E (4.7 MB) and does ~19 MFLOP,
// so device memory, not arithmetic, sets the floor (~2 us at 3.35 TB/s);
// in practice the launch itself dominates.
//
// Design: one block per (sample b, tile of kTT forecast times, kThreads
// columns of d). The block computes its kNC x kTT weights for one chunk of
// notes at a time into shared memory (one weight per thread), so no
// [B,N,T] tensor ever reaches device memory; each thread then walks the
// chunk's notes for its own column of V, reading V coalesced and keeping
// the kTT sums and denominators in registers. Any B, N, T and d are taken:
// ragged edges are masked in the kernel. sigma is read from device memory,
// so the host never synchronises on it. (t_hat - tau) / sigma is computed
// as written, like the XLA path _recavg_xla, not pre-divided like the TPU
// kernel; the two differ by an ulp.

#include <cuda_runtime.h>

namespace {

constexpr int kTT = 8;                 // forecast times per block
constexpr int kNC = 32;                // notes per shared-memory chunk
constexpr int kThreads = kTT * kNC;    // one weight per thread per chunk; also d columns per block

__global__ void __launch_bounds__(kThreads)
recavg_kernel(const float* __restrict__ tau, const float* __restrict__ t_hat,
              const float* __restrict__ V, const float* __restrict__ mask,
              const float* __restrict__ sigma_p, float* __restrict__ E,
              int N, int T, int d) {
  __shared__ float w_s[kNC][kTT];
  const long long b = blockIdx.x;
  const int t0 = blockIdx.y * kTT;
  const int col = blockIdx.z * kThreads + threadIdx.x;
  const float sigma = *sigma_p;
  const float* tau_b = tau + b * N;
  const float* mask_b = mask + b * N;
  const float* that_b = t_hat + b * T;
  const float* V_b = V + b * N * d;

  float acc[kTT], den[kTT];
#pragma unroll
  for (int i = 0; i < kTT; ++i) {
    acc[i] = 0.f;
    den[i] = 0.f;
  }

  for (int n0 = 0; n0 < N; n0 += kNC) {
    {
      const int nn = threadIdx.x / kTT, tt = threadIdx.x % kTT;
      const int n = n0 + nn, t = t0 + tt;
      float w = 0.f;
      if (n < N && t < T) {
        const float z = fmaxf(that_b[t] - tau_b[n], 0.f) / sigma;
        w = expf(-(z * z)) * mask_b[n];
      }
      w_s[nn][tt] = w;
    }
    __syncthreads();
    const int nmax = min(kNC, N - n0);
    for (int nn = 0; nn < nmax; ++nn) {
      const float v = col < d ? V_b[(long long)(n0 + nn) * d + col] : 0.f;
#pragma unroll
      for (int tt = 0; tt < kTT; ++tt) {
        const float w = w_s[nn][tt];
        acc[tt] = fmaf(w, v, acc[tt]);
        den[tt] += w;
      }
    }
    __syncthreads();
  }

  if (col < d) {
#pragma unroll
    for (int tt = 0; tt < kTT; ++tt) {
      const int t = t0 + tt;
      if (t < T) E[(b * T + t) * d + col] = acc[tt] / fmaxf(den[tt], 1e-6f);
    }
  }
}

}  // namespace

extern "C" int recavg_forward(const float* tau, const float* t_hat,
                              const float* V, const float* mask,
                              const float* sigma, float* E,
                              int B, int N, int T, int d, void* stream) {
  const dim3 grid(B, (T + kTT - 1) / kTT, (d + kThreads - 1) / kThreads);
  recavg_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tau, t_hat, V, mask, sigma, E, N, T, d);
  return static_cast<int>(cudaGetLastError());
}
