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
// so device memory, not arithmetic, sets the floor (~1.9 us at 3.35 TB/s).
// The call is one wave of small blocks: most of its time is the launch
// itself (an empty kernel on the same grid takes ~2 us back to back) and
// the memory round trip a block waits on (PERF.md).
//
// Design:
// - A block owns one sample b, a slab of `threads` x W columns of d and a
//   few forecast times (the host splits T over gridDim.z), so every V
//   element is read from device memory once.
// - Every load a block needs goes out first, so it waits on one round
//   trip, not one a note: a thread's W columns (W = 4: one 16-byte load a
//   note) of a chunk of NC notes into registers, and tau, mask, sigma and
//   t_hat beside them. No branch on a loaded value comes before them.
// - The weights are computed in parallel, once per (n, t): lane k of each
//   group of NC lanes owns note k of the chunk, the groups take the times
//   in turn (one round when the block has at most threads / NC times), and
//   a shuffle sum over the group gives each time's denominator, once per t.
//   Both go to shared memory; the last chunk turns each denominator into
//   one reciprocal.
// - Every thread then walks the block's times (unrolled by 4), reads a
//   time's NC weights as float4 broadcasts and writes E[t, its columns] with
//   one 16-byte store (a streaming store, st.global.cs, was no faster).
// - N <= 32 takes one chunk; N > 32 several (kMulti), whose partial sums
//   are stored to E unscaled and read back by the same thread. Any B, N (0
//   included: E = 0), T and d are taken; when d is not a multiple of 4 or V
//   or E is not 16-byte aligned, the same kernel runs with W = 1 (4-byte
//   loads and stores).
// - (t_hat - tau) / sigma is divided as written, like the XLA path
//   _recavg_xla: an approximate reciprocal of sigma (rcp.approx, within an
//   ulp) shifts every weight the same way, and it moved sigma's gradient in
//   a CRU training step 55x farther from float64 than the plain path's
//   (PERF.md). The sums are multiplied by 1 / max(sum, 1e-6), an ulp from
//   dividing. sigma is read from device memory, so the host never
//   synchronises on it.
//
// recavg_forward_tiled is the previous design (one block per sample, 8
// times and 256 columns, V read again for every 8 times, 4-byte stores),
// kept so that chip_smoke.py times the two in one run; recavg_empty
// launches an empty kernel on recavg_forward's grid, the launch floor.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 128;  // threads a block (column groups)
constexpr int kMaxTB = 64;        // forecast times a block

__device__ __forceinline__ float4 ldg(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ void fma_into(float4& acc, float w, const float4& v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}
__device__ __forceinline__ void fma_into(float& acc, float w, float v) { acc = fmaf(w, v, acc); }
__device__ __forceinline__ void scale(float4& a, float s) {
  a.x *= s;
  a.y *= s;
  a.z *= s;
  a.w *= s;
}
__device__ __forceinline__ void scale(float& a, float s) { a *= s; }

template <int W> struct Cols;
template <> struct Cols<4> { using type = float4; };
template <> struct Cols<1> { using type = float; };

// kMulti: N > NC, the notes in several chunks (otherwise one, N <= NC)
template <int W, int NC, bool kMulti>
__global__ void __launch_bounds__(kMaxThreads)
recavg_kernel(const float* __restrict__ tau, const float* __restrict__ t_hat,
              const float* __restrict__ V, const float* __restrict__ mask,
              const float* __restrict__ sigma_p, float* __restrict__ E,
              int N, int T, int d, int t_per_block) {
  using Vec = typename Cols<W>::type;
  static_assert(NC % 4 == 0 && 32 % NC == 0, "weights are read as float4; NC lanes a time");
  __shared__ __align__(16) float w_s[kMaxTB * NC];  // [t][note of the chunk]
  __shared__ float den_s[kMaxTB];  // running sums; 1 / max(sum, 1e-6) after the last chunk

  const long long b = blockIdx.x;
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * W;
  const bool live = col < d;
  const int t0 = blockIdx.z * t_per_block;
  const int nt = min(t_per_block, T - t0);
  const float* V_b = V + b * N * d + col;
  float* E_b = E + (b * T + t0) * d + col;
  const float* that_b = t_hat + b * T + t0;
  // weights: lane k of each group of NC lanes owns note n0 + k; the groups
  // take the block's times in turn
  const int k = threadIdx.x % NC, group = threadIdx.x / NC, groups = blockDim.x / NC;

  for (int n0 = 0;; n0 += NC) {
    const int nc = min(NC, N - n0);
    const bool first = !kMulti || n0 == 0, last = !kMulti || n0 + NC >= N;
    const float sigma = *sigma_p;
    const float tau_k = k < nc ? tau[b * N + n0 + k] : 0.f;
    const float mask_k = k < nc ? mask[b * N + n0 + k] : 0.f;  // 0 past the chunk: w = 0
    float th = that_b[min(group, nt - 1)];
    Vec v[NC];
    const Vec* vp = reinterpret_cast<const Vec*>(V_b + (long long)n0 * d);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      v[j] = Vec{};
      if (live && j < nc) v[j] = ldg(vp + j * (d / W));
    }
    // every lane of a group runs the same number of rounds, for the shuffles
    // (one round when the block's times are at most its groups)
    for (int t = group; t - group < nt; t += groups) {
      const float z = fmaxf(th - tau_k, 0.f) / sigma;
      th = that_b[min(t + groups, nt - 1)];  // the next round's time
      const float w = expf(-(z * z)) * mask_k;
      float s = w;
#pragma unroll
      for (int off = NC / 2; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off, NC);
      if (t < nt) {
        w_s[t * NC + k] = w;
        if (k == 0) {
          if (!first) s += den_s[t];
          den_s[t] = last ? 1.f / fmaxf(s, 1e-6f) : s;
        }
      }
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int t = 0; t < nt; ++t) {
        Vec* out = reinterpret_cast<Vec*>(E_b + (long long)t * d);
        Vec acc = Vec{};
        if (!first) acc = __ldcg(out);  // the earlier chunks' sum
        const float4* wt = reinterpret_cast<const float4*>(w_s + t * NC);
#pragma unroll
        for (int j4 = 0; j4 < NC / 4; ++j4) {
          const float4 w = wt[j4];
          fma_into(acc, w.x, v[4 * j4]);
          fma_into(acc, w.y, v[4 * j4 + 1]);
          fma_into(acc, w.z, v[4 * j4 + 2]);
          fma_into(acc, w.w, v[4 * j4 + 3]);
        }
        if (last) scale(acc, den_s[t]);
        *out = acc;
      }
    }
    if (last) break;
    __syncthreads();  // the next chunk rewrites w_s and den_s
  }
}

__global__ void empty_kernel() {}

dim3 grid_of(int B, int T, int d, int W, int threads, int t_per_block) {
  const int groups = (d + W - 1) / W;
  return dim3(B, (groups + threads - 1) / threads, (T + t_per_block - 1) / t_per_block);
}

bool config_ok(const dim3& grid, int threads, int t_per_block) {
  return threads % 32 == 0 && threads >= 32 && threads <= kMaxThreads && t_per_block >= 1 &&
         t_per_block <= kMaxTB && grid.y <= 65535 && grid.z <= 65535;
}

template <int W>
void launch(int N, dim3 grid, int threads, cudaStream_t stream, const float* tau,
            const float* t_hat, const float* V, const float* mask, const float* sigma, float* E,
            int T, int d, int t_per_block) {
  if (N <= 8)
    recavg_kernel<W, 8, false><<<grid, threads, 0, stream>>>(tau, t_hat, V, mask, sigma, E, N,
                                                             T, d, t_per_block);
  else if (N <= 16)
    recavg_kernel<W, 16, false><<<grid, threads, 0, stream>>>(tau, t_hat, V, mask, sigma, E, N,
                                                              T, d, t_per_block);
  else if (N <= 32)
    recavg_kernel<W, 32, false><<<grid, threads, 0, stream>>>(tau, t_hat, V, mask, sigma, E, N,
                                                              T, d, t_per_block);
  else
    recavg_kernel<W, 32, true><<<grid, threads, 0, stream>>>(tau, t_hat, V, mask, sigma, E, N,
                                                             T, d, t_per_block);
}

// ------------------------------------------------------- the previous design
constexpr int kTT = 8;               // forecast times per block
constexpr int kNC = 32;              // notes per shared-memory chunk
constexpr int kThreads = kTT * kNC;  // one weight per thread per chunk; also d columns per block

__global__ void __launch_bounds__(kThreads)
recavg_tiled_kernel(const float* __restrict__ tau, const float* __restrict__ t_hat,
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

// threads: column groups a block (32, 64, 96 or 128); t_per_block: forecast
// times a block (1-64). Returns a cudaError_t.
extern "C" int recavg_forward(const float* tau, const float* t_hat, const float* V,
                              const float* mask, const float* sigma, float* E, int B, int N,
                              int T, int d, int threads, int t_per_block, void* stream) {
  const bool aligned = d % 4 == 0 && reinterpret_cast<uintptr_t>(V) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(E) % 16 == 0;
  const int W = aligned ? 4 : 1;
  const dim3 grid = grid_of(B, T, d, W, threads, t_per_block);
  if (!config_ok(grid, threads, t_per_block)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (aligned)
    launch<4>(N, grid, threads, s, tau, t_hat, V, mask, sigma, E, T, d, t_per_block);
  else
    launch<1>(N, grid, threads, s, tau, t_hat, V, mask, sigma, E, T, d, t_per_block);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the grid and block recavg_forward launches for a
// 16-byte aligned V with d a multiple of 4.
extern "C" int recavg_empty(int B, int T, int d, int threads, int t_per_block, void* stream) {
  const dim3 grid = grid_of(B, T, d, d % 4 == 0 ? 4 : 1, threads, t_per_block);
  if (!config_ok(grid, threads, t_per_block)) return static_cast<int>(cudaErrorInvalidValue);
  empty_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int recavg_forward_tiled(const float* tau, const float* t_hat, const float* V,
                                    const float* mask, const float* sigma, float* E, int B,
                                    int N, int T, int d, void* stream) {
  const dim3 grid(B, (T + kTT - 1) / kTT, (d + kThreads - 1) / kThreads);
  recavg_tiled_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tau, t_hat, V, mask, sigma, E, N, T, d);
  return static_cast<int>(cudaGetLastError());
}
