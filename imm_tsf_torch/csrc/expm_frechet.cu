// Batched Frechet derivative of the matrix exponential: the backward of
// the expm on the CRU's default route.
//
// Replaces the TPU kernel imm_tsf_tpu/ops/pallas/expm_kernel.py
// (expm_frechet_pallas -> _expm_frechet_kernel -> frechet_value):
// L_exp(M)[E] of every pair of M, E [B, n, n] float32, n <= 64, by the
// (value, derivative) pair recursion of frechet.cuh: Taylor-12 on M/2^k
// and the k squarings that matrix needs. ops/expm.py calls it with M^T and
// the cotangent G, which gives the expm's adjoint L_exp(M^T)[G].
//
// Bound on an H100: operations. A matrix costs 3 (5 + k) products of 2n^3
// FLOPs against 12n^2 bytes in and out: at n = 64 that is 160 FLOPs a
// byte and more, far above the card's 20 FLOPs a byte in float32 outside
// the tensor cores.
//
// Design: one matrix on a thread-block cluster of C CTAs (C = 1, 2 or 4,
// chosen by the wrapper from the batch and the clusters the card holds at
// once, kernels/_cluster.py), team.cuh's `Cluster` team, as kernel #7
// runs its step: each CTA keeps full copies of the eight 64 x 68 float
// buffers (139,264 bytes: the polynomial's pieces overwrite powers that
// are no longer read, so ten live pairs fit), computes 64 / C rows of
// every pair product in one pass over k, writes them into every CTA's
// copy over distributed shared memory, and one cluster barrier a product
// makes them visible (each result goes to a pair of buffers that product
// does not read: frechet.cuh's kPingPong). The squaring count is chosen
// per matrix from each CTA's own copy, so all CTAs of a cluster take the
// same squarings. At the CRU's [32, 64, 64] one CTA a matrix filled 32 of
// the 132 SMs; clusters of two fill 64.
//
// The products are bound by shared-memory reads, not FMAs: a 16-byte
// read takes four of the SM's 128-byte cycles, and a thread's (R x 4)
// patch reads 2R + 8 of them for 48R FMAs every four k. So a CTA has 128
// threads and a thread a taller (8 / C) x 4 patch (kernel #7's 256 threads
// take (4 / C) x 4). Plain float32 FMA, as kernel #5: the JAX package pins
// this expm and its derivative to full float32, and 3xTF32 products,
// emulated on the CPU (tests/test_torch_tf32x3_ffn_frechet.py), stray past
// half the tolerance after 7 squarings (PERF.md).

#include "frechet.cuh"
#include "team.cuh"

namespace {

constexpr int kThreads = 128;

template <int C>
__global__ void __launch_bounds__(kThreads)
frechet_kernel(const float* __restrict__ M, const float* __restrict__ E, float* __restrict__ out,
               int n, int max_squarings) {
  using Team = expm::Cluster<C, true, kThreads>;
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  __shared__ float red[expm::kWarps];
  const long long base = static_cast<long long>(blockIdx.x / C) * n * n;
  for (int idx = threadIdx.x; idx < expm::kN * expm::kN; idx += kThreads) {
    const int r = idx / expm::kN, c = idx % expm::kN;
    const bool in = r < n && c < n;
    s[r * expm::kLd + c] = in ? M[base + r * n + c] : 0.f;
    s[expm::kMat + r * expm::kLd + c] = in ? E[base + r * n + c] : 0.f;
  }
  Team::sync();  // every CTA of the cluster runs before any writes another's memory
  expm::frechet_inplace<Team>(s, red, max_squarings);
  // this CTA's rows of L; no CTA writes another's memory after the last
  // cluster barrier of frechet_inplace, so each may leave when done
  const int rows = expm::kN / C, r0 = Team::rank() * rows;
  const int r_end = min(r0 + rows, n);
  for (int idx = threadIdx.x; idx < (r_end - r0) * n; idx += kThreads) {
    const int r = r0 + idx / n, c = idx % n;
    out[base + r * n + c] = s[expm::kMat + r * expm::kLd + c];
  }
}

}  // namespace

extern "C" int expm_frechet_max_n() { return expm::kN; }

// *out = how many clusters of `cluster` CTAs (1, 2 or 4) the card holds at
// once (cudaOccupancyMaxActiveClusters)
extern "C" int expm_frechet_active_clusters(int cluster, int* out) {
  const int bytes = expm::kFrechetSmemBytes;
  switch (cluster) {
    case 1: return expm::active_clusters(frechet_kernel<1>, 1, kThreads, bytes, out);
    case 2: return expm::active_clusters(frechet_kernel<2>, 2, kThreads, bytes, out);
    case 4: return expm::active_clusters(frechet_kernel<4>, 4, kThreads, bytes, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// M, E, out [B, n, n] float32, contiguous; n <= expm_frechet_max_n().
// One matrix a cluster of `cluster` CTAs (1, 2 or 4).
extern "C" int expm_frechet_forward(const float* M, const float* E, float* out, int B, int n,
                                    int max_squarings, int cluster, void* stream) {
  if (B < 0 || n <= 0 || n > expm::kN || max_squarings < 0 ||
      (cluster != 1 && cluster != 2 && cluster != 4) ||
      static_cast<long long>(B) * cluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int bytes = expm::kFrechetSmemBytes;
  auto s = static_cast<cudaStream_t>(stream);
  switch (cluster) {
    case 1:
      return expm::launch_clusters(frechet_kernel<1>, 1, B, kThreads, bytes, s, M, E, out, n,
                                   max_squarings);
    case 2:
      return expm::launch_clusters(frechet_kernel<2>, 2, 2 * B, kThreads, bytes, s, M, E, out,
                                   n, max_squarings);
    default:
      return expm::launch_clusters(frechet_kernel<4>, 4, 4 * B, kThreads, bytes, s, M, E, out,
                                   n, max_squarings);
  }
}
