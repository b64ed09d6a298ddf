// expm.cuh's team over a thread-block cluster, and the launch of a kernel
// on clusters: shared by csrc/expm_frechet.cu (kernel #4, one matrix a
// cluster) and csrc/cru_scan_bwd.cu (kernel #7, one sample a cluster);
// csrc/expm.cu (kernel #5) runs its dense form on a cluster of one.
//
// Cluster<C, PingPong, Threads>: C CTAs (1, 2 or 4) of Threads threads
// (expm::kThreads or 128) run one matrix function together. Each CTA keeps
// a full copy of every buffer; CTA r owns rows [r 64 / C, (r + 1) 64 / C)
// of each, a thread a kRows x 4 patch of them (kRows = 4 / C at 256
// threads, 8 / C at 128). A thread writes its patch into the same buffer
// of every CTA over distributed shared memory (put), and a cluster barrier
// (sync) makes the copies visible. The inf-norm is taken from each CTA's own copy: the
// copies are equal, so every CTA takes the same squarings and meets the
// same barriers. A cluster of one is a plain block: local stores and
// __syncthreads. With PingPong, frechet.cuh's products take one barrier
// each instead of two (kernel #4; kernel #7 keeps the two).

#pragma once

#include <cooperative_groups.h>

#include "expm.cuh"

namespace expm {

template <int C, bool PingPong = false, int Threads = kThreads>
struct Cluster {
  static constexpr int kThreads = Threads;
  static constexpr int kRows = kN / C * kN / Threads / 4;
  static constexpr bool kPingPong = PingPong;
  __device__ static int rank() {
    if constexpr (C == 1) return 0;
    else return static_cast<int>(cooperative_groups::this_cluster().block_rank());
  }
  __device__ static int row0() { return rank() * (kN / C) + (threadIdx.x / 16) * kRows; }
  __device__ static int col0() { return (threadIdx.x % 16) * 4; }
  template <class V>  // float or float4
  __device__ static void put(float* s, const V& v) {
    if constexpr (C == 1) {
      *reinterpret_cast<V*>(s) = v;
    } else {
      cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
#pragma unroll
      for (int r = 0; r < C; ++r)
        *reinterpret_cast<V*>(cluster.map_shared_rank(s, static_cast<unsigned>(r))) = v;
    }
  }
  __device__ static void sync() {
    if constexpr (C == 1) __syncthreads();
    else cooperative_groups::this_cluster().sync();
  }
  // max row sum of |M| over this CTA's whole copy (equal in every CTA);
  // ends with a cluster barrier, so no copy is written while one is read
  __device__ static float norm(const float* s, float* red) {
    const float norm = block_inf_norm<Threads>(s, red);
    sync();
    return norm;
  }
};

// A launch of `kernel` on clusters of C CTAs, `ctas` CTAs of `threads`
// threads in all, with `bytes` of dynamic shared memory (opted in here).
template <class Kernel>
cudaError_t cluster_config(Kernel* kernel, int C, int ctas, int threads, int bytes,
                           cudaStream_t stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(ctas));
  cfg->blockDim = dim3(static_cast<unsigned>(threads));
  cfg->dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(C);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// *out = how many clusters of C CTAs of `kernel` the card holds at once
template <class Kernel>
int active_clusters(Kernel* kernel, int C, int threads, int bytes, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, C, C, threads, bytes, nullptr, &cfg, &attr);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
  return static_cast<int>(err);
}

template <class Kernel, class... Args>
int launch_clusters(Kernel* kernel, int C, int ctas, int threads, int bytes,
                    cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, C, ctas, threads, bytes, stream, &cfg, &attr);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace expm
