// Causal, key-padded attention for the frozen GPT-2, forward only.
//
// Replaces the TPU kernel imm_tsf_tpu/ops/pallas/attn_kernel.py
// (fused_causal_attention -> _attn_pallas -> _attn_kernel):
//
//     keep[q,k] = k <= q and pad[b,k] > 0
//     out[b,h,q,:] = softmax_{k kept}(Q K^T / sqrt(D)) V, or 0 where no key is kept
//
// over q, k, v [B,H,T,D] float32 (contiguous), pad [B,T] float32.
//
// Bound on an H100: operations at long T, bytes at short T. The call must
// read q, k, v and pad once and write out once (4(4BHTD + BT) bytes) and
// does 4 BHD T(T+1)/2 multiply-adds' worth of FLOPs in the causal half;
// at [64,12,1024,64] that is 103 GFLOP against 805 MB, so float32
// arithmetic sets the floor; at [1024,12,32,64] it is 1.7 GFLOP against
// 403 MB, so device memory does.
//
// Design. The TPU kernel holds the whole [T,T] score tile in VMEM; a
// Hopper block has 227 KB of shared memory, and [1024,1024] floats are
// 4 MB. Here one block of 256 threads takes one (b, h, 64-row query
// tile) and walks the keys 64 at a time with an online softmax: Q^T, K^T
// and V tiles are staged through shared memory, each thread computes a
// 4x4 patch of the 64x64 score tile with float4 shared-memory reads, the
// running row max and row sum stay in registers (rows are reduced across
// the 16 threads that share them with warp shuffles), the probabilities
// go through shared memory once, and each thread accumulates its 4 rows
// x DP/16 columns of the output in registers. So no [T,T] tensor ever
// reaches device memory. Key tiles above the causal diagonal are skipped,
// and so are key tiles past the sample's last real token (notes are
// right-padded; each block finds that token itself from pad). Query tiles
// are issued longest first. Plain float32 FMA: TF32/bf16 tensor cores
// (wgmma) and TMA would change the float32 comparison contract, and are
// left for a later change.
//
// Masked scores take no part in the max or the sum; a row whose sum is 0
// writes exact zeros, never NaN, as the TPU kernel and
// layers.attention.masked_softmax do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per shared-memory tile
constexpr int kThreads = 256;     // 16 x 16 threads: 4 query rows x 4 keys each
constexpr int kLd = kBK + 4;      // row stride of the transposed tiles (float4 aligned)

template <int DP>
struct Layout {                   // dynamic shared memory, in floats
  static constexpr int kVLd = DP + 4;
  static constexpr int q = 0;                    // Q^T [DP][kLd]
  static constexpr int k = q + DP * kLd;         // K^T [DP][kLd]
  static constexpr int v = k + DP * kLd;         // V   [kBK][kVLd]
  static constexpr int p = v + kBK * kVLd;       // P^T [kBK][kLd]
  static constexpr int keep = p + kBK * kLd;     // key kept by pad [kBK]
  static constexpr int total = keep + kBK;
};

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float4 load4(const float* p, bool ok) {
  return ok ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// rows [row0, row0 + kBQ) of a [T, D] slice into a transposed [DP][kLd]
// tile; lanes walk rows, so the four scalar stores of a float4 hit
// distinct banks. Rows past T and columns past D are zero.
template <int DP>
__device__ __forceinline__ void stage_transposed(float* dst, const float* src,
                                                 int row0, int T, int D) {
  for (int f = threadIdx.x; f < kBQ * (DP / 4); f += kThreads) {
    const int r = f % kBQ, c = (f / kBQ) * 4;
    const float4 x = load4(src + (long long)(row0 + r) * D + c, row0 + r < T && c < D);
    dst[(c + 0) * kLd + r] = x.x;
    dst[(c + 1) * kLd + r] = x.y;
    dst[(c + 2) * kLd + r] = x.z;
    dst[(c + 3) * kLd + r] = x.w;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
attn_kernel(const float* __restrict__ Q, const float* __restrict__ K,
            const float* __restrict__ V, const float* __restrict__ pad,
            float* __restrict__ O, int H, int T, int D, float scale) {
  using L = Layout<DP>;
  constexpr int kCols = DP / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* q_s = smem + L::q;
  float* k_s = smem + L::k;
  float* v_s = smem + L::v;
  float* p_s = smem + L::p;
  float* keep_s = smem + L::keep;
  __shared__ int kv_len_s;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long bh = blockIdx.x;
  const int b = static_cast<int>(bh / H);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest query tiles first
  const long long base = bh * T * D;
  const float* pad_b = pad + (long long)b * T;

  // one past the sample's last real token: keys from there on are all padded
  if (tid == 0) kv_len_s = 0;
  __syncthreads();
  int last = 0;
  for (int t = tid; t < T; t += kThreads)
    if (pad_b[t] > 0.f) last = t + 1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
  if ((tid & 31) == 0) atomicMax(&kv_len_s, last);
  stage_transposed<DP>(q_s, Q + base, q0, T, D);
  __syncthreads();
  const int k_end = min(kv_len_s, min(q0 + kBQ, T));

  float m[4], l[4], o[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    stage_transposed<DP>(k_s, K + base, k0, T, D);
    for (int f = tid; f < kBK * (DP / 4); f += kThreads) {
      const int r = f / (DP / 4), c = (f % (DP / 4)) * 4;
      *reinterpret_cast<float4*>(v_s + r * L::kVLd + c) =
          load4(V + base + (long long)(k0 + r) * D + c, k0 + r < T && c < D);
    }
    if (tid < kBK) keep_s[tid] = (k0 + tid < T && pad_b[k0 + tid] > 0.f) ? 1.f : 0.f;
    __syncthreads();

    // scores for rows ty*4+i, keys tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(q_s + d * kLd + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(k_s + d * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // online softmax over this tile
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx * 4 + j;
        const bool kept = keep_s[key] > 0.f && k0 + key <= row;
        s[i][j] = kept ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      // m_new == -inf: no key of this row is kept yet, nothing to rescale
      const float corr = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        sum += p[i][j];
      }
      l[i] = l[i] * corr + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(p_s + (tx * 4 + j) * kLd + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    // out rows ty*4+i, columns tx*4 + {0..3} (+ 64 when DP = 128)
    const int n_keys = min(kBK, k_end - k0);
    for (int key = 0; key < n_keys; ++key) {
      const float4 a = *reinterpret_cast<const float4*>(p_s + key * kLd + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int half = 0; half < kCols / 4; ++half) {
        const float4 c = *reinterpret_cast<const float4*>(v_s + key * L::kVLd + half * 64 + tx * 4);
        const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            o[i][half * 4 + jj] = fmaf(av[i], cv[jj], o[i][half * 4 + jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= T) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // no kept key: exact zeros
#pragma unroll
    for (int half = 0; half < kCols / 4; ++half) {
      const int col = half * 64 + tx * 4;
      if (col < D)
        *reinterpret_cast<float4*>(O + base + (long long)row * D + col) =
            make_float4(o[i][half * 4 + 0] * inv, o[i][half * 4 + 1] * inv,
                        o[i][half * 4 + 2] * inv, o[i][half * 4 + 3] * inv);
    }
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, const float* pad, float* out,
           int B, int H, int T, int D, float scale, cudaStream_t stream) {
  const int bytes = Layout<DP>::total * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(attn_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (T + kBQ - 1) / kBQ);
  attn_kernel<DP><<<grid, kThreads, bytes, stream>>>(q, k, v, pad, out, H, T, D, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int attn_max_d() { return 128; }

// q, k, v, out [B,H,T,D] and pad [B,T], float32 and contiguous. D must be a
// multiple of 4 and at most attn_max_d(); the wrapper pads D up to that.
extern "C" int attn_forward(const float* q, const float* k, const float* v,
                            const float* pad, float* out, int B, int H, int T,
                            int D, float scale, void* stream) {
  if (D <= 0 || D % 4 != 0 || D > 128 || (T + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || T == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch<64>(q, k, v, pad, out, B, H, T, D, scale, s)
                 : launch<128>(q, k, v, pad, out, B, H, T, D, scale, s);
}
