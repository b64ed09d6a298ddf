// Causal, key-padded attention for the frozen GPT-2, forward only, on the
// tensor cores in float32 accuracy (3xTF32).
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
// does 4 BHD T(T+1)/2 multiply-adds' worth of FLOPs in the causal half.
// Both products run as three TF32 passes on the tensor cores (495 TFLOP/s
// dense TF32 on the H100 SXM), so the operation floor is 3 x FLOPs at that
// rate: at [64,12,1024,64] about 0.57 ms against 805 MB (0.24 ms); at
// [1024,12,32,64] 1.7 GFLOP against 403 MB, so device memory sets the floor.
//
// Precision. One TF32 pass keeps 10 mantissa bits and misses the float32
// contract (|err| <= 2e-5 + 1e-5|ref|). Each float32 operand x is split
// into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna's rounding), and a product takes
// lo*hi, hi*lo and hi*hi, accumulated in float32 by the mma: the dropped
// lo*lo term is below 2^-21 relative (tf32x3.cuh).
// tests/test_torch_attn_tf32x3.py emulates the scheme on the CPU against
// the JAX package's reference.
//
// Design. A block of four warps takes a 64-row tile of query rows; a warp
// owns 16 of them. Keys and values come 64 rows at a time, by 16-byte
// cp.async into padded row-major shared memory (row stride D + 4 floats:
// every mma fragment load below is free of bank conflicts). One tile at a
// time: a block then takes 52 KB at D <= 64, three blocks share an SM
// (registers allow three), and one block's copies overlap the others'
// products; double buffering, at two blocks an SM, was slower.
// S = Q K^T is computed with mma.sync m16n8k8 (tf32 in, float32
// accumulators) and stays in the accumulators: the online softmax runs on
// them in registers, each row's max and sum across the 4 lanes of a quad,
// the sum reduced once at the end. For O += P V the accumulator layout of
// S (lane t holds keys 2t, 2t+1 of an 8-key tile) is used as the A operand
// with the keys of each 8-key tile permuted (A column t <-> key 2t, column
// t + 4 <-> key 2t + 1), and V's rows are read in the same order: the sum
// over keys does not depend on their order, so no shuffle is needed. Key
// tiles above a warp's causal diagonal or past the sample's last real token
// are skipped (each warp finds that token from pad). The three passes of a
// product run over all of a warp's 8-column tiles in turn, so that an mma
// never waits for the one before it. Query tiles are issued longest first.
// Short buckets (T <= 32) pack S = 2 or 4 (b, h) slices into a block, each
// with 64 / S query and key rows, so that no warp idles on padded rows and
// one key tile holds every key.
//
// Masked scores take no part in the max or the sum; a row whose sum is 0
// writes exact zeros, never NaN, as the TPU kernel and
// layers.attention.masked_softmax do.
//
// The one-pass form (`attn_forward_bf16`, compute_dtype="bfloat16": the
// TPU kernel's two dots at DEFAULT precision, attn_kernel.py:47-66) is a
// kernel of its own on the same tiles: S = bf16(Q) bf16(K)^T and O =
// bf16(P) bf16(V), each one mma.sync m16n8k16 bf16 pass with float32
// accumulators (bf16mma.cuh), operands rounded to nearest even where
// their fragments load. JAX rounds the normalised probabilities, P = e /
// sum e, so the online softmax's running rescale cannot be used: the key
// tiles are walked twice, first for each row's max and sum (S only, no V
// load), then for P = exp(S - max) / sum, rounded, times V. The second
// walk recomputes S: 1.5 times the products of one walk, a third of the
// 3xTF32 form's passes at twice the TF32 rate. The 16 keys of two
// adjacent 8-key tiles of S's accumulators are exactly the A fragment of
// P V, so P needs no shuffle; Q and K fragments read d in the order
// (t, t + 4, t + 8, t + 12) of each 16 columns (the sum over d does not
// depend on its order), so every fragment load is conflict-free at the
// float32 form's row stride.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16mma.cuh"
#include "tf32x3.cuh"

namespace {

using tf32x3::cp_async16;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::mma_3xtf32;
using tf32x3::split;
using tf32x3::split4;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows and key rows of a block's tile

template <int DP>
struct Tile {
  static constexpr int kLd = DP + 4;  // row stride in floats (16-byte rows)
  static constexpr int kFloats = kRows * kLd;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S (b, h) slices share a block, each with kRows / S query rows and key
// rows of a tile (S > 1 only when T <= kRows / S: one key tile).
template <int DP, int S>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 3 : 1)
attn_kernel(const float* __restrict__ Q, const float* __restrict__ K,
            const float* __restrict__ V, const float* __restrict__ pad,
            float* __restrict__ O, int BH, int H, int T, int D, float scale) {
  constexpr int kLd = Tile<DP>::kLd;
  constexpr int kFloats = Tile<DP>::kFloats;
  constexpr int kSliceRows = kRows / S;  // a slice's query and key rows in a tile
  constexpr int kNT = kSliceRows / 8;    // 8-key mma tiles of a key tile
  constexpr int kDT = DP / 8;            // 8-column mma tiles of the output
  constexpr int kWarpsPerSlice = kWarps / S;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kRows][kLd]
  float* k_s = q_s + kFloats;                    // [kRows][kLd]
  float* v_s = k_s + kFloats;                    // [kRows][kLd]
  float* keep_s = v_s + kFloats;                 // [kRows]: key kept by pad

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the mma fragments' row group and lane in it
  const int slice = warp / kWarpsPerSlice;
  const long long bh0 = static_cast<long long>(blockIdx.x) * S;  // the block's first slice
  const long long bh = bh0 + slice;
  const int q0 = S == 1 ? (gridDim.y - 1 - blockIdx.y) * kRows : 0;  // longest first
  const int srow = slice * kSliceRows;                  // the slice's first row in a tile
  const int wrow = (warp % kWarpsPerSlice) * 16;        // the warp's first row in its slice

  // one past the last real token of the warp's sample: keys from there on
  // are all padded
  int kv_len = 0;
  if (bh < BH) {
    const float* pad_b = pad + (bh / H) * T;
    for (int j = lane; j < T; j += 32)
      if (pad_b[j] > 0.f) kv_len = j + 1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      kv_len = max(kv_len, __shfl_xor_sync(0xffffffffu, kv_len, off));
  }
  // keys this warp's rows can keep, and the block's key tiles
  const int k_end = (bh < BH && q0 + wrow < T) ? min(kv_len, q0 + wrow + 16) : 0;
  const int n_iter = S == 1 ? (min(kv_len, min(q0 + kRows, T)) + kRows - 1) / kRows : 1;

  // rows [row0, row0 + kSliceRows) of each slice's [T, D] matrix into a
  // [kRows][kLd] tile; rows past T, columns past D and slices past BH are 0
  auto load = [&](float* dst, const float* src, int row0) {
    for (int f = tid; f < kRows * (DP / 4); f += kThreads) {
      const int r = f / (DP / 4), c = (f % (DP / 4)) * 4;
      const int s = r / kSliceRows, row = row0 + r % kSliceRows;
      const bool ok = bh0 + s < BH && row < T && c < D;
      cp_async16(dst + r * kLd + c, ok ? src + ((bh0 + s) * T + row) * D + c : src, ok);
    }
  };
  auto load_keys = [&](int k0) {
    load(k_s, K, k0);
    load(v_s, V, k0);
    if (tid < kRows) {
      const int s = tid / kSliceRows, key = k0 + tid % kSliceRows;
      keep_s[tid] =
          (bh0 + s < BH && key < T && pad[((bh0 + s) / H) * T + key] > 0.f) ? 1.f : 0.f;
    }
  };

  float o[kDT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const int row_a = q0 + wrow + g, row_b = row_a + 8;  // this lane's two rows

  if (n_iter > 0) {
    load(q_s, Q, q0);
    load_keys(0);
    cp_async_commit();
  }
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // this tile has arrived for every thread

    const int k0 = it * kSliceRows;
    if (k0 < k_end) {
      const float* qt = q_s + (srow + wrow) * kLd;
      const float* kt = k_s + srow * kLd;
      const float* vt = v_s + srow * kLd;
      const float* kp = keep_s + srow;

      // S = Q K^T: A = Q rows (g, g + 8) x columns (t, t + 4) of each 8-column step,
      // B = K^T, i.e. K row j*8 + g at columns (t, t + 4)
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        const int d = kk * 8 + t;
        const float a[4] = {qt[g * kLd + d], qt[(g + 8) * kLd + d], qt[g * kLd + d + 4],
                            qt[(g + 8) * kLd + d + 4]};
        uint32_t ah[4], al[4], bh[kNT][2], bl[kNT][2];
        split4(a, ah, al);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float* kr = kt + (j * 8 + g) * kLd + d;
          split(kr[0], bh[j][0], bl[j][0]);
          split(kr[4], bh[j][1], bl[j][1]);
        }
        mma_3xtf32<kNT>(s, ah, al, bh, bl);
      }

      // online softmax on the accumulators: s[j][e] is row (e < 2 ? row_a : row_b),
      // key j*8 + 2t + (e & 1) of the tile
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = j * 8 + 2 * t + (e & 1);
          const bool kept = k0 + kl <= (e < 2 ? row_a : row_b) && kp[kl] > 0.f;
          s[j][e] = kept ? s[j][e] * scale : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        // m_new == -inf: no key of this row is kept yet, nothing to rescale
        const float corr = m_new == -INFINITY ? 1.f : expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr;
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          o[n][2 * r] *= corr;
          o[n][2 * r + 1] *= corr;
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - m[e >> 1]);
          l[e >> 1] += p;  // this lane's share; the quad's sum is taken at the end
          s[j][e] = p;
        }

      // O += P V: A = P with each 8-key tile's keys in the order (0, 2, 4, 6, 1, 3, 5, 7),
      // so lane t's accumulators (keys 2t, 2t + 1) are its A registers; B = V rows
      // 2t and 2t + 1 of the tile, column n*8 + g
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float a[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        uint32_t ah[4], al[4], bh[kDT][2], bl[kDT][2];
        split4(a, ah, al);
        const float* vr = vt + (j * 8 + 2 * t) * kLd + g;
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          split(vr[n * 8], bh[n][0], bl[n][0]);
          split(vr[kLd + n * 8], bh[n][1], bl[n][1]);
        }
        mma_3xtf32<kDT>(o, ah, al, bh, bl);
      }
    }
    __syncthreads();  // every warp is done with the tile before it is refilled
    if (it + 1 < n_iter) {
      load_keys((it + 1) * kRows);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    const int row = r == 0 ? row_a : row_b;
    if (bh >= BH || row >= T) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;  // no kept key: exact zeros
    float* out = O + (bh * T + row) * D;
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < D)
        *reinterpret_cast<float2*>(out + col) =
            make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

// The one-pass bf16 form (the module comment): the float32 kernel's block,
// tiles, slices and causal skips, two walks over the key tiles.
template <int DP, int S>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 3 : 1)
attn_bf16_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                 const float* __restrict__ V, const float* __restrict__ pad,
                 float* __restrict__ O, int BH, int H, int T, int D, float scale) {
  constexpr int kLd = Tile<DP>::kLd;
  constexpr int kFloats = Tile<DP>::kFloats;
  constexpr int kSliceRows = kRows / S;
  constexpr int kNT = kSliceRows / 8;  // 8-key tiles of a key tile: even
  constexpr int kDT = DP / 8;
  constexpr int kWarpsPerSlice = kWarps / S;
  static_assert(kNT % 2 == 0, "P V takes the keys 16 at a time");

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kFloats;
  float* v_s = k_s + kFloats;
  float* keep_s = v_s + kFloats;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int slice = warp / kWarpsPerSlice;
  const long long bh0 = static_cast<long long>(blockIdx.x) * S;
  const long long bh = bh0 + slice;
  const int q0 = S == 1 ? (gridDim.y - 1 - blockIdx.y) * kRows : 0;
  const int srow = slice * kSliceRows;
  const int wrow = (warp % kWarpsPerSlice) * 16;

  int kv_len = 0;
  if (bh < BH) {
    const float* pad_b = pad + (bh / H) * T;
    for (int j = lane; j < T; j += 32)
      if (pad_b[j] > 0.f) kv_len = j + 1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      kv_len = max(kv_len, __shfl_xor_sync(0xffffffffu, kv_len, off));
  }
  const int k_end = (bh < BH && q0 + wrow < T) ? min(kv_len, q0 + wrow + 16) : 0;
  const int n_iter = S == 1 ? (min(kv_len, min(q0 + kRows, T)) + kRows - 1) / kRows : 1;

  auto load = [&](float* dst, const float* src, int row0) {
    for (int f = tid; f < kRows * (DP / 4); f += kThreads) {
      const int r = f / (DP / 4), c = (f % (DP / 4)) * 4;
      const int s = r / kSliceRows, row = row0 + r % kSliceRows;
      const bool ok = bh0 + s < BH && row < T && c < D;
      cp_async16(dst + r * kLd + c, ok ? src + ((bh0 + s) * T + row) * D + c : src, ok);
    }
  };
  // key tile k0's K (and V on the second walk) and keep flags
  auto load_keys = [&](int k0, bool with_v) {
    load(k_s, K, k0);
    if (with_v) load(v_s, V, k0);
    if (tid < kRows) {
      const int s = tid / kSliceRows, key = k0 + tid % kSliceRows;
      keep_s[tid] =
          (bh0 + s < BH && key < T && pad[((bh0 + s) / H) * T + key] > 0.f) ? 1.f : 0.f;
    }
  };

  float o[kDT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const int row_a = q0 + wrow + g, row_b = row_a + 8;

  if (n_iter > 0) {
    load(q_s, Q, q0);
    load_keys(0, false);
    cp_async_commit();
  }
  // it < n_iter: the first walk (max and sum); then the second (P V)
  for (int it = 0; it < 2 * n_iter; ++it) {
    const bool second = it >= n_iter;
    cp_async_wait<0>();
    __syncthreads();

    const int k0 = (it % n_iter) * kSliceRows;
    if (k0 < k_end) {
      const float* qt = q_s + (srow + wrow) * kLd;
      const float* kt = k_s + srow * kLd;
      const float* vt = v_s + srow * kLd;
      const float* kp = keep_s + srow;

      // S = bf16(Q) bf16(K)^T: fragment k (2t, 2t + 1, 2t + 8, 2t + 9) of each
      // 16 columns reads d (t, t + 4, t + 8, t + 12)
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        const float* qa = qt + g * kLd + kk + t;
        const float* qb = qa + 8 * kLd;
        const uint32_t a[4] = {bf16mma::pack(qa[0], qa[4]), bf16mma::pack(qb[0], qb[4]),
                               bf16mma::pack(qa[8], qa[12]), bf16mma::pack(qb[8], qb[12])};
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float* kr = kt + (j * 8 + g) * kLd + kk + t;
          const uint32_t b[2] = {bf16mma::pack(kr[0], kr[4]), bf16mma::pack(kr[8], kr[12])};
          bf16mma::mma16(s[j], a, b);
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = j * 8 + 2 * t + (e & 1);
          const bool kept = k0 + kl <= (e < 2 ? row_a : row_b) && kp[kl] > 0.f;
          s[j][e] = kept ? s[j][e] * scale : -INFINITY;
        }

      if (!second) {
        // each row's running max, and this lane's share of the sum at it
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], quad_max(mx[r]));
          l[r] *= m_new == -INFINITY ? 1.f : expf(m[r] - m_new);
          m[r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (s[j][e] != -INFINITY) l[e >> 1] += expf(s[j][e] - m[e >> 1]);
      } else {
        // P = exp(S - max) / sum (0 where masked), rounded with V, into O: the
        // accumulators of 8-key tiles jj and jj + 1 are P's A fragment
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - m[e >> 1]) / l[e >> 1];
#pragma unroll
        for (int jj = 0; jj < kNT; jj += 2) {
          const uint32_t a[4] = {bf16mma::pack(s[jj][0], s[jj][1]),
                                 bf16mma::pack(s[jj][2], s[jj][3]),
                                 bf16mma::pack(s[jj + 1][0], s[jj + 1][1]),
                                 bf16mma::pack(s[jj + 1][2], s[jj + 1][3])};
          const float* vr = vt + (jj * 8 + 2 * t) * kLd + g;
#pragma unroll
          for (int n = 0; n < kDT; ++n) {
            const uint32_t b[2] = {bf16mma::pack(vr[n * 8], vr[kLd + n * 8]),
                                   bf16mma::pack(vr[8 * kLd + n * 8], vr[9 * kLd + n * 8])};
            bf16mma::mma16(o[n], a, b);
          }
        }
      }
    }
    if (it == n_iter - 1) {  // the first walk is over: each row's whole sum
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
    }
    __syncthreads();
    if (it + 1 < 2 * n_iter) {
      load_keys(((it + 1) % n_iter) * kRows, it + 1 >= n_iter);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_a : row_b;
    if (bh >= BH || row >= T) continue;
    float* out = O + (bh * T + row) * D;  // a row with no kept key: o = 0 exactly
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < D)
        *reinterpret_cast<float2*>(out + col) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
    }
  }
}

template <int DP, int S, bool kOnePass>
int launch(const float* q, const float* k, const float* v, const float* pad, float* out,
           int B, int H, int T, int D, float scale, cudaStream_t stream) {
  auto kernel = kOnePass ? attn_bf16_kernel<DP, S> : attn_kernel<DP, S>;
  const int bytes = (3 * Tile<DP>::kFloats + kRows) * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int BH = B * H;
  const dim3 grid((BH + S - 1) / S, S == 1 ? (T + kRows - 1) / kRows : 1);
  kernel<<<grid, kThreads, bytes, stream>>>(q, k, v, pad, out, BH, H, T, D, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, bool kOnePass>
int launch_bucket(const float* q, const float* k, const float* v, const float* pad, float* out,
                  int B, int H, int T, int D, float scale, cudaStream_t stream) {
  if (T <= kRows / 4)
    return launch<DP, 4, kOnePass>(q, k, v, pad, out, B, H, T, D, scale, stream);
  if (T <= kRows / 2)
    return launch<DP, 2, kOnePass>(q, k, v, pad, out, B, H, T, D, scale, stream);
  return launch<DP, 1, kOnePass>(q, k, v, pad, out, B, H, T, D, scale, stream);
}

template <bool kOnePass>
int forward(const float* q, const float* k, const float* v, const float* pad, float* out, int B,
            int H, int T, int D, float scale, void* stream) {
  if (D <= 0 || D % 4 != 0 || D > 128 || (T + kRows - 1) / kRows > 65535 ||
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || T == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch_bucket<64, kOnePass>(q, k, v, pad, out, B, H, T, D, scale, s)
                 : launch_bucket<128, kOnePass>(q, k, v, pad, out, B, H, T, D, scale, s);
}

}  // namespace

extern "C" int attn_max_d() { return 128; }

// q, k, v, out [B,H,T,D] and pad [B,T], float32 and contiguous. D must be a
// multiple of 4 and at most attn_max_d(); the wrapper pads D up to that.
extern "C" int attn_forward(const float* q, const float* k, const float* v,
                            const float* pad, float* out, int B, int H, int T,
                            int D, float scale, void* stream) {
  return forward<false>(q, k, v, pad, out, B, H, T, D, scale, stream);
}

// The one-pass bf16 form (compute_dtype="bfloat16"): as attn_forward.
extern "C" int attn_forward_bf16(const float* q, const float* k, const float* v,
                                 const float* pad, float* out, int B, int H, int T, int D,
                                 float scale, void* stream) {
  return forward<true>(q, k, v, pad, out, B, H, T, D, scale, stream);
}
