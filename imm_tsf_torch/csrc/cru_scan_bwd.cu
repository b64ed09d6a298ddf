// The backward of the whole CRU Kalman scan in one launch.
//
// Replaces the TPU kernel imm_tsf_tpu/ops/pallas/cru_scan_kernel.py
// (cru_scan_bwd_pallas -> _cru_bwd_kernel): the hand-derived reverse-time
// VJP of kernel #6. For each sample, for t = T-1..0, with the adjoint
// carry (gm [lsd], gcu, gcl, gcs [lod]) of the prior state entering t+1:
//
//   recompute step t from the residual prior state (m, cu, cl, cs)[t]
//     (forward's #6 residuals): update, coefficients c, Bm, E = exp(Bm)
//   B8-B5  gE = [[gE_A, gM2], [0, 0]], with P = Cm E_A^T, Cm(E, post_c*)
//          and m' = E_A post_m; gpost_c*, gpost_m += E_A^T gm
//   B4     gBm = L_exp(Bm^T)[gE]                          (frechet.cuh)
//   B3     H = gBm[:lsd, :lsd] - gBm[lsd:, lsd:]^T:
//          gc_k = dt <H, A_k>, gA_k += c_k dt H, gq += dt diag gBm[:lsd, lsd:]
//   B2/B1  softmax and coefficient net: gW += post_m gs^T, gb += gs,
//          gpost_m += W gs + g[t]
//   BU6-1  valid blend and Kalman update -> gy[t], gyv[t] and the carry
//
// It returns gA [K, lsd, lsd] (the TPU kernel's gbigG [K, 2lsd, 2lsd] is
// 245 KB at the CRU preset, and its caller only needs G11 - G22^T). gW,
// gb, gA, gq and the initial covariances' cotangents come out per sample
// and the wrapper sums them over the batch after the launch: blocks carry
// nothing between them, and no atomics keep the sums deterministic.
//
// Bound on an H100: operations. Per step the expm (2 or 5 + k products)
// and the Frechet derivative (3 (5 + k') products) of a 2lsd-square block
// dwarf the bytes (inputs, residuals and g read once, gy, gyv and the
// per-sample partials written once).
//
// Design: one sample walks the T steps backwards on a thread-block cluster
// of C CTAs (C = 1, 2 or 4, chosen by the wrapper from the batch and the
// clusters the card holds at once). Each CTA of 256 threads keeps full
// copies of eight 64 x 68 float buffers (139,264 bytes), which hold the
// expm (buffers 0-4) and, once E is used up, the Frechet derivative (all
// eight; buffer 0 gets Bm^T, buffer 1 gE), and of the A_k [K][lsd][lsd + 1]
// when they fit beside them (K <= 16 at lsd 32; device memory (L2)
// otherwise). Every product, and every assembly of a buffer (Bm, gE,
// Bm^T), is split by rows: a CTA computes 64 / C rows (in a product a
// thread a (4 / C) x 4 patch), writes them into the same buffer of every
// CTA of the cluster over distributed shared memory, and one cluster
// barrier makes them visible (expm.cuh's team interface, team.cuh's `Cluster`).
// The squaring count comes from each CTA's own copy of the matrix; the
// copies are equal, so every CTA takes the same k and meets the same
// barriers.
//
// A step is mostly shared-memory reads, not FMAs, so: the Frechet pair
// products run their three matmuls in one pass over k (frechet.cuh:
// each row of X, dX, Y, dY read once); the Van Loan assembly
// keeps up to eight of a thread's K-term sums side by side, and a warp
// takes consecutive columns (conflict-free A_k reads). The per-step
// scalar work (the Kalman update, the softmax, the covariance and mean
// adjoints, whose sums run on the four lanes of a quad) runs redundantly
// in every CTA: it is deterministic, so the copies agree. The gc dot
// products and the gA accumulation are split by basis k (k mod C), gc
// exchanged over distributed shared memory. gA accumulates in device
// memory, each CTA its own bases of its sample's partial (61 KB at K 15,
// lsd 32), a thread's eight float4 reads in flight before its writes;
// CTA 0 writes gy, gyv and the other partials. Plain float32 FMA, as
// kernels #5 and #6.

#include <cooperative_groups.h>

#include "cru_step.cuh"
#include "frechet.cuh"
#include "team.cuh"

namespace {

namespace cg = cooperative_groups;

using cru::kMaxK;
using cru::kMaxLsd;
using expm::Cluster;

constexpr int kThreads = expm::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;  // gA float4 reads a thread keeps in flight

struct Layout {  // dynamic shared memory, in floats
  int e, A, W, gW, m, cu, cl, cs, pm, pcu, pcl, pcs, den, qu, ql, r, gm, gcu, gcl, gcs, gpm,
      gpcu, gpcl, gpcs, gout, coeff, gc, gs, bias, gb, q, gq, total;
  __host__ __device__ Layout(int lsd, int K, bool a_in_smem) {
    const int lod = lsd / 2;
    e = 0;                                          // eight expm / Frechet buffers
    A = e + expm::kFrechetSmemFloats;               // A_k [K][lsd][lsd + 1], if staged
    W = A + (a_in_smem ? K * lsd * (lsd + 1) : 0);  // coefficient net weight [lsd][K]
    gW = W + lsd * K;                               // its cotangent, this sample's
    m = gW + lsd * K;                               // prior state at t
    cu = m + lsd;
    cl = cu + lod;
    cs = cl + lod;
    pm = cs + lod;                                  // posterior at t
    pcu = pm + lsd;
    pcl = pcu + lod;
    pcs = pcl + lod;
    den = pcs + lod;                                // update intermediates
    qu = den + lod;
    ql = qu + lod;
    r = ql + lod;
    gm = r + lod;                                   // adjoint carry
    gcu = gm + lsd;
    gcl = gcu + lod;
    gcs = gcl + lod;
    gpm = gcs + lod;                                // adjoint of the posterior
    gpcu = gpm + lsd;
    gpcl = gpcu + lod;
    gpcs = gpcl + lod;
    gout = gpcs + lod;                              // g[t]
    coeff = gout + lsd;
    gc = coeff + kMaxK;
    gs = gc + kMaxK;
    bias = gs + kMaxK;
    gb = bias + kMaxK;
    q = gb + kMaxK;
    gq = q + lsd;
    total = gq + lsd;
  }
};

template <int C>
__global__ void __launch_bounds__(kThreads)
cru_scan_bwd_kernel(const float* __restrict__ y, const float* __restrict__ yv,
                    const float* __restrict__ valid, const float* __restrict__ dts,
                    const float* __restrict__ W, const float* __restrict__ b,
                    const float* __restrict__ A, const float* __restrict__ q,
                    const float* __restrict__ res_m, const float* __restrict__ res_cu,
                    const float* __restrict__ res_cl, const float* __restrict__ res_cs,
                    const float* __restrict__ g, float* __restrict__ gy,
                    float* __restrict__ gyv, float* __restrict__ gW, float* __restrict__ gb,
                    float* __restrict__ gA, float* __restrict__ gq, float* __restrict__ gicu,
                    float* __restrict__ gicl, int T, int lod, int K, int max_squarings,
                    int a_in_smem) {
  using Team = Cluster<C>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[kWarps];
  const int lsd = 2 * lod, n2 = 2 * lsd;
  const Layout L(lsd, K, a_in_smem != 0);
  float* e = smem + L.e;            // buffer 0: Bm, then E, then Bm^T
  float* e1 = e + expm::kMat;       // buffer 1: gE, then gBm
  float* H = e + 2 * expm::kMat;    // buffer 2, after the Frechet derivative
  float* A_s = smem + L.A;
  float* W_s = smem + L.W;
  float* gW_s = smem + L.gW;
  float* m = smem + L.m;
  float* cu = smem + L.cu;
  float* cl = smem + L.cl;
  float* cs = smem + L.cs;
  float* pm = smem + L.pm;
  float* pcu = smem + L.pcu;
  float* pcl = smem + L.pcl;
  float* pcs = smem + L.pcs;
  float* den = smem + L.den;
  float* qu = smem + L.qu;
  float* ql = smem + L.ql;
  float* rr = smem + L.r;
  float* gm = smem + L.gm;
  float* gcu = smem + L.gcu;
  float* gcl = smem + L.gcl;
  float* gcs = smem + L.gcs;
  float* gpm = smem + L.gpm;
  float* gpcu = smem + L.gpcu;
  float* gpcl = smem + L.gpcl;
  float* gpcs = smem + L.gpcs;
  float* gout = smem + L.gout;
  float* coeff = smem + L.coeff;
  float* gc = smem + L.gc;
  float* gs = smem + L.gs;
  float* b_s = smem + L.bias;
  float* gb_s = smem + L.gb;
  float* q_s = smem + L.q;
  float* gq_s = smem + L.gq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = Team::rank();
  const bool lead = rank == 0;  // the CTA that writes gy, gyv and the partials but gA
  const long long b_idx = blockIdx.x / C;  // the cluster's sample
  const int lda = a_in_smem ? lsd + 1 : lsd;
  const float* Ak = a_in_smem ? A_s : A;
  float* gA_b = gA + b_idx * K * lsd * lsd;
  const int own_k = (K - rank + C - 1) / C;  // this CTA's bases: rank, rank + C, ...
  // gA entries 4 tid .. 4 tid + 3 of each own basis's lsd x lsd block
  // (lsd^2 / 4 <= kThreads), and where they sit in H
  const bool ga_thread = tid < lsd * lsd / 4;
  auto ga = [&](int u) { return gA_b + (rank + C * u) * lsd * lsd + 4 * tid; };
  int h_off[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) h_off[q] = ((4 * tid + q) / lsd) * expm::kLd + (4 * tid + q) % lsd;

  if (a_in_smem) {
    for (int idx = tid; idx < K * lsd * lsd; idx += kThreads) {
      const int k = idx / (lsd * lsd), r = (idx / lsd) % lsd, c = idx % lsd;
      A_s[(k * lsd + r) * lda + c] = A[idx];
    }
  }
  for (int idx = tid; idx < lsd * K; idx += kThreads) {
    W_s[idx] = W[idx];
    gW_s[idx] = 0.f;
  }
  if (ga_thread)
    for (int u = 0; u < own_k; ++u) *reinterpret_cast<float4*>(ga(u)) = make_float4(0, 0, 0, 0);
  if (tid < K) {
    b_s[tid] = b[tid];
    gb_s[tid] = 0.f;
  }
  if (tid < lsd) {
    q_s[tid] = q[tid];
    gq_s[tid] = 0.f;
    gm[tid] = 0.f;
  }
  if (tid < lod) gcu[tid] = gcl[tid] = gcs[tid] = 0.f;
  Team::sync();  // every CTA of the cluster runs before any writes another's memory

  // E_A, M2 and Cm read from E in buffer 0; the adjoint of P and of Cm
  auto EA = [&](int i, int j) { return e[i * expm::kLd + j]; };
  auto Cm = [&](int i, int j) {
    const float m2 = e[i * expm::kLd + lsd + j];
    return j < lod ? EA(i, j) * pcu[j] + EA(i, j + lod) * pcs[j] + m2
                   : EA(i, j - lod) * pcs[j - lod] + EA(i, j) * pcl[j - lod] + m2;
  };
  // gP = diag([gcu, gcl]) + gcs on the diagonal of P's upper-right block
  auto gP_diag = [&](int i) { return i < lod ? gcu[i] : gcl[i - lod]; };
  auto gCm = [&](int i, int j) {  // (gP E_A)[i, j]
    float acc = gP_diag(i) * EA(i, j);
    if (i < lod) acc += gcs[i] * EA(i + lod, j);
    return acc;
  };
  auto gEA = [&](int a, int c) {  // B7 (gP^T Cm), B6 (Cm's pieces), B5 (gm post_m^T)
    float acc = gP_diag(a) * Cm(a, c);
    if (a >= lod) acc += gcs[a - lod] * Cm(a - lod, c);
    acc += c < lod ? gCm(a, c) * pcu[c] + gCm(a, c + lod) * pcs[c]
                   : gCm(a, c - lod) * pcs[c - lod] + gCm(a, c) * pcl[c - lod];
    return acc + gm[a] * pm[c];
  };
  // this CTA's rows of a buffer, element idx of them (consecutive threads,
  // consecutive columns: the A_k reads below are free of bank conflicts)
  constexpr int kOwnRows = expm::kN / C;
  const int row_base = rank * kOwnRows;
  auto own_row = [&](int idx) { return row_base + idx / expm::kN; };
  // this CTA's rows of Bm dt (of Bm^T dt when transposed) into buffer 0 of
  // every CTA: cru::van_loan's sums, up to kSide of a thread's side by side
  auto van_loan_rows = [&](bool transposed, float dt) {
    constexpr int kPer = kOwnRows * expm::kN / kThreads;  // elements a thread
    constexpr int kSide = kPer < 8 ? kPer : 8;
    for (int m0 = 0; m0 < kPer; m0 += kSide) {
      int off[kSide];  // A_k[off] is the element's term of basis k, or -1: no sum
      float acc[kSide];
#pragma unroll
      for (int m = 0; m < kSide; ++m) {
        const int idx = tid + (m0 + m) * kThreads;
        int r = own_row(idx), c = idx % expm::kN;
        if (transposed) {
          const int x = r;
          r = c;
          c = x;
        }
        acc[m] = 0.f;
        off[m] = r < lsd && c < lsd                          ? r * lda + c
                 : r >= lsd && c >= lsd && r < n2 && c < n2 ? (c - lsd) * lda + r - lsd
                                                            : -1;
      }
      for (int k = 0; k < K; ++k) {
        const float ck = coeff[k];
        const float* Akk = Ak + k * lsd * lda;
#pragma unroll
        for (int m = 0; m < kSide; ++m)
          if (off[m] >= 0) acc[m] = fmaf(ck, Akk[off[m]], acc[m]);
      }
#pragma unroll
      for (int m = 0; m < kSide; ++m) {
        const int idx = tid + (m0 + m) * kThreads;
        const int row = own_row(idx), col = idx % expm::kN;
        const int r = transposed ? col : row, c = transposed ? row : col;
        const float v = off[m] >= 0 ? (r < lsd ? acc[m] : -acc[m])
                        : (r < lsd && c - lsd == r) ? q_s[r] : 0.f;
        Team::put(e + row * expm::kLd + col, v * dt);
      }
    }
  };

  for (int t = T - 1; t >= 0; --t) {
    const long long bt = b_idx * T + t;
    const float v = valid[bt], dt = dts[bt];

    // recompute step t from its residual prior state (every CTA)
    if (tid < lsd) {
      m[tid] = res_m[bt * lsd + tid];
      gout[tid] = g[bt * lsd + tid];
    }
    if (tid < lod) {
      cu[tid] = res_cu[bt * lod + tid];
      cl[tid] = res_cl[bt * lod + tid];
      cs[tid] = res_cs[bt * lod + tid];
    }
    __syncthreads();
    if (tid < lod) {
      const cru::Update u = cru::update(m[tid], m[lod + tid], cu[tid], cl[tid], cs[tid],
                                        y[bt * lod + tid], yv[bt * lod + tid], v);
      pm[tid] = u.pm_u;
      pm[lod + tid] = u.pm_l;
      pcu[tid] = u.pcu;
      pcl[tid] = u.pcl;
      pcs[tid] = u.pcs;
      den[tid] = u.denom;
      qu[tid] = u.q_upper;
      ql[tid] = u.q_lower;
      rr[tid] = u.r;
    }
    __syncthreads();
    if (tid < 32) cru::coefficients(pm, W_s, b_s, coeff, lsd, K);
    __syncthreads();
    van_loan_rows(false, dt);
    Team::sync();
    expm::expm_inplace<Team>(e, red, max_squarings);

    // B8-B5: the cotangent of E into buffer 1; gpost_c* and E_A^T gm
    // (rows rank, rank + C, ...: only gE's first lsd rows are nonzero, and
    // every CTA takes its share of them)
    for (int idx = tid; idx < kOwnRows * expm::kN; idx += kThreads) {
      const int r = rank + C * (idx / expm::kN), c = idx % expm::kN;
      Team::put(e1 + r * expm::kLd + c,
                (r < lsd && c < n2) ? (c < lsd ? gEA(r, c) : gCm(r, c - lsd)) : 0.f);
    }
    // gpost_cu, gpost_cs, gpost_cl (o < 3 lod) and E_A^T gm (the rest), each
    // by the four lanes of a quad over every fourth term (every CTA)
    for (int o0 = 0; o0 < 3 * lod + lsd; o0 += kThreads / 4) {
      const int o = o0 + tid / 4, part = tid % 4;
      float acc = 0.f;
      if (o < 3 * lod) {
        const int which = o / lod, j = o % lod;  // 0: gpost_cu, 1: gpost_cs, 2: gpost_cl
        for (int i = part; i < lsd; i += 4) {
          if (which == 0) acc += gCm(i, j) * EA(i, j);
          else if (which == 1) acc += gCm(i, j) * EA(i, j + lod) + gCm(i, j + lod) * EA(i, j);
          else acc += gCm(i, j + lod) * EA(i, j + lod);
        }
      } else if (o < 3 * lod + lsd) {
        for (int a = part; a < lsd; a += 4) acc = fmaf(EA(a, o - 3 * lod), gm[a], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0 && o < 3 * lod) (o < lod ? gpcu : o < 2 * lod ? gpcs : gpcl)[o % lod] = acc;
      else if (part == 0 && o < 3 * lod + lsd) gpm[o - 3 * lod] = acc;
    }
    Team::sync();  // E is used up in every CTA

    // B4: gBm = L_exp(Bm^T)[gE]
    van_loan_rows(true, dt);
    Team::sync();
    expm::frechet_inplace<Team>(e, red, max_squarings);

    // B3: H (each CTA its own copy), gq, then gc and gA over this CTA's bases
    for (int i = warp; i < lsd; i += kWarps)
      if (lane < lsd)
        H[i * expm::kLd + lane] =
            e1[i * expm::kLd + lane] - e1[(lsd + lane) * expm::kLd + lsd + i];
    if (tid < lsd) gq_s[tid] += e1[tid * expm::kLd + lsd + tid] * dt;
    __syncthreads();
    for (int k = rank + C * warp; k < K; k += C * kWarps) {
      float acc = 0.f;
      if (lane < lsd)
        for (int i = 0; i < lsd; ++i)
          acc = fmaf(H[i * expm::kLd + lane], Ak[(k * lsd + i) * lda + lane], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane < C) *cg::this_cluster().map_shared_rank(gc + k, static_cast<unsigned>(lane)) =
          acc * dt;
    }
    // gA: this thread's float4 of each of this CTA's bases, kBatch reads in
    // flight before the writes
    if (ga_thread) {
      const float h0 = H[h_off[0]], h1 = H[h_off[1]], h2 = H[h_off[2]], h3 = H[h_off[3]];
      for (int u0 = 0; u0 < own_k; u0 += kBatch) {
        float4 acc[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (u0 + u < own_k) acc[u] = *reinterpret_cast<const float4*>(ga(u0 + u));
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u0 + u >= own_k) continue;
          const float w = coeff[rank + C * (u0 + u)] * dt;
          acc[u].x += w * h0;
          acc[u].y += w * h1;
          acc[u].z += w * h2;
          acc[u].w += w * h3;
          *reinterpret_cast<float4*>(ga(u0 + u)) = acc[u];
        }
      }
    }
    Team::sync();  // gc complete in every CTA; gBm and H read before the next step writes

    // B2/B1: softmax, then the coefficient net (every CTA)
    if (tid < 32) {
      const float c = tid < K ? coeff[tid] : 0.f, gcv = tid < K ? gc[tid] : 0.f;
      float dot = gcv * c;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (tid < K) {
        const float gsv = c * (gcv - dot);
        gs[tid] = gsv;
        gb_s[tid] += gsv;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < lsd * K; idx += kThreads)
      gW_s[idx] += pm[idx / K] * gs[idx % K];
    if (tid < lsd) {
      float acc = 0.f;
      for (int k = 0; k < K; ++k) acc = fmaf(gs[k], W_s[tid * K + k], acc);
      gpm[tid] += acc + gout[tid];
    }
    __syncthreads();

    // BU6-BU1: valid blend and Kalman update, each latent pair i < lod
    if (tid < lod) {
      const int i = tid;
      const float c_u = cu[i], c_s = cs[i], q_up = qu[i], q_lo = ql[i], d = den[i];
      const float gnew_u = v * gpm[i], gnew_l = v * gpm[lod + i];
      float gm_u = (1.f - v) * gpm[i] + gnew_u, gm_l = (1.f - v) * gpm[lod + i] + gnew_l;
      const float gncu = v * gpcu[i], gncl = v * gpcl[i], gncs = v * gpcs[i];
      float gcu_p = (1.f - v) * gpcu[i], gcl_p = (1.f - v) * gpcl[i];
      float gcs_p = (1.f - v) * gpcs[i];
      float gqu = -(gncu * c_u) - (gncs * c_s), gql = -(gncl * c_s);
      gcu_p += gncu * (1.f - q_up);
      gcl_p += gncl;
      gcs_p += gncs * (1.f - q_up) - gncl * q_lo;
      gqu += gnew_u * rr[i];
      gql += gnew_l * rr[i];
      const float gr = gnew_u * q_up + gnew_l * q_lo;
      gm_u -= gr;
      const float gden = -(gqu * c_u + gql * c_s) / (d * d);
      gcu_p += gqu / d + gden;
      gcs_p += gql / d;
      if (lead) {
        gy[bt * lod + i] = gr;
        gyv[bt * lod + i] = gden;
      }
      gm[i] = gm_u;
      gm[lod + i] = gm_l;
      gcu[i] = gcu_p;
      gcl[i] = gcl_p;
      gcs[i] = gcs_p;
    }
    __syncthreads();
  }

  if (lead) {
    for (int idx = tid; idx < lsd * K; idx += kThreads) gW[b_idx * lsd * K + idx] = gW_s[idx];
    if (tid < K) gb[b_idx * K + tid] = gb_s[tid];
    if (tid < lsd) gq[b_idx * lsd + tid] = gq_s[tid];
    if (tid < lod) {
      gicu[b_idx * lod + tid] = gcu[tid];  // init_cu, init_cl broadcast over the batch
      gicl[b_idx * lod + tid] = gcl[tid];
    }
  }
  Team::sync();  // no CTA exits while a peer may still write its shared memory
}

// the dynamic shared memory of a launch, and whether the A_k fit in it
int smem_bytes(int lod, int K, bool* a_in_smem) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int lsd = 2 * lod;
  const int static_bytes = kWarps * static_cast<int>(sizeof(float));
  *a_in_smem = Layout(lsd, K, true).total * static_cast<int>(sizeof(float)) + static_bytes <=
               optin;
  return Layout(lsd, K, *a_in_smem).total * static_cast<int>(sizeof(float));
}

}  // namespace

extern "C" int cru_scan_bwd_max_lod() { return kMaxLsd / 2; }
extern "C" int cru_scan_bwd_max_k() { return kMaxK; }

// *out = how many clusters of `cluster` CTAs (1, 2 or 4) the card holds at
// once at this lod and K (one CTA a cluster rank; cudaOccupancyMaxActiveClusters)
extern "C" int cru_scan_bwd_active_clusters(int lod, int K, int cluster, int* out) {
  if (lod <= 0 || 2 * lod > kMaxLsd || K <= 0 || K > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  bool a_in_smem = false;
  const int bytes = smem_bytes(lod, K, &a_in_smem);
  if (bytes < 0) return -bytes;
  switch (cluster) {
    case 1: return expm::active_clusters(cru_scan_bwd_kernel<1>, 1, kThreads, bytes, out);
    case 2: return expm::active_clusters(cru_scan_bwd_kernel<2>, 2, kThreads, bytes, out);
    case 4: return expm::active_clusters(cru_scan_bwd_kernel<4>, 4, kThreads, bytes, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// y, yv [B,T,lod]; valid, dts [B,T]; W [2lod,K]; b [K]; A [K,2lod,2lod];
// q [2lod]; res_m [B,T,2lod]; res_cu, res_cl, res_cs [B,T,lod]; g [B,T,2lod]
// -> gy, gyv [B,T,lod]; per sample gW [B,2lod,K], gb [B,K],
// gA [B,K,2lod,2lod], gq [B,2lod], gicu, gicl [B,lod]; float32, contiguous.
// One sample a cluster of `cluster` CTAs (1, 2 or 4).
extern "C" int cru_scan_backward(const float* y, const float* yv, const float* valid,
                                 const float* dts, const float* W, const float* b,
                                 const float* A, const float* q, const float* res_m,
                                 const float* res_cu, const float* res_cl, const float* res_cs,
                                 const float* g, float* gy, float* gyv, float* gW, float* gb,
                                 float* gA, float* gq, float* gicu, float* gicl, int B, int T,
                                 int lod, int K, int max_squarings, int cluster, void* stream) {
  if (B < 0 || T < 0 || lod <= 0 || 2 * lod > kMaxLsd || K <= 0 || K > kMaxK ||
      max_squarings < 0 || (cluster != 1 && cluster != 2 && cluster != 4) ||
      static_cast<long long>(B) * cluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  bool a_in_smem = false;
  const int bytes = smem_bytes(lod, K, &a_in_smem);
  if (bytes < 0) return -bytes;
  auto s = static_cast<cudaStream_t>(stream);
  const int a_flag = a_in_smem ? 1 : 0;
#define CRU_BWD_ARGS y, yv, valid, dts, W, b, A, q, res_m, res_cu, res_cl, res_cs, g, gy, gyv, \
                     gW, gb, gA, gq, gicu, gicl, T, lod, K, max_squarings, a_flag
  switch (cluster) {
    case 1:
      return expm::launch_clusters(cru_scan_bwd_kernel<1>, 1, B, kThreads, bytes, s,
                                   CRU_BWD_ARGS);
    case 2:
      return expm::launch_clusters(cru_scan_bwd_kernel<2>, 2, 2 * B, kThreads, bytes, s,
                                   CRU_BWD_ARGS);
    default:
      return expm::launch_clusters(cru_scan_bwd_kernel<4>, 4, 4 * B, kThreads, bytes, s,
                                   CRU_BWD_ARGS);
  }
#undef CRU_BWD_ARGS
}
