"""CRU Kalman scan, forward and backward (after imm_tsf_tpu/ops/cru_scan.py).

The CRU cell loop (reference lib/cru_components/CRULayer.py:74-99, one
torch.matrix_exp per step) runs T sequential steps of small [B, 2lsd,
2lsd] linear algebra. Two routes, as in the JAX package, both
differentiable:

- `cru_scan_xla`, the default: a Python loop over T whose per-step Van
  Loan expm is `ops.expm.expm`, so autograd runs the loop backwards and
  each step takes kernel #5 forward and kernel #4 backward on the card
  (one launch each a step), as `jax.grad` through the JAX package's
  lax.scan and its expm custom VJP does;
- `cru_scan`, the fused route: a `torch.autograd.Function` whose forward
  is the whole scan in one launch of kernel #6 (kernels/cru_scan.py,
  `csrc/cru_scan.cu`), which also returns the per-step prior state as
  residuals, and whose backward is one launch of kernel #7
  (`csrc/cru_scan_bwd.cu`) on those residuals, then the pullback to
  `dense_basis` and `trans_var` (after `_cru_scan_fwd` / `_cru_scan_bwd`,
  :194-232). Opt-in with IMM_TSF_CRU_FUSED=1, read once per call
  (`cru_scan_auto`); the backward never recomputes the forward and never
  switches routes.

`cru_scan_auto(kernel=False)` runs the plain version of both routes
instead, `cru_scan_reference` (the loop with the plain expm forward and
backward, `expm_plain`), under autograd. `cru_scan_bwd_reference` is the
plain version of kernel #7; chip_smoke.py holds the kernels against them.

Under compute_dtype="bfloat16" (layers/bf16_products) each route follows
its own JAX route: the default route's products (`cru_scan_xla`, which
names no precision) take one-pass bf16 operands, while the fused route's
Pallas kernels pin every product to HIGHEST (cru_scan_kernel.py:47-66),
so `_FusedScan`, kernel #7's plain version and the plain route under
IMM_TSF_CRU_FUSED=1 run under `full_precision()`. The expm is HIGHEST on
both routes (ops/expm.py).

Semantics (reference CRUCell.py:277-314 update, :357-500 predict):
    inputs  y_mean [B,T,lod], y_var [B,T,lod], valid [B,T], dts [B,T]
    params  coeff_w [lsd,K], coeff_b [K], dense_basis [4,K,lod,lod],
            trans_var [lsd] (diag Q), init_cu [lod], init_cl [lod]
    output  post_means [B,T,lsd]
"""

from __future__ import annotations

import contextlib
import os

import torch

from ..layers.bf16_products import full_precision
from .expm import expm, expm_frechet_taylor12, expm_plain, expm_taylor12


def _build_A(dense_basis: torch.Tensor) -> torch.Tensor:
    """[4,K,lod,lod] block bases -> A [K, lsd, lsd] = [[t11, t12], [t21, t22]]."""
    t11, t12, t21, t22 = dense_basis
    return torch.cat([torch.cat([t11, t12], -1), torch.cat([t21, t22], -1)], -2)


def _build_bigG(dense_basis: torch.Tensor) -> torch.Tensor:
    """[4,K,lod,lod] block bases -> G [K, 2*lsd, 2*lsd] with
    G_k = [[A_k, 0], [0, -A_k^T]], so Bm = (sum_k c_k G_k + QB) * dt is a
    single contraction per step (the Van Loan block is LINEAR in the
    softmax coefficients). Computed once per forward, outside the scan."""
    A = _build_A(dense_basis)  # [K, lsd, lsd]
    Z = torch.zeros_like(A)
    At = -A.transpose(-1, -2)
    return torch.cat([torch.cat([A, Z], -1), torch.cat([Z, At], -1)], -2)


def _build_qb(trans_var: torch.Tensor) -> torch.Tensor:
    """QB = [[0, diag(q)], [0, 0]] [2lsd, 2lsd]."""
    lsd = trans_var.shape[-1]
    Q = torch.diag(trans_var.reshape(lsd))
    Z = torch.zeros_like(Q)
    return torch.cat([torch.cat([Z, Q], -1), torch.cat([Z, Z], -1)], -2)


def _update(m, cu, cl, cs, obs, obs_var, v):
    """Kalman update and valid blend (CRUCell.py:277-314) -> the posterior
    (mean, cu, cl, cs) and the intermediates (denom, q_upper, q_lower,
    residual) the backward reuses."""
    lod = cu.shape[-1]
    denom = cu + obs_var
    q_upper = cu / denom
    q_lower = cs / denom
    residual = obs - m[:, :lod]
    new_mean = m + torch.cat([q_upper * residual, q_lower * residual], dim=-1)
    covar_factor = 1 - q_upper
    ncu_u = covar_factor * cu
    ncl_u = cl - q_lower * cs
    ncs_u = covar_factor * cs
    post = (v * new_mean + (1 - v) * m, v * ncu_u + (1 - v) * cu,
            v * ncl_u + (1 - v) * cl, v * ncs_u + (1 - v) * cs)
    return post, (denom, q_upper, q_lower, residual)


def _predict(post_mean, post_cu, post_cl, post_cs, coeff_w, coeff_b, bigG, qb, dt,
             max_squarings, expm_fn):
    """Continuous predict (CRUCell.py:440-500): coefficients, Van Loan
    block, its expm, the next prior mean and covariance diagonals.
    Returns (coeff, Bm, exp_A, M2, Cm, (mean, cu, cl, cs))."""
    B, lsd = post_mean.shape
    lod, n2 = lsd // 2, 2 * lsd
    logits = post_mean @ coeff_w + coeff_b
    coeff = torch.softmax(logits, dim=-1)  # [B, K]
    Bm = ((coeff @ bigG).reshape(B, n2, n2) + qb) * dt[:, :, None]
    exp_B = expm_fn(Bm, max_squarings)
    exp_A = exp_B[:, :lsd, :lsd]
    M2 = exp_B[:, :lsd, lsd:]
    eu = exp_A[:, :, :lod]
    el = exp_A[:, :, lod:]
    Cm = torch.cat([eu * post_cu[:, None, :] + el * post_cs[:, None, :],
                    eu * post_cs[:, None, :] + el * post_cl[:, None, :]], -1) + M2
    prior_covar = Cm @ exp_A.transpose(-2, -1)
    nxt = (torch.einsum("bij,bj->bi", exp_A, post_mean),
           torch.diagonal(prior_covar[:, :lod, :lod], dim1=-2, dim2=-1),
           torch.diagonal(prior_covar[:, lod:, lod:], dim1=-2, dim2=-1),
           torch.diagonal(prior_covar[:, :lod, lod:], dim1=-2, dim2=-1))
    return coeff, Bm, exp_A, M2, Cm, nxt


def _scan_steps(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
                trans_var, init_cu, init_cl, max_squarings, expm_fn):
    """The scan as a loop over T. Returns the posterior mean of every step
    and the prior state (mean, cu, cl, cs) entering it, as lists."""
    B, T, lod = y_mean.shape
    lsd = 2 * lod
    bigG = _build_bigG(dense_basis).reshape(dense_basis.shape[1], -1)  # [K, n*n]
    qb = _build_qb(trans_var)

    prior = (torch.zeros((B, lsd), dtype=y_mean.dtype, device=y_mean.device),
             init_cu.reshape(1, lod).expand(B, lod), init_cl.reshape(1, lod).expand(B, lod),
             torch.zeros((B, lod), dtype=y_mean.dtype, device=y_mean.device))
    post_means, priors = [], []
    for t in range(T):
        priors.append(prior)
        v, dt = valid[:, t, None].to(y_mean.dtype), dts[:, t, None]
        post, _ = _update(*prior, y_mean[:, t], y_var[:, t], v)
        post_means.append(post[0])
        prior = _predict(*post, coeff_w, coeff_b, bigG, qb, dt, max_squarings, expm_fn)[-1]
    return post_means, priors


def cru_scan_xla(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
                 trans_var, init_cu, init_cl, max_squarings: int = 7):
    """The default route: a loop over T with one expm per step (kernel #5
    forward and #4 backward on the card). -> post_means [B,T,lsd]."""
    post_means, _ = _scan_steps(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
                                trans_var, init_cu, init_cl, max_squarings, expm)
    return torch.stack(post_means, dim=1)


def cru_scan_reference(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
                       trans_var, init_cu, init_cl, max_squarings: int = 7):
    """Plain version of both routes and of the fused scan kernel (the JAX
    package's `_cru_fwd_kernel`, cru_scan_kernel.py:188-229): the same
    loop with the plain expm, returning (post_means [B,T,lsd], (pm
    [B,T,lsd], pcu, pcl, pcs [B,T,lod])), the residuals being the prior
    state entering each step. Differentiable: the plain expm's backward
    is the plain Frechet adjoint."""
    post_means, priors = _scan_steps(y_mean, y_var, valid, dts, coeff_w, coeff_b,
                                     dense_basis, trans_var, init_cu, init_cl,
                                     max_squarings, expm_plain)
    residuals = tuple(torch.stack([p[i] for p in priors], dim=1) for i in range(4))
    return torch.stack(post_means, dim=1), residuals


@torch.no_grad()
@full_precision()
def cru_scan_bwd_reference(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
                           trans_var, init_cu, init_cl, residuals, g,
                           max_squarings: int = 7):
    """Plain version of kernel #7: a transcription of the TPU kernel's
    reverse-time loop (`_cru_bwd_kernel`, cru_scan_kernel.py:253-384).
    Each step is recomputed from its residual prior state, then the
    adjoint runs back through the covariance propagation, the expm (the
    Frechet derivative of Bm^T, `expm_frechet_taylor12`), the
    coefficient net and the update. g [B,T,lsd] is the cotangent of the
    post-means. Returns (gy, gyv [B,T,lod], gW [lsd,K], gb [K],
    gA [K,lsd,lsd], gq [lsd], gicu, gicl [lod]); gA is the cotangent of
    `_build_A(dense_basis)`, G11 - G22^T of the TPU kernel's gbigG."""
    pm_all, pcu_all, pcl_all, pcs_all = residuals
    B, T, lod = y_mean.shape
    lsd, K = 2 * lod, coeff_w.shape[1]
    n2 = 2 * lsd
    A = _build_A(dense_basis)
    bigG = _build_bigG(dense_basis).reshape(K, -1)
    qb = _build_qb(trans_var)
    shift = torch.diag(torch.ones(lod, dtype=y_mean.dtype, device=y_mean.device), lod)
    zeros = lambda *s: y_mean.new_zeros(s)
    gm, gcu, gcl, gcs = zeros(B, lsd), zeros(B, lod), zeros(B, lod), zeros(B, lod)
    gW, gb, gA, gq = zeros(lsd, K), zeros(K), zeros(K, lsd, lsd), zeros(lsd)
    gy, gyv = torch.empty_like(y_mean), torch.empty_like(y_var)
    for t in reversed(range(T)):
        cu, cs = pcu_all[:, t], pcs_all[:, t]
        v, dt = valid[:, t, None].to(y_mean.dtype), dts[:, t, None]
        post, (denom, qu, ql, r) = _update(pm_all[:, t], cu, pcl_all[:, t], cs,
                                           y_mean[:, t], y_var[:, t], v)
        post_m, post_cu, post_cl, post_cs = post
        coeff, Bm, EA, _, Cm, _ = _predict(*post, coeff_w, coeff_b, bigG, qb, dt,
                                           max_squarings, expm_taylor12)

        # (B8) diag cotangents -> gP; (B7) P = Cm EA^T
        gP = (torch.diag_embed(torch.cat([gcu, gcl], -1))
              + shift * torch.cat([gcs, torch.zeros_like(gcs)], -1)[:, :, None])
        gCm = gP @ EA
        gEA = gP.transpose(-1, -2) @ Cm
        # (B6) Cm's pieces
        gCm1, gCm2 = gCm[:, :, :lod], gCm[:, :, lod:]
        eu, el = EA[:, :, :lod], EA[:, :, lod:]
        gpcu = (gCm1 * eu).sum(-2)
        gpcs = (gCm1 * el).sum(-2) + (gCm2 * eu).sum(-2)
        gpcl = (gCm2 * el).sum(-2)
        gEA = gEA + torch.cat([gCm1 * post_cu[:, None, :] + gCm2 * post_cs[:, None, :],
                               gCm1 * post_cs[:, None, :] + gCm2 * post_cl[:, None, :]], -1)
        # (B5) m' = EA post_m
        gEA = gEA + gm[:, :, None] * post_m[:, None, :]
        gpost_m = torch.einsum("bij,bi->bj", EA, gm)
        # (B4) the expm's adjoint
        gE = torch.cat([torch.cat([gEA, gCm], -1), zeros(B, lsd, n2)], -2)
        gBm = expm_frechet_taylor12(Bm.transpose(-1, -2), gE, max_squarings)
        # (B3) Bm = (c . bigG + qb) dt
        H = gBm[:, :lsd, :lsd] - gBm[:, lsd:, lsd:].transpose(-1, -2)
        gc = torch.einsum("bij,kij->bk", H, A) * dt
        gA += torch.einsum("bk,bij->kij", coeff * dt, H)
        gq += (torch.diagonal(gBm[:, :lsd, lsd:], dim1=-2, dim2=-1) * dt).sum(0)
        # (B2/B1) softmax and coefficient net
        gs = coeff * (gc - (gc * coeff).sum(-1, keepdim=True))
        gW += post_m.transpose(0, 1) @ gs
        gb += gs.sum(0)
        gpost_m = gpost_m + gs @ coeff_w.transpose(0, 1) + g[:, t]
        # (BU6) valid blend
        gnew_mean = v * gpost_m
        gm_prior = (1 - v) * gpost_m + gnew_mean
        gncu_u, gncl_u, gncs_u = v * gpcu, v * gpcl, v * gpcs
        gcu_prior = (1 - v) * gpcu + gncu_u * (1 - qu)
        gcl_prior = (1 - v) * gpcl + gncl_u
        gcs_prior = (1 - v) * gpcs + gncs_u * (1 - qu) - gncl_u * ql
        # (BU5-BU1) covariance update, new mean, residual, gains
        gqu = -(gncu_u * cu) - (gncs_u * cs) + gnew_mean[:, :lod] * r
        gql = -(gncl_u * cs) + gnew_mean[:, lod:] * r
        gr = gnew_mean[:, :lod] * qu + gnew_mean[:, lod:] * ql
        gm_prior = gm_prior - torch.cat([gr, torch.zeros_like(gr)], -1)
        gdenom = -(gqu * cu + gql * cs) / (denom * denom)
        gy[:, t], gyv[:, t] = gr, gdenom
        gm = gm_prior
        gcu, gcl, gcs = gcu_prior + gqu / denom + gdenom, gcl_prior, gcs_prior + gql / denom
    # init_cu, init_cl broadcast over the batch: their cotangents sum it
    return gy, gyv, gW, gb, gA, gq, gcu.sum(0), gcl.sum(0)


class _FusedScan(torch.autograd.Function):
    """The fused route: kernel #6 forward (its plain version on the CPU),
    kernel #7 backward on #6's residuals (its plain version on the CPU).
    valid and dts are data: no cotangents."""

    @staticmethod
    def forward(ctx, y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis, trans_var,
                init_cu, init_cl, max_squarings):
        from ..kernels.cru_scan import fused_cru_scan

        with full_precision():
            out, residuals = fused_cru_scan(y_mean, y_var, valid, dts, coeff_w, coeff_b,
                                            dense_basis, trans_var, init_cu, init_cl,
                                            max_squarings)
        ctx.save_for_backward(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
                              trans_var, init_cu, init_cl, *residuals)
        ctx.max_squarings = max_squarings
        return out

    @staticmethod
    def backward(ctx, g):
        from ..kernels.cru_scan import fused_cru_scan_backward

        saved = ctx.saved_tensors
        with full_precision():
            gy, gyv, gW, gb, gA, gq, gicu, gicl = fused_cru_scan_backward(
                *saved[:10], saved[10:], g, ctx.max_squarings)
        # _build_A is a block placement: its pullback is block extraction
        lod = gicu.shape[0]
        g_basis = torch.stack([gA[:, :lod, :lod], gA[:, :lod, lod:],
                               gA[:, lod:, :lod], gA[:, lod:, lod:]])
        return gy, gyv, None, None, gW, gb, g_basis, gq, gicu, gicl, None


def _use_fused() -> bool:
    """Opt-in only (IMM_TSF_CRU_FUSED=1), as in the JAX package
    (ops/cru_scan.py:147-163)."""
    return os.environ.get("IMM_TSF_CRU_FUSED") == "1"


def cru_scan(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
             trans_var, init_cu, init_cl, max_squarings: int = 7):
    """The fused route: kernel #6 forward and #7 backward on the card
    (their plain versions on the CPU). -> post_means [B,T,lsd]."""
    return _FusedScan.apply(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
                            trans_var, init_cu, init_cl, max_squarings)


def cru_scan_auto(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
                  trans_var, init_cu, init_cl, max_squarings: int = 7,
                  kernel: bool = True):
    """What models/cru.py calls: the fused route under IMM_TSF_CRU_FUSED=1,
    the default route otherwise (the variable is read once, here); with
    kernel=False, the plain version, in the precision of the route it
    stands for (full float32 for the fused one)."""
    args = (y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
            trans_var, init_cu, init_cl, max_squarings)
    fused = _use_fused()
    if not kernel:
        with full_precision() if fused else contextlib.nullcontext():
            return cru_scan_reference(*args)[0]
    return (cru_scan if fused else cru_scan_xla)(*args)
