"""CRU Kalman scan, forward only (after imm_tsf_tpu/ops/cru_scan.py).

The CRU cell loop (reference lib/cru_components/CRULayer.py:74-99, one
torch.matrix_exp per step) runs T sequential steps of small [B, 2lsd,
2lsd] linear algebra. Two routes, as in the JAX package:

- `cru_scan_xla`, the default: a Python loop over T whose per-step Van
  Loan expm is `ops.expm.expm` (CUDA kernel #5 on the card, one launch a
  step);
- `cru_scan`, the fused route: the whole scan in one launch of CUDA kernel
  #6 (kernels/cru_scan.py, `csrc/cru_scan.cu`), which also returns the
  per-step prior state as residuals for the backward of the training
  slice. Opt-in with IMM_TSF_CRU_FUSED=1, read at each call
  (`cru_scan_auto`).

`cru_scan_auto(kernel=False)` runs the plain version of both routes
instead, `cru_scan_reference` (the loop with `expm_taylor12`);
chip_smoke.py holds the kernels against it.

Semantics (reference CRUCell.py:277-314 update, :357-500 predict):
    inputs  y_mean [B,T,lod], y_var [B,T,lod], valid [B,T], dts [B,T]
    params  coeff_w [lsd,K], coeff_b [K], dense_basis [4,K,lod,lod],
            trans_var [lsd] (diag Q), init_cu [lod], init_cl [lod]
    output  post_means [B,T,lsd]
"""

from __future__ import annotations

import os

import torch

from .expm import expm, expm_taylor12


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


def _scan_steps(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
                trans_var, init_cu, init_cl, max_squarings, expm_fn):
    """The scan as a loop over T. Returns the posterior mean of every step
    and the prior state (mean, cu, cl, cs) entering it, as lists."""
    B, T, lod = y_mean.shape
    lsd = 2 * lod
    bigG = _build_bigG(dense_basis).reshape(dense_basis.shape[1], -1)  # [K, n*n]
    qb = _build_qb(trans_var)
    n2 = 2 * lsd

    prior_mean = torch.zeros((B, lsd), dtype=y_mean.dtype, device=y_mean.device)
    cu = init_cu.reshape(1, lod).expand(B, lod)
    cl = init_cl.reshape(1, lod).expand(B, lod)
    cs = torch.zeros((B, lod), dtype=y_mean.dtype, device=y_mean.device)
    post_means, priors = [], []
    for t in range(T):
        priors.append((prior_mean, cu, cl, cs))
        obs, obs_var = y_mean[:, t], y_var[:, t]
        v, dt = valid[:, t, None].to(y_mean.dtype), dts[:, t, None, None]

        # -- update (CRUCell.py:277-314) --
        denom = cu + obs_var
        q_upper = cu / denom
        q_lower = cs / denom
        residual = obs - prior_mean[:, :lod]
        new_mean = prior_mean + torch.cat([q_upper * residual, q_lower * residual], dim=-1)
        covar_factor = 1 - q_upper
        ncu_u = covar_factor * cu
        ncl_u = cl - q_lower * cs
        ncs_u = covar_factor * cs
        post_mean = v * new_mean + (1 - v) * prior_mean
        post_cu = v * ncu_u + (1 - v) * cu
        post_cl = v * ncl_u + (1 - v) * cl
        post_cs = v * ncs_u + (1 - v) * cs
        post_means.append(post_mean)

        # -- continuous predict (CRUCell.py:440-500) --
        logits = post_mean @ coeff_w + coeff_b
        coeff = torch.softmax(logits, dim=-1)  # [B, K]
        Bm = ((coeff @ bigG).reshape(B, n2, n2) + qb) * dt
        exp_B = expm_fn(Bm, max_squarings)
        exp_A = exp_B[:, :lsd, :lsd]
        M2 = exp_B[:, :lsd, lsd:]
        prior_mean = torch.einsum("bij,bj->bi", exp_A, post_mean)

        eu = exp_A[:, :, :lod]
        el = exp_A[:, :, lod:]
        Cm = torch.cat([eu * post_cu[:, None, :] + el * post_cs[:, None, :],
                        eu * post_cs[:, None, :] + el * post_cl[:, None, :]], -1) + M2
        prior_covar = Cm @ exp_A.transpose(-2, -1)
        cu = torch.diagonal(prior_covar[:, :lod, :lod], dim1=-2, dim2=-1)
        cl = torch.diagonal(prior_covar[:, lod:, lod:], dim1=-2, dim2=-1)
        cs = torch.diagonal(prior_covar[:, :lod, lod:], dim1=-2, dim2=-1)
    return post_means, priors


def cru_scan_xla(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
                 trans_var, init_cu, init_cl, max_squarings: int = 7):
    """The default route: a loop over T with one expm per step (kernel #5
    on the card). -> post_means [B,T,lsd]."""
    post_means, _ = _scan_steps(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
                                trans_var, init_cu, init_cl, max_squarings, expm)
    return torch.stack(post_means, dim=1)


def cru_scan_reference(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
                       trans_var, init_cu, init_cl, max_squarings: int = 7):
    """Plain version of both routes and of the fused scan kernel (the JAX
    package's `_cru_fwd_kernel`, cru_scan_kernel.py:188-229): the same
    loop with the plain expm, returning (post_means [B,T,lsd], (pm
    [B,T,lsd], pcu, pcl, pcs [B,T,lod])), the residuals being the prior
    state entering each step."""
    post_means, priors = _scan_steps(y_mean, y_var, valid, dts, coeff_w, coeff_b,
                                     dense_basis, trans_var, init_cu, init_cl,
                                     max_squarings, expm_taylor12)
    residuals = tuple(torch.stack([p[i] for p in priors], dim=1) for i in range(4))
    return torch.stack(post_means, dim=1), residuals


def _use_fused() -> bool:
    """Opt-in only (IMM_TSF_CRU_FUSED=1), read at each call, as in the JAX
    package (ops/cru_scan.py:147-163)."""
    return os.environ.get("IMM_TSF_CRU_FUSED") == "1"


def cru_scan(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
             trans_var, init_cu, init_cl, max_squarings: int = 7):
    """The fused route, forward only: one launch of kernel #6 on the card
    (its plain version on the CPU). -> post_means [B,T,lsd]."""
    from ..kernels.cru_scan import fused_cru_scan

    return fused_cru_scan(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
                          trans_var, init_cu, init_cl, max_squarings)[0]


def cru_scan_auto(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
                  trans_var, init_cu, init_cl, max_squarings: int = 7,
                  kernel: bool = True):
    """What models/cru.py calls: the fused route under IMM_TSF_CRU_FUSED=1,
    the default route otherwise; with kernel=False, the plain version."""
    args = (y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
            trans_var, init_cu, init_cl, max_squarings)
    if not kernel:
        return cru_scan_reference(*args)[0]
    return (cru_scan if _use_fused() else cru_scan_xla)(*args)
