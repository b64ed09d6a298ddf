"""The served-path kernels as `torch.library` custom ops (namespace `imm_tsf`).

Each forward kernel is one operator with three implementations:

- a fake one (shapes and dtypes only), which `torch.export`, FakeTensor
  and meta tensors run: it builds no library, reads no data pointer and
  touches no launch counter;
- a CPU one, the kernel's plain version;
- a CUDA one, the kernel's ctypes launch (its checks, alignment copies and
  launch counter) in its wrapper module.

Every caller reaches a kernel through its op: the wrappers of
`kernels/recavg.py`, `ffn.py`, `attn.py`, `expm.py` and `cru_scan.py`,
the autograd Functions around them (whose backward is unchanged), and a
program that `torch.export` recorded (export.py). So an exported program
launches the hand-written kernel on the card, and one op is the only
route. Importing this module registers the ops; loading an exported
artifact needs it imported first. It imports the kernel modules only
when an op runs, so that they can import it.

| op | kernel |
| --- | --- |
| `recency_weighted_average` | #1 `csrc/recavg.cu` |
| `fused_encoder_ffn` | #2 `csrc/ffn.cu`, eval form, or the training form with `with_residuals` |
| `fused_causal_attention` | #3 `csrc/attn.cu`, forward |
| `batched_expm` | #5 `csrc/expm.cu` |
| `fused_cru_scan` | #6 `csrc/cru_scan.cu`: post-means and the four residuals |

#4 and #7 (backward kernels) stay outside the ops: autograd calls them,
and no exported forward does. The ops of #1-#3 take `one_pass`, their
one-pass bf16 forms (compute_dtype="bfloat16", layers/bf16_products:
`recavg_forward_bf16`, `ffn_forward_bf16`, `attn_forward_bf16`): the
argument is recorded in an exported program, so an artifact exported
under that precision launches those forms (`export.op_counts` names them).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor


def check_device(name: str, t: Tensor) -> None:
    """Raise unless `t` lies on the CPU (the plain version) or a CUDA card
    (the kernel): the wrappers' rule. A meta tensor would otherwise take
    the fake implementation and return no values. Under torch.export the
    fake tensors carry the traced device, so they pass."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


# ---------------------------------------------------------------- #1


@torch.library.custom_op("imm_tsf::recency_weighted_average", mutates_args=(),
                         device_types="cpu")
def recency_weighted_average(tau: Tensor, t_hat: Tensor, V: Tensor, mask: Tensor,
                             sigma: Tensor, one_pass: bool = False) -> Tensor:
    """[B,N] x [B,T] x [B,N,d] x [B,N] x 0-d sigma -> E [B,T,d]. `one_pass`:
    the one-pass bf16 form, w and V rounded to bf16 for the weighted sum."""
    from .recavg import recavg_reference

    return recavg_reference(tau, t_hat, V, mask, sigma, one_pass=one_pass)


@recency_weighted_average.register_kernel("cuda")
def _(tau, t_hat, V, mask, sigma, one_pass=False):
    from .recavg import _launch

    return _launch(tau, t_hat, V, mask, sigma, one_pass=one_pass)


@recency_weighted_average.register_fake
def _(tau, t_hat, V, mask, sigma, one_pass=False):
    return V.new_empty((V.shape[0], t_hat.shape[1], V.shape[2]))


# ---------------------------------------------------------------- #2


@torch.library.custom_op("imm_tsf::fused_encoder_ffn", mutates_args=(), device_types="cpu")
def fused_encoder_ffn(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
                      gamma: Tensor, beta: Tensor, salts: Optional[Tensor], keep_prob: float,
                      act: str, apply_dropout: bool, with_residuals: bool,
                      one_pass: bool = False,
                      row_base: int = 0) -> tuple[Tensor, Tensor, Tensor]:
    """-> (out [M, D], a1 [M, F], r [M, D]); a1 and r are empty [0] in the
    eval form (`with_residuals` False). salts: the integer [2, 2] salts, or
    None without dropout. `one_pass`: the one-pass bf16 form (float32
    weights), x, W1, h and W2 rounded to bf16 at the two products.
    `row_base`: x's first row in the global batch of a data mesh (the
    masks' rows); last and defaulted, so programs exported before it was
    added load and replay unchanged."""
    from .ffn import ffn_forward_reference

    if with_residuals:
        out, a1, r = ffn_forward_reference(x, w1, b1, w2, b2, gamma, beta, salts, keep_prob,
                                           act, apply_dropout, with_residuals=True,
                                           one_pass=one_pass, row_base=row_base)
        return out, a1, r
    out = ffn_forward_reference(x, w1, b1, w2, b2, gamma, beta, salts, keep_prob, act,
                                apply_dropout, one_pass=one_pass, row_base=row_base)
    return out, _no_residual(x), _no_residual(x)


@fused_encoder_ffn.register_kernel("cuda")
def _(x, w1, b1, w2, b2, gamma, beta, salts, keep_prob, act, apply_dropout, with_residuals,
      one_pass=False, row_base=0):
    from .ffn import _launch

    if with_residuals:
        return _launch(x, w1, b1, w2, b2, gamma, beta, salts, keep_prob, act, apply_dropout,
                       True, one_pass=one_pass, row_base=row_base)
    out = _launch(x, w1, b1, w2, b2, gamma, beta, salts, keep_prob, act, apply_dropout, False,
                  one_pass=one_pass, row_base=row_base)
    return out, _no_residual(x), _no_residual(x)


@fused_encoder_ffn.register_fake
def _(x, w1, b1, w2, b2, gamma, beta, salts, keep_prob, act, apply_dropout, with_residuals,
      one_pass=False, row_base=0):
    out = torch.empty_like(x)
    if not with_residuals:
        return out, _no_residual(x), _no_residual(x)
    ct = torch.promote_types(x.dtype, torch.float32)
    M, Fdim = x.shape[0], w1.shape[1]
    return out, x.new_empty((M, Fdim), dtype=ct), x.new_empty(x.shape, dtype=ct)


def _no_residual(x: Tensor) -> Tensor:
    return x.new_empty((0,), dtype=torch.promote_types(x.dtype, torch.float32))


# ---------------------------------------------------------------- #3


@torch.library.custom_op("imm_tsf::fused_causal_attention", mutates_args=(),
                         device_types="cpu")
def fused_causal_attention(q: Tensor, k: Tensor, v: Tensor, pad: Tensor,
                           one_pass: bool = False) -> Tensor:
    """q, k, v [B, H, T, D], pad [B, T] -> [B, H, T, D]. `one_pass`: the
    one-pass bf16 form, q, k, then the probabilities and v rounded to bf16
    at the two products."""
    from .attn import attention_reference

    return attention_reference(q, k, v, pad, one_pass=one_pass)


@fused_causal_attention.register_kernel("cuda")
def _(q, k, v, pad, one_pass=False):
    from .attn import _launch

    return _launch(q, k, v, pad, one_pass=one_pass)


@fused_causal_attention.register_fake
def _(q, k, v, pad, one_pass=False):
    return torch.empty_like(q)


# ---------------------------------------------------------------- #5


@torch.library.custom_op("imm_tsf::batched_expm", mutates_args=(), device_types="cpu")
def batched_expm(M: Tensor, max_squarings: int = 7) -> Tensor:
    """M [B, n, n] -> exp(M); the plain version takes [..., n, n]. Which
    form the kernel runs a matrix in (`expm.takes_triangular`) is decided
    on the card, matrix by matrix."""
    from ..ops.expm import expm_taylor12

    return expm_taylor12(M, max_squarings)


@batched_expm.register_kernel("cuda")
def _(M, max_squarings=7):
    from .expm import _launch

    return _launch(M, max_squarings)


@batched_expm.register_fake
def _(M, max_squarings=7):
    return torch.empty_like(M)


# ---------------------------------------------------------------- #6


@torch.library.custom_op("imm_tsf::fused_cru_scan", mutates_args=(), device_types="cpu")
def fused_cru_scan(y_mean: Tensor, y_var: Tensor, valid: Tensor, dts: Tensor,
                   coeff_w: Tensor, coeff_b: Tensor, dense_basis: Tensor, trans_var: Tensor,
                   init_cu: Tensor, init_cl: Tensor,
                   max_squarings: int = 7) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """-> (post_means [B,T,lsd], pm [B,T,lsd], pcu, pcl, pcs [B,T,lod])."""
    from ..ops.cru_scan import cru_scan_reference

    out, (pm, pcu, pcl, pcs) = cru_scan_reference(y_mean, y_var, valid, dts, coeff_w, coeff_b,
                                                  dense_basis, trans_var, init_cu, init_cl,
                                                  max_squarings)
    return out, pm, pcu, pcl, pcs


@fused_cru_scan.register_kernel("cuda")
def _(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis, trans_var, init_cu, init_cl,
      max_squarings=7):
    from .cru_scan import _launch

    out, (pm, pcu, pcl, pcs) = _launch(y_mean, y_var, valid, dts, coeff_w, coeff_b,
                                       dense_basis, trans_var, init_cu, init_cl, max_squarings)
    return out, pm, pcu, pcl, pcs


@fused_cru_scan.register_fake
def _(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis, trans_var, init_cu, init_cl,
      max_squarings=7):
    B, T, lod = y_mean.shape
    mean = y_mean.new_empty((B, T, 2 * lod))
    return mean, torch.empty_like(mean), *(y_mean.new_empty((B, T, lod)) for _ in range(3))
