"""Batched matrix exponential and its backward (after imm_tsf_tpu/ops/expm.py).

The CRU hot loop (reference lib/cru_components/CRUCell.py:357-391 calls
torch.matrix_exp per scan step) takes one expm of the [B, 2lsd, 2lsd]
Van Loan block per step. `expm` is differentiable and dispatches as the
JAX package does between its TPU kernels and the XLA chain:

- forward: a CUDA tensor goes to kernel #5 (kernels/expm.py,
  `csrc/expm.cu`; float32 [B, n, n], n <= 64, anything else raises), a
  CPU tensor takes `expm_taylor12`, the plain version;
- backward: the adjoint <G, L_exp(M)[dM]> = <L_exp(M^T)[G], dM>. A CUDA
  tensor goes to kernel #4 (`batched_expm_frechet`, `csrc/expm_frechet.cu`:
  the (value, derivative) pair recursion, n <= 64); a CPU tensor takes the
  JAX package's own dispatch (`_expm_bwd`, :184-217): the 2n-square block
  exp([[M^T, E], [0, M^T]]) through `expm_taylor12` at n < 128, E the
  cotangent pre-scaled to an inf-norm of 2^-10, and the pair recursion
  `expm_frechet_taylor12` at n >= 128.

The JAX package picks the block form below n = 128 for the TPU's matrix
unit alone (its note at :185-194); the two forms compute the same adjoint,
and the pair form needs 3/8 of the block form's operations, so on the card
the backward is kernel #4 at every n it takes.

`expm_plain` is the same function with plain forward and backward on any
device: what the CRU trains through with `use_pallas` off.
"""

from __future__ import annotations

import math

import torch

_T12_C = [1.0 / math.factorial(i) for i in range(13)]
_THETA_T12 = 1.0  # ||M/2^k|| <= 1 -> Taylor-12 truncation ~1.6e-10 << f32 eps


def _squarings(M: torch.Tensor, max_squarings: int) -> torch.Tensor:
    """k = min(ceil(log2(max(||M||inf, 1))), max_squarings) per matrix, as a float."""
    norm = M.abs().sum(dim=-1).amax(dim=-1)  # inf-norm [...]
    k = torch.ceil(torch.log2(torch.clamp(norm / _THETA_T12, min=1.0)))
    return torch.clamp(k, max=max_squarings)


def expm_taylor12(M: torch.Tensor, max_squarings: int = 7) -> torch.Tensor:
    """Solve-free expm of [..., n, n]: degree-12 Taylor via
    Paterson-Stockmeyer on M/2^k, then `max_squarings` masked squarings
    (matrix i squares while step < k_i), k = min(ceil(log2(max(||M||inf,
    1))), max_squarings). A transcription of the JAX package's
    `expm_taylor12`; float32 matmuls stay full float32 (TF32 off)."""
    c = _T12_C
    k = _squarings(M, max_squarings)
    Ms = M / (2.0 ** k)[..., None, None]
    I = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    M2 = Ms @ Ms
    M3 = M2 @ Ms
    M4 = M2 @ M2
    # Paterson-Stockmeyer, base M4: T12 = B0 + M4 (B1 + M4 (B2 + M4 B3))
    B0 = c[0] * I + c[1] * Ms + c[2] * M2 + c[3] * M3
    B1 = c[4] * I + c[5] * Ms + c[6] * M2 + c[7] * M3
    B2 = c[8] * I + c[9] * Ms + c[10] * M2 + c[11] * M3
    B3 = c[12] * I
    R = B0 + M4 @ (B1 + M4 @ (B2 + M4 @ B3))
    for i in range(max_squarings):
        R = torch.where((i < k)[..., None, None], R @ R, R)
    return R


def _pmm(p, q):
    """Pair product (X, dX)(Y, dY) = (XY, X dY + dX Y)."""
    (X, dX), (Y, dY) = p, q
    return X @ Y, X @ dY + dX @ Y


def expm_frechet_taylor12(M: torch.Tensor, E: torch.Tensor,
                          max_squarings: int = 7) -> torch.Tensor:
    """L_exp(M)[E] of [..., n, n]: Taylor-12 and masked squarings on
    (value, derivative) pairs, the scaling from M alone (L is linear in
    E). The plain version of kernel #4; a transcription of the JAX
    package's `expm_frechet_taylor12` (ops/expm.py:143-177)."""
    c = _T12_C
    k = _squarings(M, max_squarings)
    s = (2.0 ** -k)[..., None, None]
    I = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    Mp = (M * s, E * s)
    M2 = _pmm(Mp, Mp)
    M3 = _pmm(M2, Mp)
    M4 = _pmm(M2, M2)

    def lin(a, b, c_, d):
        return (a * I + b * Mp[0] + c_ * M2[0] + d * M3[0],
                b * Mp[1] + c_ * M2[1] + d * M3[1])

    B0, B1, B2 = lin(*c[0:4]), lin(*c[4:8]), lin(*c[8:12])
    inner = (B2[0] + c[12] * M4[0], B2[1] + c[12] * M4[1])
    mid = _pmm(M4, inner)
    outer = _pmm(M4, (B1[0] + mid[0], B1[1] + mid[1]))
    R, L = B0[0] + outer[0], B0[1] + outer[1]
    for i in range(max_squarings):
        sel = (i < k)[..., None, None]
        R2, L2 = _pmm((R, L), (R, L))
        R, L = torch.where(sel, R2, R), torch.where(sel, L2, L)
    return L


def expm_adjoint(M: torch.Tensor, G: torch.Tensor, max_squarings: int = 7,
                 kernel: bool = True) -> torch.Tensor:
    """L_exp(M^T)[G], the cotangent of M for the cotangent G of exp(M):
    kernel #4 for a CUDA tensor when `kernel`, else the JAX package's
    dispatch (block form at n < 128, pair recursion above)."""
    Mt = M.transpose(-1, -2)
    if kernel and M.device.type == "cuda":
        from ..kernels.expm import batched_expm_frechet

        return batched_expm_frechet(Mt, G, max_squarings)
    n = M.shape[-1]
    if n >= 128:
        return expm_frechet_taylor12(Mt, G, max_squarings)
    # block form; G pre-scaled so that it cannot inflate the block's norm
    scale = 2.0 ** -10 / torch.clamp(G.abs().sum(dim=-1).amax(dim=-1), min=1e-30)
    E = G * scale[..., None, None]
    blk = torch.cat([torch.cat([Mt, E], -1), torch.cat([torch.zeros_like(M), Mt], -1)], -2)
    return expm_taylor12(blk, max_squarings)[..., :n, n:] / scale[..., None, None]


class _Expm(torch.autograd.Function):
    """exp(M) with the Frechet adjoint as its backward (the JAX package's
    custom VJP). `kernel` selects the CUDA kernels for CUDA tensors."""

    @staticmethod
    def forward(ctx, M, max_squarings, kernel):
        ctx.save_for_backward(M)
        ctx.max_squarings, ctx.kernel = max_squarings, kernel
        if kernel and M.device.type == "cuda":
            from ..kernels.expm import batched_expm

            return batched_expm(M, max_squarings)
        return expm_taylor12(M, max_squarings)

    @staticmethod
    def backward(ctx, G):
        (M,) = ctx.saved_tensors
        return expm_adjoint(M, G, ctx.max_squarings, ctx.kernel), None, None


def expm(M: torch.Tensor, max_squarings: int = 7) -> torch.Tensor:
    """Differentiable batched expm: kernels #5 (forward) and #4 (backward)
    for a CUDA tensor (float32 [B, n, n]), the plain versions for a CPU
    tensor ([..., n, n], any float type)."""
    return _Expm.apply(M, max_squarings, True)


def expm_plain(M: torch.Tensor, max_squarings: int = 7) -> torch.Tensor:
    """Differentiable expm through the plain versions on any device."""
    return _Expm.apply(M, max_squarings, False)
