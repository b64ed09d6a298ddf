"""Batched matrix exponential, forward only (after imm_tsf_tpu/ops/expm.py).

The CRU hot loop (reference lib/cru_components/CRUCell.py:357-391 calls
torch.matrix_exp per scan step) takes one expm of the [B, 2lsd, 2lsd]
Van Loan block per step. `expm` dispatches as the JAX package does
between its TPU kernel and the XLA chain: a CUDA tensor goes to the CUDA
kernel (kernels/expm.py, `csrc/expm.cu`; float32 [B, n, n], anything
else raises), a CPU tensor takes `expm_taylor12`, the plain version.

The Frechet-block backward (the JAX package's custom VJP) comes with the
training slice.
"""

from __future__ import annotations

import math

import torch

_T12_C = [1.0 / math.factorial(i) for i in range(13)]
_THETA_T12 = 1.0  # ||M/2^k|| <= 1 -> Taylor-12 truncation ~1.6e-10 << f32 eps


def expm_taylor12(M: torch.Tensor, max_squarings: int = 7) -> torch.Tensor:
    """Solve-free expm of [..., n, n]: degree-12 Taylor via
    Paterson-Stockmeyer on M/2^k, then `max_squarings` masked squarings
    (matrix i squares while step < k_i), k = min(ceil(log2(max(||M||inf,
    1))), max_squarings). A transcription of the JAX package's
    `expm_taylor12`; float32 matmuls stay full float32 (TF32 off)."""
    c = _T12_C
    norm = M.abs().sum(dim=-1).amax(dim=-1)  # inf-norm [...]
    k = torch.ceil(torch.log2(torch.clamp(norm / _THETA_T12, min=1.0)))
    k = torch.clamp(k, max=max_squarings)
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


def expm(M: torch.Tensor, max_squarings: int = 7) -> torch.Tensor:
    """Batched expm, forward only: the CUDA kernel for a CUDA tensor
    (float32 [B, n, n]), the Taylor-12 chain for a CPU tensor."""
    if M.device.type == "cuda":
        from ..kernels.expm import batched_expm

        return batched_expm(M, max_squarings)
    return expm_taylor12(M, max_squarings=max_squarings)
