"""Batched matrix exponential: the CUDA kernel `csrc/expm.cu` and its
plain version.

Port of imm_tsf_tpu/ops/pallas/expm_kernel.py (`expm_pallas`): exp(M)
of every matrix of M [B, n, n] float32, tiered Taylor (Taylor-4 at
||M||inf <= 1/32, else Taylor-12 on M/2^k and k squarings, k chosen per
matrix; csrc/expm.cuh). The plain version is `ops.expm.expm_taylor12`,
the JAX package's path off the TPU: the two truncate below float32 eps
and agree to float32 rounding. The wrapper runs the plain version for
CPU tensors and launches the kernel for CUDA tensors, for any B and
n <= 64; a larger n raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.expm import expm_taylor12
from . import _build

launches = 0  # kernel launches through batched_expm

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "expm_forward": ([_P, _P, _I, _I, _I, _P], _I),
    "expm_max_n": ([], _I),
}


def _library() -> ctypes.CDLL:
    return _build.load("expm", _SIGNATURES)


def batched_expm(M: torch.Tensor, max_squarings: int = 7) -> torch.Tensor:
    """M [B, n, n] float32 -> exp(M) [B, n, n]."""
    if M.device.type == "cpu":
        return expm_taylor12(M, max_squarings)
    if M.device.type != "cuda":
        raise ValueError(f"batched_expm: unsupported device {M.device}")
    if M.dim() != 3 or M.shape[1] != M.shape[2] or M.dtype != torch.float32:
        raise ValueError(
            f"batched_expm: M must be float32 [B, n, n], got {M.dtype} {tuple(M.shape)}")
    if max_squarings < 0:
        raise ValueError(f"batched_expm: max_squarings must be >= 0, got {max_squarings}")
    B, n, _ = M.shape
    lib = _library()
    if n > lib.expm_max_n():
        raise ValueError(
            f"batched_expm: n={n} exceeds the kernel's {lib.expm_max_n()} x "
            f"{lib.expm_max_n()} shared-memory matrices")
    M = M.contiguous()
    out = torch.empty_like(M)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(M.device).cuda_stream
    rc = lib.expm_forward(M.data_ptr(), out.data_ptr(), B, n, max_squarings, stream)
    _build.check(rc, "batched_expm")
    global launches
    launches += 1
    return out
