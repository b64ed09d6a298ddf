"""Batched matrix exponential and its Frechet derivative: the CUDA kernels
`csrc/expm.cu` (#5) and `csrc/expm_frechet.cu` (#4) and their plain
versions.

#5 ports imm_tsf_tpu/ops/pallas/expm_kernel.py (`expm_pallas`): exp(M)
of every matrix of M [B, n, n] float32, tiered Taylor (Taylor-4 at
||M||inf <= 1/32, else Taylor-12 on M/2^k and k squarings, k chosen per
matrix; csrc/expm.cuh), one block of 128 threads a matrix. A matrix whose
zero-padded lower-left 32 x 32 block is exactly zero (`takes_triangular`:
every n <= 32, and the CRU's Van Loan blocks at lsd 32 or lsd <= 16)
takes the block-triangular form, any other the dense one. Its plain
version is `ops.expm.expm_taylor12`, the JAX package's path off the TPU:
the two truncate below float32 eps and agree to float32 rounding.

#4 ports `expm_frechet_pallas`: L_exp(M)[E] of every pair of M, E
[B, n, n] float32 by Taylor-12 and k squarings on (value, derivative)
pairs (csrc/frechet.cuh), each matrix on a thread-block cluster of
`_cluster.cluster_size(B, active)` CTAs, from the clusters the card holds
at once (`frechet_plan`). Its plain version is
`ops.expm.expm_frechet_taylor12`, the same recursion.

Each wrapper runs its plain version for CPU tensors and launches its
kernel for CUDA tensors, for any B and n <= 64; a larger n raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.expm import expm_frechet_taylor12, expm_taylor12
from . import _build, _cluster

launches = 0  # kernel launches through batched_expm (#5)
frechet_launches = 0  # kernel launches through batched_expm_frechet (#4)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "expm_forward": ([_P, _P, _I, _I, _I, _P], _I),
    "expm_max_n": ([], _I),
}
HALF = 32  # the block size of the triangular form (64 / 2)
_FRECHET_SIGNATURES = {
    "expm_frechet_forward": ([_P, _P, _P, _I, _I, _I, _I, _P], _I),
    "expm_frechet_active_clusters": ([_I, ctypes.POINTER(ctypes.c_int)], _I),
    "expm_frechet_max_n": ([], _I),
}


def _check(name: str, tensors: dict, max_squarings: int, max_n) -> None:
    """Raise unless every tensor is float32 [B, n, n] of one shape with
    n <= max_n() on the first one's CUDA device."""
    first = next(iter(tensors.values()))
    for arg, t in tensors.items():
        if (t.dim() != 3 or t.shape[1] != t.shape[2] or t.dtype != torch.float32
                or t.shape != first.shape or t.device != first.device):
            raise ValueError(f"{name}: {arg} must be float32 [B, n, n] like the first "
                             f"argument, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if max_squarings < 0:
        raise ValueError(f"{name}: max_squarings must be >= 0, got {max_squarings}")
    if first.shape[1] > max_n():
        raise ValueError(f"{name}: n={first.shape[1]} exceeds the kernel's {max_n()} x "
                         f"{max_n()} shared-memory matrices")


def takes_triangular(M: torch.Tensor) -> torch.Tensor:
    """Per matrix of M [..., n, n], n <= 64: whether #5 takes the
    block-triangular form, i.e. the lower-left 32 x 32 block of M
    zero-padded to 64 x 64 is exactly zero (a NaN is not zero). Always at
    n <= 32. The CRU's Van Loan blocks [[A, Q], [0, -A^T]] dt (n = 2 lsd)
    take it at lsd 32 and lsd <= 16; at 16 < lsd < 32 the -A^T block
    crosses row 32 and they take the dense form. (#6 lays its blocks out
    at 32-offsets, so every one of its steps is triangular.)"""
    lower = M[..., HALF:, :HALF]
    return (lower == 0).flatten(-2).all(-1) if lower.numel() else torch.ones(
        M.shape[:-2], dtype=torch.bool, device=M.device)


def batched_expm(M: torch.Tensor, max_squarings: int = 7) -> torch.Tensor:
    """M [B, n, n] float32 -> exp(M) [B, n, n]."""
    if M.device.type == "cpu":
        return expm_taylor12(M, max_squarings)
    if M.device.type != "cuda":
        raise ValueError(f"batched_expm: unsupported device {M.device}")
    lib = _build.load("expm", _SIGNATURES)
    _check("batched_expm", {"M": M}, max_squarings, lib.expm_max_n)
    B, n, _ = M.shape
    M = M.contiguous()
    if M.data_ptr() % 16:  # the kernel reads 64-wide rows as float4
        M = M.clone()
    out = torch.empty_like(M)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(M.device).cuda_stream
    rc = lib.expm_forward(M.data_ptr(), out.data_ptr(), B, n, max_squarings, stream)
    _build.check(rc, "batched_expm")
    global launches
    launches += 1
    return out


def frechet_plan(B: int, device) -> dict:
    """#4's launch at batch B on a CUDA device (_cluster.cluster_plan)."""
    def count(C):
        lib = _build.load("expm_frechet", _FRECHET_SIGNATURES)
        n = ctypes.c_int(0)
        _build.check(lib.expm_frechet_active_clusters(C, ctypes.byref(n)),
                     "expm_frechet_active_clusters")
        return n.value

    return _cluster.cluster_plan(B, device, "expm_frechet", (), count)


def batched_expm_frechet(M: torch.Tensor, E: torch.Tensor, max_squarings: int = 7,
                         cluster: int | None = None) -> torch.Tensor:
    """M, E [B, n, n] float32 -> L_exp(M)[E] [B, n, n]. `cluster` (1, 2 or
    4) sets the CTAs a matrix takes on the card; None: `frechet_plan`'s."""
    if M.device.type == "cpu":
        return expm_frechet_taylor12(M, E, max_squarings)
    if M.device.type != "cuda":
        raise ValueError(f"batched_expm_frechet: unsupported device {M.device}")
    lib = _build.load("expm_frechet", _FRECHET_SIGNATURES)
    _check("batched_expm_frechet", {"M": M, "E": E}, max_squarings, lib.expm_frechet_max_n)
    if cluster is not None and cluster not in _cluster.CLUSTER_SIZES:
        raise ValueError(f"batched_expm_frechet: cluster must be one of "
                         f"{_cluster.CLUSTER_SIZES}, got {cluster}")
    B, n, _ = M.shape
    M, E = M.contiguous(), E.contiguous()
    out = torch.empty_like(M)
    if B == 0:
        return out
    if cluster is None:
        cluster = frechet_plan(B, M.device)["cluster"]
    stream = torch.cuda.current_stream(M.device).cuda_stream
    rc = lib.expm_frechet_forward(M.data_ptr(), E.data_ptr(), out.data_ptr(), B, n,
                                  max_squarings, cluster, stream)
    _build.check(rc, "batched_expm_frechet")
    global frechet_launches
    frechet_launches += 1
    return out
