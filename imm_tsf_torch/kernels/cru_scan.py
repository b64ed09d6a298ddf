"""The whole CRU Kalman scan in one launch: the CUDA kernel
`csrc/cru_scan.cu` and its plain version.

Port of imm_tsf_tpu/ops/pallas/cru_scan_kernel.py (`cru_scan_fwd_pallas`,
forward only): for each sample, T sequential Kalman steps (update, softmax
transition coefficients, Van Loan expm, covariance propagation) with the
carry kept on chip. Returns (post_means [B,T,lsd], (pm [B,T,lsd], pcu, pcl,
pcs [B,T,lod])), the residuals being the prior state entering each step,
as the TPU kernel writes them for its backward.

The plain version is `ops.cru_scan.cru_scan_reference`. The wrapper runs
it for CPU tensors and launches the kernel for CUDA tensors, for any B
and T, lsd = 2 lod <= 32 and K <= 32; larger sizes raise. The backward
(`cru_scan_bwd_pallas`, kernel #7) comes with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.cru_scan import _build_A, cru_scan_reference
from . import _build

launches = 0  # kernel launches through fused_cru_scan

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "cru_scan_forward": ([_P] * 15 + [_I] * 5 + [_P], _I),
    "cru_scan_max_lod": ([], _I),
    "cru_scan_max_k": ([], _I),
}


def _library() -> ctypes.CDLL:
    return _build.load("cru_scan", _SIGNATURES)


def fused_cru_scan(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
                   trans_var, init_cu, init_cl, max_squarings: int = 7):
    """y_mean, y_var [B,T,lod], valid, dts [B,T], coeff_w [lsd,K], coeff_b [K],
    dense_basis [4,K,lod,lod], trans_var [lsd], init_cu, init_cl [lod]
    (float32) -> (post_means, (pm, pcu, pcl, pcs))."""
    if y_mean.device.type == "cpu":
        return cru_scan_reference(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
                                  trans_var, init_cu, init_cl, max_squarings)
    if y_mean.device.type != "cuda":
        raise ValueError(f"fused_cru_scan: unsupported device {y_mean.device}")
    if y_mean.dim() != 3:
        raise ValueError(f"fused_cru_scan: y_mean must be [B, T, lod], got {tuple(y_mean.shape)}")
    B, T, lod = y_mean.shape
    lsd, K = 2 * lod, coeff_w.shape[-1]
    want = {"y_mean": (y_mean, (B, T, lod)), "y_var": (y_var, (B, T, lod)),
            "valid": (valid, (B, T)), "dts": (dts, (B, T)), "coeff_w": (coeff_w, (lsd, K)),
            "coeff_b": (coeff_b, (K,)), "dense_basis": (dense_basis, (4, K, lod, lod)),
            "trans_var": (trans_var, (lsd,)), "init_cu": (init_cu, (lod,)),
            "init_cl": (init_cl, (lod,))}
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32 or t.device != y_mean.device or tuple(t.shape) != shape:
            raise ValueError(
                f"fused_cru_scan: {name} must be float32 {shape} on {y_mean.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if max_squarings < 0:
        raise ValueError(f"fused_cru_scan: max_squarings must be >= 0, got {max_squarings}")
    lib = _library()
    if lod > lib.cru_scan_max_lod() or K > lib.cru_scan_max_k():
        raise ValueError(
            f"fused_cru_scan: lod={lod}, K={K} exceed the kernel's lod <= "
            f"{lib.cru_scan_max_lod()} (a 64 x 64 Van Loan block) and K <= {lib.cru_scan_max_k()}")
    A = _build_A(dense_basis).contiguous()  # [K, lsd, lsd]; the kernel assembles bigG from it
    ins = [t.contiguous() for t in (y_mean, y_var, valid, dts, coeff_w, coeff_b)]
    ins += [A, trans_var.contiguous(), init_cu.contiguous(), init_cl.contiguous()]
    dev = y_mean.device
    out = torch.empty((B, T, lsd), dtype=torch.float32, device=dev)
    pm = torch.empty((B, T, lsd), dtype=torch.float32, device=dev)
    pcu, pcl, pcs = (torch.empty((B, T, lod), dtype=torch.float32, device=dev) for _ in range(3))
    if B == 0 or T == 0:
        return out, (pm, pcu, pcl, pcs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.cru_scan_forward(*(t.data_ptr() for t in ins),
                              *(t.data_ptr() for t in (out, pm, pcu, pcl, pcs)),
                              B, T, lod, K, max_squarings, stream)
    _build.check(rc, "fused_cru_scan")
    global launches
    launches += 1
    return out, (pm, pcu, pcl, pcs)
