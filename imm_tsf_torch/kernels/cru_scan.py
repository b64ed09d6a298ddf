"""The whole CRU Kalman scan in one launch, forward and backward: the CUDA
kernels `csrc/cru_scan.cu` (#6) and `csrc/cru_scan_bwd.cu` (#7) and their
plain versions.

#6 ports imm_tsf_tpu/ops/pallas/cru_scan_kernel.py (`cru_scan_fwd_pallas`):
for each sample, T sequential Kalman steps (update, softmax transition
coefficients, Van Loan expm, covariance propagation) with the carry kept
on chip. Returns (post_means [B,T,lsd], (pm [B,T,lsd], pcu, pcl, pcs
[B,T,lod])), the residuals being the prior state entering each step, as
the TPU kernel writes them for its backward. Each step's Van Loan expm
runs in csrc/expm.cuh's block-triangular form. Plain version:
`ops.cru_scan.cru_scan_reference`.

#7 ports `cru_scan_bwd_pallas`: the reverse-time VJP on #6's residuals,
each step recomputed, the expm's adjoint by the Frechet pair recursion.
Returns (gy, gyv [B,T,lod], gW [lsd,K], gb [K], gA [K,lsd,lsd], gq [lsd],
gicu, gicl [lod]); the kernel writes the last six per sample and the
wrapper sums them over the batch. Each sample runs on a thread-block
cluster of `_cluster.cluster_size(B, active)` CTAs, from the clusters the
card holds at once (`cluster_plan`). Plain version:
`ops.cru_scan.cru_scan_bwd_reference`.

Each wrapper runs its plain version for CPU tensors and launches its
kernel for CUDA tensors, for any B and T, lsd = 2 lod <= 32 and K <= 32;
larger sizes raise.
"""

from __future__ import annotations

import ctypes

import torch

from ..layers.bf16_products import full_precision
# cru_scan_reference: the plain version of #6, named beside its kernel
from ..ops.cru_scan import _build_A, cru_scan_bwd_reference, cru_scan_reference  # noqa: F401
from . import _build, _cluster, ops
from ._cluster import CLUSTER_SIZES

launches = 0  # kernel launches through fused_cru_scan (#6)
backward_launches = 0  # kernel launches through fused_cru_scan_backward (#7)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "cru_scan_forward": ([_P] * 15 + [_I] * 5 + [_P], _I),
    "cru_scan_max_lod": ([], _I),
    "cru_scan_max_k": ([], _I),
}
_BWD_SIGNATURES = {
    "cru_scan_backward": ([_P] * 21 + [_I] * 6 + [_P], _I),
    "cru_scan_bwd_active_clusters": ([_I, _I, _I, ctypes.POINTER(ctypes.c_int)], _I),
    "cru_scan_bwd_max_lod": ([], _I),
    "cru_scan_bwd_max_k": ([], _I),
}
_PARAMS = ("y_mean", "y_var", "valid", "dts", "coeff_w", "coeff_b", "dense_basis",
           "trans_var", "init_cu", "init_cl")


def _checked(name, args, extra, max_squarings, max_lod, max_k):
    """The scan's ten inputs (and `extra`, name -> (tensor, shape)) checked
    as float32 of the scan's shapes on one CUDA device; returns B, T, lod,
    K. Raises on anything the kernels do not take."""
    y_mean = args[0]
    if y_mean.dim() != 3:
        raise ValueError(f"{name}: y_mean must be [B, T, lod], got {tuple(y_mean.shape)}")
    B, T, lod = y_mean.shape
    lsd, K = 2 * lod, args[4].shape[-1]
    shapes = ((B, T, lod), (B, T, lod), (B, T), (B, T), (lsd, K), (K,), (4, K, lod, lod),
              (lsd,), (lod,), (lod,))
    want = {n: (t, s) for n, t, s in zip(_PARAMS, args, shapes)}
    want.update({n: (t, s(B, T, lod, K)) for n, (t, s) in extra.items()})
    for arg, (t, shape) in want.items():
        if t.dtype != torch.float32 or t.device != y_mean.device or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: {arg} must be float32 {shape} on {y_mean.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if max_squarings < 0:
        raise ValueError(f"{name}: max_squarings must be >= 0, got {max_squarings}")
    if lod > max_lod or K > max_k:
        raise ValueError(
            f"{name}: lod={lod}, K={K} exceed the kernel's lod <= {max_lod} "
            f"(a 64 x 64 Van Loan block) and K <= {max_k}")
    return B, T, lod, K


def cluster_plan(B: int, lod: int, K: int, device) -> dict:
    """#7's launch at (B, lod, K) on a CUDA device (_cluster.cluster_plan)."""
    def count(C):
        lib = _build.load("cru_scan_bwd", _BWD_SIGNATURES)
        n = ctypes.c_int(0)
        _build.check(lib.cru_scan_bwd_active_clusters(lod, K, C, ctypes.byref(n)),
                     "cru_scan_bwd_active_clusters")
        return n.value

    return _cluster.cluster_plan(B, device, "cru_scan_bwd", (lod, K), count)


def _kernel_inputs(args):
    """The kernels take A [K, lsd, lsd] and assemble the Van Loan block from it."""
    ins = [t.contiguous() for t in args[:6]]
    return ins + [_build_A(args[6]).contiguous()] + [t.contiguous() for t in args[7:10]]


@full_precision()
def fused_cru_scan(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
                   trans_var, init_cu, init_cl, max_squarings: int = 7):
    """y_mean, y_var [B,T,lod], valid, dts [B,T], coeff_w [lsd,K], coeff_b [K],
    dense_basis [4,K,lod,lod], trans_var [lsd], init_cu, init_cl [lod]
    (float32) -> (post_means, (pm, pcu, pcl, pcs)), through the op
    `ops.fused_cru_scan`: kernel #6 for CUDA tensors, the plain version for
    CPU tensors. Full float32 under compute_dtype="bfloat16", as the TPU
    kernel's HIGHEST products are (the plain version's products too)."""
    ops.check_device("fused_cru_scan", y_mean)
    out, pm, pcu, pcl, pcs = ops.fused_cru_scan(y_mean, y_var, valid, dts, coeff_w, coeff_b,
                                                dense_basis, trans_var, init_cu, init_cl,
                                                max_squarings)
    return out, (pm, pcu, pcl, pcs)


def _launch(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis, trans_var, init_cu,
            init_cl, max_squarings: int):
    """Kernel #6 on CUDA tensors (the op's CUDA implementation)."""
    args = (y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis, trans_var, init_cu,
            init_cl)
    if y_mean.device.type != "cuda":
        raise ValueError(f"fused_cru_scan: unsupported device {y_mean.device}")
    lib = _build.load("cru_scan", _SIGNATURES)
    B, T, lod, K = _checked("fused_cru_scan", args, {}, max_squarings,
                            lib.cru_scan_max_lod(), lib.cru_scan_max_k())
    dev, lsd = y_mean.device, 2 * lod
    out = torch.empty((B, T, lsd), dtype=torch.float32, device=dev)
    pm = torch.empty((B, T, lsd), dtype=torch.float32, device=dev)
    pcu, pcl, pcs = (torch.empty((B, T, lod), dtype=torch.float32, device=dev) for _ in range(3))
    if B == 0 or T == 0:
        return out, (pm, pcu, pcl, pcs)
    ins = _kernel_inputs(args)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.cru_scan_forward(*(t.data_ptr() for t in ins),
                              *(t.data_ptr() for t in (out, pm, pcu, pcl, pcs)),
                              B, T, lod, K, max_squarings, stream)
    _build.check(rc, "fused_cru_scan")
    global launches
    launches += 1
    return out, (pm, pcu, pcl, pcs)


def fused_cru_scan_backward(y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis,
                            trans_var, init_cu, init_cl, residuals, g,
                            max_squarings: int = 7, cluster: int | None = None):
    """The scan's inputs, #6's residuals (pm [B,T,lsd], pcu, pcl, pcs
    [B,T,lod]) and the cotangent g [B,T,lsd] of the post-means (float32)
    -> (gy, gyv, gW, gb, gA, gq, gicu, gicl). `cluster` (1, 2 or 4) sets
    the CTAs a sample takes on the card; None: `cluster_plan`'s."""
    args = (y_mean, y_var, valid, dts, coeff_w, coeff_b, dense_basis, trans_var, init_cu,
            init_cl)
    if y_mean.device.type == "cpu":
        return cru_scan_bwd_reference(*args, residuals, g, max_squarings)
    if y_mean.device.type != "cuda":
        raise ValueError(f"fused_cru_scan_backward: unsupported device {y_mean.device}")
    lib = _build.load("cru_scan_bwd", _BWD_SIGNATURES)
    pm, pcu, pcl, pcs = residuals
    by_state = lambda B, T, lod, K: (B, T, lod)
    by_mean = lambda B, T, lod, K: (B, T, 2 * lod)
    B, T, lod, K = _checked(
        "fused_cru_scan_backward", args,
        {"pm": (pm, by_mean), "pcu": (pcu, by_state), "pcl": (pcl, by_state),
         "pcs": (pcs, by_state), "g": (g, by_mean)},
        max_squarings, lib.cru_scan_bwd_max_lod(), lib.cru_scan_bwd_max_k())
    dev, lsd = y_mean.device, 2 * lod
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    gy, gyv = empty(B, T, lod), empty(B, T, lod)
    gW, gb, gA, gq = empty(B, lsd, K), empty(B, K), empty(B, K, lsd, lsd), empty(B, lsd)
    gicu, gicl = empty(B, lod), empty(B, lod)
    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f"fused_cru_scan_backward: cluster must be one of {CLUSTER_SIZES}, "
                         f"got {cluster}")
    if B > 0:
        if cluster is None:
            cluster = cluster_plan(B, lod, K, dev)["cluster"]
        ins = _kernel_inputs(args)[:8]  # init_cu, init_cl: the residuals hold them
        ins += [t.contiguous() for t in (pm, pcu, pcl, pcs, g)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cru_scan_backward(*(t.data_ptr() for t in ins),
                                   *(t.data_ptr() for t in (gy, gyv, gW, gb, gA, gq, gicu, gicl)),
                                   B, T, lod, K, max_squarings, cluster, stream)
        _build.check(rc, "fused_cru_scan_backward")
        global backward_launches
        backward_launches += 1
    # the per-sample partials, summed over the batch after the launch
    return (gy, gyv, gW.sum(0), gb.sum(0), gA.sum(0), gq.sum(0), gicu.sum(0), gicl.sum(0))
