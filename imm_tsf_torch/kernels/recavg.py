"""Recency-weighted note average: the CUDA kernel `csrc/recavg.cu` and
its plain version.

Port of imm_tsf_tpu/ops/pallas/fusion_kernels.py
(`recency_weighted_average`, forward only):

    w = exp(-(max(t_hat - tau, 0) / sigma)^2) * mask        # [B, N, T]
    E = w^T V / max(sum_n w, 1e-6)                            # [B, T, d]

The wrapper runs the plain version for CPU tensors and launches the
kernel for CUDA tensors, for any B, N, T and d and any V the kernel can
read (a V whose data is not 16-byte aligned, or d not a multiple of 4,
takes the kernel's 4-byte form). A block owns one sample, a slab of
columns and a few forecast times (`launch_config`). It is
differentiable: its backward is `recavg_backward_reference`, the plain
PyTorch transcription of the JAX package's hand VJP (`_bwd`,
fusion_kernels.py:120-140), which is XLA there and not a Pallas kernel.
Gradients go to tau, t_hat, V and sigma; mask is data.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0  # kernel launches through recency_weighted_average


def recavg_reference(tau, t_hat, V, mask, sigma) -> torch.Tensor:
    """Plain PyTorch forward (after fusion_kernels.py:_recavg_xla)."""
    delta = (t_hat[:, None, :] - tau[:, :, None]).clamp(min=0)  # [B,N,T]
    w = torch.exp(-((delta / sigma) ** 2)) * mask[:, :, None]
    denom = w.sum(dim=1).clamp(min=1e-6)  # [B,T]
    return torch.einsum("bnt,bnd->btd", w, V) / denom[:, :, None]


def recavg_backward_reference(tau, t_hat, V, mask, sigma, E, dE):
    """The hand VJP (fusion_kernels.py:_bwd) -> (dtau, dt_hat, dV, dsigma).
    w and its sum are recomputed; E is the forward's output."""
    delta = (t_hat[:, None, :] - tau[:, :, None]).clamp(min=0)  # [B,N,T]
    w = torch.exp(-((delta / sigma) ** 2)) * mask[:, :, None]
    S = w.sum(dim=1)  # [B,T] (pre-clip)
    inv = 1.0 / S.clamp(min=1e-6)
    dV = torch.einsum("bnt,btd->bnd", w * inv[:, None, :], dE)
    # dW[t,d] = dE/denom; dS = -(E . dE)/denom, gated by the clip
    dS = -(E * dE).sum(-1) * inv * (S > 1e-6).to(dE.dtype)  # [B,T]
    dw = torch.einsum("bnd,btd->bnt", V, dE * inv[:, :, None]) + dS[:, None, :]
    ddelta = dw * (w * (-2.0 * delta / sigma ** 2))
    ddelta = ddelta * (t_hat[:, None, :] - tau[:, :, None] > 0).to(dE.dtype)
    dsigma = (dw * w * 2.0 * delta ** 2 / sigma ** 3).sum()
    return -ddelta.sum(dim=2), ddelta.sum(dim=1), dV, dsigma


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"recavg_forward": ([_P] * 6 + [_I] * 6 + [_P], _I),
               "recavg_forward_tiled": ([_P] * 6 + [_I] * 4 + [_P], _I),
               "recavg_empty": ([_I] * 5 + [_P], _I)}


def _library() -> ctypes.CDLL:
    return _build.load("recavg", _SIGNATURES)


class _RecencyAverage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tau, t_hat, V, mask, sigma):
        E = _forward(tau, t_hat, V, mask, sigma)
        ctx.save_for_backward(tau, t_hat, V, mask, sigma, E)
        return E

    @staticmethod
    def backward(ctx, dE):
        tau, t_hat, V, mask, sigma, E = ctx.saved_tensors
        dtau, dt_hat, dV, dsigma = recavg_backward_reference(tau, t_hat, V, mask, sigma, E, dE)
        return dtau, dt_hat, dV, None, dsigma.reshape(sigma.shape)


def recency_weighted_average(tau, t_hat, V, mask, sigma) -> torch.Tensor:
    """[B,N] x [B,T] x [B,N,d] x [B,N] x 0-d sigma -> E [B,T,d], differentiable.

    On CUDA, sigma stays a device tensor: the host never syncs on it."""
    return _RecencyAverage.apply(tau, t_hat, V, mask, sigma)


def launch_config(T: int) -> tuple[int, int]:
    """(threads a block, forecast times a block) of the kernel: 64 threads
    of 4 columns, and T split evenly into blocks of at most 8 times, so that
    at N <= 8 the weights take one round of the block's 8 lane groups. The
    fastest measured on an H100 at the serving and training shapes, within
    0.1 us (tools/torch_kernel_probe.py, PERF.md)."""
    splits = -(-T // 8)
    return 64, -(-T // splits)


def _checked(tau, t_hat, V, mask, sigma):
    """The inputs as the kernel takes them (float32 on V's CUDA device,
    tau, t_hat and mask contiguous), or raise."""
    if V.device.type != "cuda":
        raise ValueError(f"recency_weighted_average: unsupported device {V.device}")
    B, N, d = V.shape
    T = t_hat.shape[1]
    want = {"tau": (tau, (B, N)), "t_hat": (t_hat, (B, T)), "V": (V, (B, N, d)),
            "mask": (mask, (B, N)), "sigma": (sigma, tuple(sigma.shape))}
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32 or t.device != V.device or tuple(t.shape) != shape:
            raise ValueError(
                f"recency_weighted_average: {name} must be float32 {shape} on "
                f"{V.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if sigma.numel() != 1:
        raise ValueError("recency_weighted_average: sigma must hold one value")
    return tuple(t.contiguous() for t in (tau, t_hat, V, mask, sigma))


def _forward(tau, t_hat, V, mask, sigma, config=None) -> torch.Tensor:
    """Kernel #1 for CUDA tensors, the plain version for CPU tensors.
    config: (threads, t_per_block) instead of launch_config's."""
    if V.device.type == "cpu":
        return recavg_reference(tau, t_hat, V, mask, sigma)
    tau, t_hat, V, mask, sigma = _checked(tau, t_hat, V, mask, sigma)
    B, N, d = V.shape
    T = t_hat.shape[1]
    lib = _library()
    E = torch.empty((B, T, d), dtype=torch.float32, device=V.device)
    if E.numel() == 0:
        return E
    threads, t_per_block = config or launch_config(T)
    rc = lib.recavg_forward(tau.data_ptr(), t_hat.data_ptr(), V.data_ptr(), mask.data_ptr(),
                            sigma.data_ptr(), E.data_ptr(), B, N, T, d, threads, t_per_block,
                            torch.cuda.current_stream(V.device).cuda_stream)
    _build.check(rc, "recency_weighted_average")
    global launches
    launches += 1
    return E


def tiled_forward(tau, t_hat, V, mask, sigma) -> torch.Tensor:
    """The kernel's previous design (`recavg_forward_tiled`), on CUDA
    tensors: timed beside the kernel, never on the path."""
    tau, t_hat, V, mask, sigma = _checked(tau, t_hat, V, mask, sigma)
    B, N, d = V.shape
    T = t_hat.shape[1]
    E = torch.empty((B, T, d), dtype=torch.float32, device=V.device)
    rc = _library().recavg_forward_tiled(
        tau.data_ptr(), t_hat.data_ptr(), V.data_ptr(), mask.data_ptr(), sigma.data_ptr(),
        E.data_ptr(), B, N, T, d, torch.cuda.current_stream(V.device).cuda_stream)
    _build.check(rc, "recavg_forward_tiled")
    return E


def empty_launch(B: int, T: int, d: int, device) -> None:
    """An empty kernel on the grid the kernel takes at (B, T, d): the
    launch floor under its time."""
    threads, t_per_block = launch_config(T)
    rc = _library().recavg_empty(B, T, d, threads, t_per_block,
                                 torch.cuda.current_stream(device).cuda_stream)
    _build.check(rc, "recavg_empty")
