"""Series decomposition blocks (after imm_tsf_tpu/layers/decomp.py;
reference layers/Autoformer_EncDec.py:21-54): edge padding and an average
pool over time; and TimeMixer's DFT decomposition."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.base import pad_edge


def moving_avg(x: torch.Tensor, kernel_size: int, stride: int = 1) -> torch.Tensor:
    """x [B, L, C] -> trend [B, L', C]: replicate-pads (k-1)//2 on both
    ends, then averages windows of k over time (reference :21-38). An even
    k loses a row, L' = L - 1, as in the JAX package."""
    pad = (kernel_size - 1) // 2
    x = x.permute(0, 2, 1)  # [B, C, L]: pad and pool the last axis
    x = pad_edge(x, pad, pad)
    return F.avg_pool1d(x, kernel_size, stride).permute(0, 2, 1)


def series_decomp(x: torch.Tensor, kernel_size: int):
    """Returns (residual/seasonal, moving_mean/trend) (reference :41-53)."""
    mean = moving_avg(x, kernel_size, stride=1)
    return x - mean, mean


def fft_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype an FFT over `dtype` runs in: float32, or float64 for a
    float64 input (the JAX package upcasts to float32 for bfloat16)."""
    return torch.promote_types(dtype, torch.float32)


def dft_decomp(x: torch.Tensor, top_k: int = 5):
    """DFT decomposition (after imm_tsf_tpu/layers/decomp.py:33-47; reference
    models/TimeMixer.py:9-27): x [B, L, C] -> (season, trend). The season
    keeps the bins of each (batch, channel) whose magnitude reaches the
    top_k-th largest (ties at the k-th place kept, so possibly more than
    top_k), the DC bin never; the trend is the rest. With fewer bins than
    top_k every bin is kept: JAX clamps the index -top_k to the first."""
    xf = torch.fft.rfft(x.to(fft_dtype(x.dtype)), dim=1)
    freq = xf.abs().detach()  # a selection only, as jnp.where's condition
    freq[:, 0] = 0.0
    kth = torch.sort(freq, dim=1).values[:, max(freq.shape[1] - top_k, 0)][:, None]
    xf = torch.where(freq >= kth, xf, torch.zeros_like(xf))
    x_season = torch.fft.irfft(xf, n=x.shape[1], dim=1).to(x.dtype)
    return x_season, x - x_season
