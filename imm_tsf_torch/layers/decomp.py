"""Series decomposition blocks (after imm_tsf_tpu/layers/decomp.py;
reference layers/Autoformer_EncDec.py:21-54): edge padding and an average
pool over time."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def moving_avg(x: torch.Tensor, kernel_size: int, stride: int = 1) -> torch.Tensor:
    """x [B, L, C] -> trend [B, L', C]: replicate-pads (k-1)//2 on both
    ends, then averages windows of k over time (reference :21-38). An even
    k loses a row, L' = L - 1, as in the JAX package."""
    pad = (kernel_size - 1) // 2
    x = x.permute(0, 2, 1)  # [B, C, L]: pad and pool the last axis
    x = F.pad(x, (pad, pad), mode="replicate")
    return F.avg_pool1d(x, kernel_size, stride).permute(0, 2, 1)


def series_decomp(x: torch.Tensor, kernel_size: int):
    """Returns (residual/seasonal, moving_mean/trend) (reference :41-53)."""
    mean = moving_avg(x, kernel_size, stride=1)
    return x - mean, mean
