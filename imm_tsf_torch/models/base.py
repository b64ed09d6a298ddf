"""Shared model utilities (after imm_tsf_tpu/models/base.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_time(x: torch.Tensor, target_len: int) -> torch.Tensor:
    """Zero-pad axis 1 (time) to target_len. x: [B, L, ...] or [B, L]."""
    L = x.shape[1]
    if L >= target_len:
        return x
    # F.pad lists (before, after) pairs from the LAST axis backwards
    pad_cfg = [0, 0] * (x.ndim - 2) + [0, target_len - L]
    return F.pad(x, pad_cfg)


def masked_norm(observed_data: torch.Tensor, observed_mask: torch.Tensor, eps: float = 1e-5):
    """Masked per-(batch, channel) standardization over time
    (reference models/DLinear.py:84-90). Returns (x, means, stdev): the
    mean and the (biased) variance over the observed values only;
    unobserved entries are zeroed first and come out as -mean/stdev."""
    x = observed_data * observed_mask
    sums = observed_mask.sum(dim=1, keepdim=True).clamp(min=1)
    means = x.sum(dim=1, keepdim=True) / sums
    x = x - means
    var = ((x * observed_mask) ** 2).sum(dim=1, keepdim=True) / sums
    stdev = torch.sqrt(var + eps)
    return x / stdev, means, stdev

