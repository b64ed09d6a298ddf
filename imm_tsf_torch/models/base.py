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
