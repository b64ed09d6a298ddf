"""Shared model utilities (after imm_tsf_tpu/models/base.py), and the
initializers that draw a fresh module's tensors as flax draws the JAX
package's: `dense` and `variance_scaling_`."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


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



# std of the unit normal truncated to [-2, 2]: flax's variance_scaling
# divides by it so the truncated draw keeps the asked variance
_TRUNC_STD = 0.87962566103423978


def variance_scaling_(weight: torch.Tensor, scale: float, fan_in: int,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """flax `variance_scaling(scale, "fan_in", "truncated_normal")` in place:
    a normal truncated at two of its sigmas, scaled to variance
    scale / fan_in. scale 1 is flax's lecun_normal (a Dense's or Conv's
    default kernel), scale 2 its kaiming_normal."""
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


def dense(in_features: int, out_features: int, bias: bool = True,
          kernel: str = "torch") -> nn.Linear:
    """nn.Linear drawn as the JAX package draws a flax Dense: the bias at
    zero (flax's default), the kernel from torch's U(+-1/sqrt(in)) ("torch",
    the JAX package's `torch_linear_kernel_init`) or flax's lecun normal
    ("lecun", the Dense default)."""
    lin = nn.utils.skip_init(nn.Linear, in_features, out_features, bias=bias)
    with torch.no_grad():
        if kernel == "torch":
            bound = 1.0 / math.sqrt(in_features)
            lin.weight.uniform_(-bound, bound)
        elif kernel == "lecun":
            variance_scaling_(lin.weight, 1.0, in_features)
        else:
            raise ValueError(f"kernel must be 'torch' or 'lecun', got {kernel!r}")
        if bias:
            lin.bias.zero_()
    return lin
