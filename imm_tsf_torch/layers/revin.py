"""RevIN / Normalize (after imm_tsf_tpu/layers/revin.py; reference
layers/StandardNorm.py:5-68): reversible instance normalization over time
with an optional affine map. The reference builds it in TimeMixer, whose
forecasting path normalizes by hand (models/base.masked_norm); the layer
is part of the public surface, so it is ported too."""

from __future__ import annotations

import torch
from torch import nn


class RevIN(nn.Module):
    """norm(x [B, L, C]) -> (x_norm, stats); denorm(x, stats) -> x. The
    variance is biased; denorm divides by weight + eps^2, as the reference
    does."""

    def __init__(self, num_features: int, eps: float = 1e-5, affine: bool = True,
                 subtract_last: bool = False, non_norm: bool = False):
        super().__init__()
        self.eps, self.affine = eps, affine
        self.subtract_last, self.non_norm = subtract_last, non_norm
        if affine:  # the flax leaves' names
            self.affine_weight = nn.Parameter(torch.ones(num_features))
            self.affine_bias = nn.Parameter(torch.zeros(num_features))

    def norm(self, x: torch.Tensor):
        if self.non_norm:
            return x, (torch.zeros_like(x[:, :1]), torch.ones_like(x[:, :1]), None)
        mean = x[:, -1:, :] if self.subtract_last else x.mean(dim=1, keepdim=True)
        stdev = torch.sqrt(x.var(dim=1, keepdim=True, unbiased=False) + self.eps)
        out = (x - mean) / stdev
        if self.affine:
            out = out * self.affine_weight + self.affine_bias
        return out, (mean, stdev, None)

    def denorm(self, x: torch.Tensor, stats) -> torch.Tensor:
        if self.non_norm:
            return x
        mean, stdev, _ = stats
        if self.affine:
            x = (x - self.affine_bias) / (self.affine_weight + self.eps * self.eps)
        return x * stdev + mean

    def forward(self, x: torch.Tensor, mode: str, stats=None):
        """mode "norm" -> (x_norm, stats); "denorm" with stats -> x."""
        if mode == "norm":
            return self.norm(x)
        if mode == "denorm":
            return self.denorm(x, stats)
        raise NotImplementedError(mode)
