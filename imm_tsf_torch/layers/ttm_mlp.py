"""TTM (TSMixer-style) mixer blocks (after imm_tsf_tpu/layers/ttm_mlp.py;
reference layers/MLP.py:4-121): gated MLP mixing over the patch, feature
or channel axis of a [B, M, N, D] tensor, each a last-axis product after
a transpose. Every Dense has torch's uniform kernel and a zero bias, as
the JAX package draws them."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models.base import dense
from .fast_dropout import Dropout


class TTMGatedLayer(nn.Module):
    """x * softmax(attn_layer(x)) over the last axis."""

    def __init__(self, size: int):
        super().__init__()
        self.attn_layer = dense(size, size)

    def forward(self, x):
        return x * torch.softmax(self.attn_layer(x), dim=-1)


class TTMMLP(nn.Module):
    """fc1 (in -> factor * in), GELU, hash dropout, fc2, hash dropout."""

    def __init__(self, in_features: int, out_features: int, factor: int = 2,
                 dropout: float = 0.1):
        super().__init__()
        self.fc1 = dense(in_features, in_features * factor)
        self.fc2 = dense(in_features * factor, out_features)
        self.dropout1, self.dropout2 = Dropout(dropout), Dropout(dropout)

    def forward(self, x):
        x = self.dropout1(F.gelu(self.fc1(x), approximate="tanh"))
        return self.dropout2(self.fc2(x))


# the axes each mode moves last, and back (a transpose is its own inverse)
_MODE_AXES = {"patch": (2, 3), "channel": (1, 3), "feature": None}


class TTMMixerBlock(nn.Module):
    """LayerNorm over the feature axis, `mode`'s axis moved last, gated MLP,
    moved back, residual (reference layers/MLP.py:36-86)."""

    def __init__(self, d_model: int, features: int, mode: str, dropout: float = 0.1):
        super().__init__()
        self.axes = _MODE_AXES[mode]
        self.norm = nn.LayerNorm(d_model, eps=1e-5)
        self.mlp = TTMMLP(features, features, 2, dropout)
        self.gating_block = TTMGatedLayer(features)

    def forward(self, x):  # [B, M, N, D]
        y = self.norm(x)
        if self.axes:
            y = y.transpose(*self.axes)
        y = self.gating_block(self.mlp(y))
        if self.axes:
            y = y.transpose(*self.axes)
        return y + x


class TTMLayer(nn.Module):
    """Channel mixer (mode "mix_channel" only), patch mixer (more than one
    patch only), feature mixer (reference layers/MLP.py:89-121)."""

    def __init__(self, d_model: int, num_patches: int, n_vars: int, mode: str,
                 dropout: float = 0.1):
        super().__init__()
        if mode == "mix_channel":
            self.channel_feature_mixer = TTMMixerBlock(d_model, n_vars, "channel", dropout)
        if num_patches > 1:
            self.patch_mixer = TTMMixerBlock(d_model, num_patches, "patch", dropout)
        self.feature_mixer = TTMMixerBlock(d_model, d_model, "feature", dropout)

    def forward(self, x):
        for name in ("channel_feature_mixer", "patch_mixer"):
            if hasattr(self, name):
                x = getattr(self, name)(x)
        return self.feature_mixer(x)
