"""Embedding layers (after imm_tsf_tpu/layers/embed.py): the positional
table, the circular token conv and the data embedding (Informer), and the
patch embedding (PatchTST)."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from ..models.base import pad_edge, variance_scaling_
from .fast_dropout import Dropout


def sinusoidal_pe(L: int, d_model: int) -> torch.Tensor:
    """[1, L, d_model] classic sin/cos table (reference Embed.py:8-26),
    computed in float32 NumPy exactly as the JAX package does."""
    position = np.arange(L, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model)
    )
    pe = np.zeros((L, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term[: pe[:, 1::2].shape[1]])
    return torch.from_numpy(pe[None])


@functools.lru_cache(maxsize=64)
def pe_table(L: int, d_model: int, device: torch.device) -> torch.Tensor:
    """sinusoidal_pe(L, d_model) on `device`, made once (read only; a normal
    tensor even when first made under inference mode, so training can use
    it)."""
    with torch.inference_mode(False):
        return sinusoidal_pe(L, d_model).to(device)


class TokenEmbedding(nn.Module):
    """Circular kernel-3 conv over time, no bias (reference Embed.py:29-43):
    [B, L, C] -> [B, L, d_model]. jnp.pad(mode="wrap") by 1 and a VALID
    conv is torch's circular padding 1."""

    def __init__(self, c_in: int, d_model: int):
        super().__init__()
        self.tokenConv = nn.utils.skip_init(nn.Conv1d, c_in, d_model, 3, padding=1,
                                            padding_mode="circular", bias=False)
        # flax's kaiming_normal: truncated at 2 sigma, variance 2 / fan_in
        variance_scaling_(self.tokenConv.weight, 2.0, 3 * c_in)

    def forward(self, x):
        return self.tokenConv(x.permute(0, 2, 1)).permute(0, 2, 1)


class TimeFeatureEmbedding(nn.Module):
    def __init__(self, d_inp: int, d_model: int):
        super().__init__()
        self.embed = nn.Linear(d_inp, d_model, bias=False)

    def forward(self, x_mark):
        return self.embed(x_mark)


class DataEmbedding(nn.Module):
    """token conv + positional (+ timeF temporal when `d_mark` is given and
    x_mark passed) + dropout (reference Embed.py:109-127)."""

    def __init__(self, c_in: int, d_model: int, dropout: float = 0.1,
                 d_mark: int | None = None):
        super().__init__()
        self.d_model = d_model
        self.value_embedding = TokenEmbedding(c_in, d_model)
        self.temporal_embedding = (TimeFeatureEmbedding(d_mark, d_model)
                                   if d_mark is not None else None)
        self.dropout = Dropout(dropout)

    def forward(self, x, x_mark=None):
        out = self.value_embedding(x) + pe_table(x.shape[1], self.d_model, x.device)
        if x_mark is not None:
            out = out + self.temporal_embedding(x_mark)
        return self.dropout(out)


def unfold_patches(x: torch.Tensor, patch_len: int, stride: int) -> torch.Tensor:
    """torch .unfold over the last axis: [.., L] -> [.., P, patch_len] with
    P = (L - patch_len)//stride + 1."""
    return x.unfold(-1, patch_len, stride)


class PatchEmbedding(nn.Module):
    """Replication-pad right by `padding`, unfold, linear (no bias) + PE +
    dropout (reference Embed.py:165-190). Input [B, C, L];
    returns ([B*C, P, d_model], n_vars)."""

    def __init__(self, d_model: int, patch_len: int, stride: int,
                 padding: int, dropout: float = 0.1):
        super().__init__()
        self.d_model, self.patch_len = d_model, patch_len
        self.stride, self.padding = stride, padding
        self.value_embedding = nn.Linear(patch_len, d_model, bias=False)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor):
        B, C, L = x.shape
        x = pad_edge(x, 0, self.padding)  # jnp.pad(mode="edge") on the last axis
        x = unfold_patches(x, self.patch_len, self.stride)  # [B, C, P, plen]
        P = x.shape[2]
        x = x.reshape(B * C, P, self.patch_len)
        x = self.value_embedding(x) + pe_table(P, self.d_model, x.device)
        return self.dropout(x), C
