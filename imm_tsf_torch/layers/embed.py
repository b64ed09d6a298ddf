"""Embedding layers (after imm_tsf_tpu/layers/embed.py): the positional
table and the patch embedding PatchTST uses."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

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
        self._pe: dict = {}  # (P, device) -> [1, P, d_model] table

    def _pe_table(self, P: int, device: torch.device) -> torch.Tensor:
        key = (P, str(device))
        if key not in self._pe:
            self._pe[key] = sinusoidal_pe(P, self.d_model).to(device)
        return self._pe[key]

    def forward(self, x: torch.Tensor):
        B, C, L = x.shape
        # jnp.pad(mode="edge") on the last axis == torch "replicate"
        x = F.pad(x, (0, self.padding), mode="replicate")
        x = unfold_patches(x, self.patch_len, self.stride)  # [B, C, P, plen]
        P = x.shape[2]
        x = x.reshape(B * C, P, self.patch_len)
        x = self.value_embedding(x) + self._pe_table(P, x.device)
        return self.dropout(x), C
