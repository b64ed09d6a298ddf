"""Attention primitives (after imm_tsf_tpu/layers/attention.py): the safe
masked softmax and torch-style multi-head attention (the second fusion
pair's).

All masking is "safe": a fully masked row yields zeros instead of NaN.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .fast_dropout import Dropout


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor | None,
                   dim: int = -1) -> torch.Tensor:
    """Softmax over `dim` where mask==True positions participate.

    Fully-masked rows return all-zeros (safe), not NaN."""
    if mask is None:
        return torch.softmax(scores, dim=dim)
    neg = torch.finfo(scores.dtype).min
    scores = torch.where(mask, scores, neg)
    m = scores.amax(dim=dim, keepdim=True)
    e = torch.exp(scores - m) * mask.to(scores.dtype)
    denom = e.sum(dim=dim, keepdim=True)
    return e / torch.where(denom == 0, 1.0, denom)


class MultiHeadAttention(nn.Module):
    """torch-style multi-head attention (after imm_tsf_tpu/layers/attention.py:
    48-97): q/k/v in-projections with bias, scores divided by sqrt(Dh), the
    safe masked softmax (an all-padded key row gives zeros, not NaN),
    dropout on the weights, out-projection. q [B, Tq, E], k/v [B, Tk, E],
    key_padding_mask [B, Tk] (True = pad, as torch); returns [B, Tq, E].
    Init (init only): the in-projections xavier-uniform over the joint
    [3E, E] matrix with zero biases, the out-projection torch Linear's
    weight with a zero bias, as torch nn.MultiheadAttention."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(embed_dim, embed_dim) for _ in range(4))
        bound = math.sqrt(6.0 / (4.0 * embed_dim))
        with torch.no_grad():
            for lin in (self.q_proj, self.k_proj, self.v_proj):
                lin.weight.uniform_(-bound, bound)
            for lin in (self.q_proj, self.k_proj, self.v_proj, self.out_proj):
                lin.bias.zero_()
        self.dropout = Dropout(dropout)

    def forward(self, q, k, v, key_padding_mask=None):
        E, H = self.embed_dim, self.num_heads
        Dh = E // H
        B, Tq, _ = q.shape
        Tk = k.shape[1]
        split = lambda x, T: x.reshape(B, T, H, Dh).permute(0, 2, 1, 3)  # [B, H, T, Dh]
        q_h, k_h, v_h = split(self.q_proj(q), Tq), split(self.k_proj(k), Tk), split(self.v_proj(v), Tk)
        scores = torch.einsum("bhqd,bhkd->bhqk", q_h, k_h) / math.sqrt(Dh)
        mask = None if key_padding_mask is None else (~key_padding_mask)[:, None, None, :]
        attn = self.dropout(masked_softmax(scores, mask))
        out = torch.einsum("bhqk,bhkd->bhqd", attn, v_h).permute(0, 2, 1, 3).reshape(B, Tq, E)
        return self.out_proj(out)
