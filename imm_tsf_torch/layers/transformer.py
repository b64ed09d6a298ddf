"""TSLib-style encoder blocks (after imm_tsf_tpu/layers/transformer.py):
FullAttention / AttentionLayer / EncoderLayer / Encoder.

Attention is plain torch (einsum + the safe masked_softmax). The
encoder FFN (conv1 -> act -> dropout -> conv2 -> dropout -> residual ->
norm2) runs through kernels/ffn.py: the fused CUDA kernel when
`use_fused_ffn` is set (cfg.use_pallas and cfg.use_fused_ffn), its plain
version otherwise. Both read the same conv1/conv2/norm2 parameters, so
the state dict is identical either way, and both train: in train mode
the FFN's two hash-dropout sites take one [2, 2] salt pair a forward from
the layer's dropout generator, drawn the same way on both routes, so
with one seed the routes train under identical masks. (The JAX package's
two routes draw different streams, transformer.py:150-152; its unfused
route's masks are those of `_keep_mask` over the flattened [M, F] and
[M, D], which the plain route computes.)
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.ffn import ffn_reference, fused_encoder_ffn
from .attention import masked_softmax
from .fast_dropout import Dropout, draw_salts


class FullAttention(nn.Module):
    """Scaled dot-product over [B, L, H, E]-shaped q/k/v
    (reference SelfAttention_Family.py:50-78)."""

    def __init__(self, mask_flag: bool = False, scale: float | None = None,
                 attention_dropout: float = 0.1):
        super().__init__()
        self.mask_flag, self.scale = mask_flag, scale
        self.dropout = Dropout(attention_dropout)

    def forward(self, queries, keys, values, attn_mask=None):
        B, L, H, E = queries.shape
        S = keys.shape[1]
        scale = self.scale or 1.0 / math.sqrt(E)
        scores = torch.einsum("blhe,bshe->bhls", queries, keys)
        mask = None
        if self.mask_flag:
            mask = torch.ones((L, S), dtype=torch.bool,
                              device=queries.device).tril()[None, None]
        if attn_mask is not None:
            mask = attn_mask if mask is None else (mask & attn_mask)
        A = self.dropout(masked_softmax(scale * scores, mask))
        return torch.einsum("bhls,bshd->blhd", A, values)


class AttentionLayer(nn.Module):
    """q/k/v/out projections around an inner attention
    (reference SelfAttention_Family.py:181-216)."""

    def __init__(self, inner: nn.Module, d_model: int, n_heads: int):
        super().__init__()
        self.inner, self.n_heads = inner, n_heads
        d_k = d_model // n_heads
        self.query_projection = nn.Linear(d_model, d_k * n_heads)
        self.key_projection = nn.Linear(d_model, d_k * n_heads)
        self.value_projection = nn.Linear(d_model, d_k * n_heads)
        self.out_projection = nn.Linear(d_k * n_heads, d_model)

    def forward(self, queries, keys, values, attn_mask=None):
        B, L, _ = queries.shape
        S = keys.shape[1]
        H = self.n_heads
        q = self.query_projection(queries).reshape(B, L, H, -1)
        k = self.key_projection(keys).reshape(B, S, H, -1)
        v = self.value_projection(values).reshape(B, S, H, -1)
        out = self.inner(q, k, v, attn_mask=attn_mask).reshape(B, L, -1)
        return self.out_projection(out)


class EncoderLayer(nn.Module):
    """post-norm attention + pointwise conv FFN
    (reference Transformer_EncDec.py:27-52)."""

    def __init__(self, attention: nn.Module, d_model: int,
                 d_ff: int | None = None, dropout: float = 0.1,
                 activation: str = "gelu", use_fused_ffn: bool = False):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.attention = attention
        self.conv1 = nn.Linear(d_model, d_ff)
        self.conv2 = nn.Linear(d_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = Dropout(dropout)
        # flax: nn.relu for "relu", nn.gelu (tanh form) for anything else
        self.activation = "relu" if activation == "relu" else "gelu"
        self.use_fused_ffn = use_fused_ffn

    def forward(self, x, attn_mask=None):
        x = self.norm1(x + self.dropout(self.attention(x, x, x, attn_mask=attn_mask)))
        apply_dropout = self.training and self.dropout.rate > 0
        salts = None
        if apply_dropout:  # rows: the hidden site's salts, the output site's
            salts = torch.tensor([draw_salts(self.dropout.generator),
                                  draw_salts(self.dropout.generator)])
        ffn = fused_encoder_ffn if self.use_fused_ffn else ffn_reference
        lead, D = x.shape[:-1], x.shape[-1]
        out = ffn(x.reshape(-1, D), self.conv1.weight.t(), self.conv1.bias,
                  self.conv2.weight.t(), self.conv2.bias, self.norm2.weight,
                  self.norm2.bias, salts, 1.0 - self.dropout.rate,
                  self.activation, apply_dropout)
        return out.reshape(*lead, D)


class Encoder(nn.Module):
    """Stack of EncoderLayers and a final norm
    (reference Transformer_EncDec.py:54-81; no distil ConvLayers yet)."""

    def __init__(self, layers, d_model: int, use_norm: bool = True):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(d_model, eps=1e-5) if use_norm else None

    def forward(self, x, attn_mask=None):
        for layer in self.layers:
            x = layer(x, attn_mask=attn_mask)
        return self.norm(x) if self.norm is not None else x
