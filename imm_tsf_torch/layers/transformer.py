"""TSLib-style transformer blocks (after imm_tsf_tpu/layers/transformer.py):
FullAttention / AttentionLayer / EncoderLayer / ConvLayer (Informer's
distilling conv, with a flax-semantics BatchNorm) / Encoder /
DecoderLayer / Decoder.

Attention is plain torch (einsum + the safe masked_softmax). The FFN of
EncoderLayer (conv1 -> act -> dropout -> conv2 -> dropout -> residual ->
norm2) and of DecoderLayer (the same, ending in norm3) runs through
kernels/ffn.py (`_ffn`, after the JAX package's `_ffn_fused_apply`,
:114-142): the fused CUDA kernel when `use_fused_ffn` is set
(cfg.use_pallas and cfg.use_fused_ffn), its plain version otherwise. Both
read the same conv1/conv2/norm parameters, so the state dict is identical
either way, and both train: in train mode the FFN's two hash-dropout
sites take one [2, 2] salt pair a forward from the layer's dropout
generator, drawn the same way on both routes, so with one seed the routes
train under identical masks. (The JAX package's two routes draw
different streams, transformer.py:150-152; its unfused route's masks are
those of `_keep_mask` over the flattened [M, F] and [M, D], which the
plain route computes.)
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ffn import ffn_reference, fused_encoder_ffn
from ..models.base import dense, variance_scaling_
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
        self.query_projection = dense(d_model, d_k * n_heads)
        self.key_projection = dense(d_model, d_k * n_heads)
        self.value_projection = dense(d_model, d_k * n_heads)
        self.out_projection = dense(d_k * n_heads, d_model)

    def forward(self, queries, keys, values, attn_mask=None):
        B, L, _ = queries.shape
        S = keys.shape[1]
        H = self.n_heads
        q = self.query_projection(queries).reshape(B, L, H, -1)
        k = self.key_projection(keys).reshape(B, S, H, -1)
        v = self.value_projection(values).reshape(B, S, H, -1)
        out = self.inner(q, k, v, attn_mask=attn_mask).reshape(B, L, -1)
        return self.out_projection(out)


def _ffn(layer: nn.Module, x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """The layer's FFN with residual and `norm` over x [..., D], on the
    fused kernel's route when layer.use_fused_ffn (on a CUDA tensor it
    launches kernel #2 or raises), its plain version otherwise. In train
    mode with dropout, one [2, 2] salt pair from the layer's dropout
    generator: rows are the hidden site's salts and the output site's."""
    apply_dropout = layer.training and layer.dropout.rate > 0
    salts = None
    if apply_dropout:
        salts = torch.tensor([draw_salts(layer.dropout.generator),
                              draw_salts(layer.dropout.generator)])
    ffn = fused_encoder_ffn if layer.use_fused_ffn else ffn_reference
    lead, D = x.shape[:-1], x.shape[-1]
    out = ffn(x.reshape(-1, D), layer.conv1.weight.t(), layer.conv1.bias,
              layer.conv2.weight.t(), layer.conv2.bias, norm.weight, norm.bias, salts,
              1.0 - layer.dropout.rate, layer.activation, apply_dropout)
    return out.reshape(*lead, D)


class EncoderLayer(nn.Module):
    """post-norm attention + pointwise conv FFN
    (reference Transformer_EncDec.py:27-52)."""

    def __init__(self, attention: nn.Module, d_model: int,
                 d_ff: int | None = None, dropout: float = 0.1,
                 activation: str = "gelu", use_fused_ffn: bool = False):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.attention = attention
        self.conv1 = dense(d_model, d_ff)
        self.conv2 = dense(d_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = Dropout(dropout)
        # flax: nn.relu for "relu", nn.gelu (tanh form) for anything else
        self.activation = "relu" if activation == "relu" else "gelu"
        self.use_fused_ffn = use_fused_ffn

    def forward(self, x, attn_mask=None):
        x = self.norm1(x + self.dropout(self.attention(x, x, x, attn_mask=attn_mask)))
        return _ffn(self, x, self.norm2)


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(momentum=0.9, epsilon=1e-5) over the channel axis 1
    of [B, C, L] (flax: the last axis of [B, L, C]; statistics over B x L
    either way). Train mode normalises with the batch statistics (the
    biased variance E[x^2] - E[x]^2, clipped at 0, as flax computes it) and
    updates the running buffers r = 0.9 r + 0.1 stat; eval reads them.
    torch's BatchNorm1d would store the unbiased variance and decay the
    other way."""

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 2))
            var = ((x * x).mean(dim=(0, 2)) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None]) * mul[:, None] + self.bias[:, None]


class ConvLayer(nn.Module):
    """Informer's distilling conv: circular conv k3 pad 2 + BatchNorm + ELU
    + max-pool k3 s2 p1 (reference Transformer_EncDec.py:6-24):
    [B, L, D] -> [B, (L + 1)//2 + 1, D]. jnp.pad(mode="wrap") by 2 and a
    VALID conv is torch's circular padding 2 (L + 2 rows); the pool pads
    with -inf as the JAX reduce_window does."""

    def __init__(self, c_in: int):
        super().__init__()
        self.downConv = nn.utils.skip_init(nn.Conv1d, c_in, c_in, 3, padding=2,
                                           padding_mode="circular")
        variance_scaling_(self.downConv.weight, 1.0, 3 * c_in)  # flax Conv's lecun normal
        with torch.no_grad():
            self.downConv.bias.zero_()
        self.norm = BatchNorm(c_in)

    def forward(self, x):
        x = self.norm(self.downConv(x.permute(0, 2, 1)))
        x = F.max_pool1d(F.elu(x), 3, 2, padding=1)
        return x.permute(0, 2, 1)


class Encoder(nn.Module):
    """Stack of EncoderLayers with optional distil ConvLayers (one fewer
    than the layers) and a final norm (reference Transformer_EncDec.py:54-81).
    With distil the last layer runs without attn_mask, as in the JAX
    package (:218)."""

    def __init__(self, layers, d_model: int, conv_layers=None, use_norm: bool = True):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.conv_layers = nn.ModuleList(conv_layers) if conv_layers is not None else None
        self.norm = nn.LayerNorm(d_model, eps=1e-5) if use_norm else None

    def forward(self, x, attn_mask=None):
        if self.conv_layers is not None:
            for layer, conv in zip(self.layers, self.conv_layers):
                x = conv(layer(x, attn_mask=attn_mask))
            x = self.layers[-1](x)
        else:
            for layer in self.layers:
                x = layer(x, attn_mask=attn_mask)
        return self.norm(x) if self.norm is not None else x


class DecoderLayer(nn.Module):
    """self-attention + cross-attention + the FFN, each post-norm
    (reference Transformer_EncDec.py:83-117); the FFN ends in norm3 and
    takes the fused kernel's route as EncoderLayer's does."""

    def __init__(self, self_attention: nn.Module, cross_attention: nn.Module,
                 d_model: int, d_ff: int | None = None, dropout: float = 0.1,
                 activation: str = "gelu", use_fused_ffn: bool = False):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.self_attention, self.cross_attention = self_attention, cross_attention
        self.conv1 = dense(d_model, d_ff)
        self.conv2 = dense(d_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = Dropout(dropout)
        self.activation = "relu" if activation == "relu" else "gelu"
        self.use_fused_ffn = use_fused_ffn

    def forward(self, x, cross, x_mask=None, cross_mask=None):
        x = self.norm1(x + self.dropout(self.self_attention(x, x, x, attn_mask=x_mask)))
        x = self.norm2(x + self.dropout(
            self.cross_attention(x, cross, cross, attn_mask=cross_mask)))
        return _ffn(self, x, self.norm3)


class Decoder(nn.Module):
    """DecoderLayers, a final norm and an optional projection
    (reference Transformer_EncDec.py:119-135)."""

    def __init__(self, layers, d_model: int, use_norm: bool = True,
                 projection_dim: int | None = None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(d_model, eps=1e-5) if use_norm else None
        self.projection = (dense(d_model, projection_dim)
                           if projection_dim is not None else None)

    def forward(self, x, cross, x_mask=None, cross_mask=None):
        for layer in self.layers:
            x = layer(x, cross, x_mask=x_mask, cross_mask=cross_mask)
        if self.norm is not None:
            x = self.norm(x)
        return self.projection(x) if self.projection is not None else x
