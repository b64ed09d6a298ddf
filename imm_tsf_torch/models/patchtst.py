"""PatchTST — channel-independent patch transformer, irregular-adapted
(after imm_tsf_tpu/models/patchtst.py; reference models/PatchTST.py:25-131):
  - nonstationary (unmasked) normalization over time
  - (value, mask, time) interleaved per timestep -> sequence of 3*input_len
  - PatchEmbedding(patch_len=18, stride=9, padding=stride)
  - TSLib Encoder with FullAttention
  - FlattenHead that concatenates tp_to_predict before the final linear
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import Config
from ..layers.embed import PatchEmbedding
from ..layers.fast_dropout import Dropout
from ..layers.transformer import AttentionLayer, Encoder, EncoderLayer, FullAttention
from .base import dense, pad_time


class PatchTST(nn.Module):
    def __init__(self, cfg: Config, patch_len: int = 18, stride: int = 9):
        super().__init__()
        self.cfg = cfg
        self.patch_len, self.stride = patch_len, stride
        self.patch_embedding = PatchEmbedding(cfg.d_model, patch_len, stride,
                                              stride, cfg.dropout)
        layers = [
            EncoderLayer(
                AttentionLayer(FullAttention(False, attention_dropout=cfg.dropout),
                               cfg.d_model, cfg.n_heads),
                cfg.d_model, cfg.d_ff, dropout=cfg.dropout,
                activation=cfg.activation,
                use_fused_ffn=cfg.use_pallas and cfg.use_fused_ffn,
            )
            for _ in range(cfg.e_layers)
        ]
        self.encoder = Encoder(layers, cfg.d_model)
        P = (3 * cfg.input_len + stride - patch_len) // stride + 1
        self.head_linear = dense(cfg.d_model * P + cfg.pred_len, cfg.pred_len)
        self.head_dropout = Dropout(cfg.dropout)

    def forward(self, tp_to_predict, observed_data, observed_tp, observed_mask):
        cfg = self.cfg
        input_len, pred_len = cfg.input_len, cfg.pred_len
        seq_len = 3 * input_len

        observed_data = pad_time(observed_data, input_len)
        observed_mask = pad_time(observed_mask, input_len)
        observed_tp = pad_time(observed_tp, input_len)
        Lp = tp_to_predict.shape[1]
        tp_to_predict = pad_time(tp_to_predict, pred_len)

        B, L, K = observed_data.shape
        # nonstationary normalization (unmasked; reference :91-97); jnp.var
        # is the biased variance
        means = observed_data.mean(dim=1, keepdim=True)
        x_enc = observed_data - means
        stdev = torch.sqrt(x_enc.var(dim=1, keepdim=True, unbiased=False) + 1e-5)
        x_enc = x_enc / stdev

        # interleave (value, mask, time) along time (reference :100-101)
        tp_k = observed_tp[:, :, None].expand(B, L, K)
        x = torch.stack([x_enc, observed_mask, tp_k], dim=-1)  # [B,L,K,3]
        x = x.permute(0, 1, 3, 2).reshape(B, seq_len, K)
        x = x.permute(0, 2, 1)  # [B, K, 3L]

        enc_out, n_vars = self.patch_embedding(x)  # [B*K, P, d_model]
        enc_out = self.encoder(enc_out)
        P = enc_out.shape[1]
        enc_out = enc_out.reshape(B, n_vars, P, cfg.d_model)

        # FlattenHead (reference :8-22): flatten (d_model, P), append t_hat
        head_in = enc_out.permute(0, 1, 3, 2).reshape(B, n_vars, cfg.d_model * P)
        tp_rep = tp_to_predict[:, None, :].expand(B, n_vars, pred_len)
        head_in = torch.cat([head_in, tp_rep], dim=-1)
        dec_out = self.head_dropout(self.head_linear(head_in))
        dec_out = dec_out.permute(0, 2, 1)  # [B, pred_len, K]

        dec_out = dec_out * stdev[:, 0, :][:, None, :] + means[:, 0, :][:, None, :]
        return dec_out[:, :Lp, :]
