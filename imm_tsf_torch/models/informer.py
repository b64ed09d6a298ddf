"""Informer — ProbSparse encoder-decoder, irregular-adapted (after
imm_tsf_tpu/models/informer.py; reference models/Informer.py:15-184):
(value, mask, time) 2C+1-channel DataEmbedding for the encoder and the
decoder, ProbSparse attention, distilling ConvLayers between the encoder
layers, decoder input = zero values + zero mask + future timestamps,
masked normalization / de-normalization.

The FFN of each encoder and decoder layer runs kernel #2 on the kernel
route (cfg.use_pallas and cfg.use_fused_ffn): e_layers + d_layers
launches a forward.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import Config
from ..layers.embed import DataEmbedding
from ..layers.prob_attention import ProbAttention
from ..layers.transformer import (AttentionLayer, ConvLayer, Decoder, DecoderLayer, Encoder,
                                  EncoderLayer)
from .base import masked_norm, pad_time


class Informer(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        C, d = cfg.input_dim, cfg.d_model
        fused = cfg.use_pallas and cfg.use_fused_ffn
        prob = lambda mask_flag: AttentionLayer(
            ProbAttention(mask_flag, cfg.factor, attention_dropout=cfg.dropout), d, cfg.n_heads)
        self.enc_embedding = DataEmbedding(2 * C + 1, d, cfg.dropout)
        self.dec_embedding = DataEmbedding(2 * C + 1, d, cfg.dropout)
        self.encoder = Encoder(
            [EncoderLayer(prob(False), d, cfg.d_ff, dropout=cfg.dropout,
                          activation=cfg.activation, use_fused_ffn=fused)
             for _ in range(cfg.e_layers)], d,
            conv_layers=[ConvLayer(d) for _ in range(cfg.e_layers - 1)] if cfg.distil else None)
        self.decoder = Decoder(
            [DecoderLayer(prob(True), prob(False), d, cfg.d_ff, dropout=cfg.dropout,
                          activation=cfg.activation, use_fused_ffn=fused)
             for _ in range(cfg.d_layers)], d, projection_dim=C)

    def forward(self, tp_to_predict, observed_data, observed_tp, observed_mask):
        cfg = self.cfg
        seq_len, pred_len, C = cfg.input_len, cfg.pred_len, cfg.input_dim
        observed_data = pad_time(observed_data, seq_len)
        observed_mask = pad_time(observed_mask, seq_len)
        observed_tp = pad_time(observed_tp, seq_len)
        Lp = tp_to_predict.shape[1]
        tp_to_predict = pad_time(tp_to_predict, pred_len)
        B = observed_data.shape[0]

        x, means, stdev = masked_norm(observed_data, observed_mask)
        enc_in = torch.cat([x, observed_mask, observed_tp[:, :, None]], dim=-1)
        # values and mask of the horizon: float32 zeros, jnp.zeros' default, so
        # under amp_bf16 the decoder's input (and its token conv) is float32
        zeros = torch.zeros((B, pred_len, 2 * C), device=x.device)
        dec_in = torch.cat([zeros, tp_to_predict[:, :, None]], dim=-1)

        enc_out = self.encoder(self.enc_embedding(enc_in))
        dec_out = self.decoder(self.dec_embedding(dec_in), enc_out)
        out = dec_out * stdev + means
        return out[:, :Lp, :]
