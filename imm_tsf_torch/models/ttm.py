"""TTM — Tiny Time Mixer with adaptive patching, irregular-adapted (after
imm_tsf_tpu/models/ttm.py; reference models/TTM.py): the irregular
adapter builds 2C+1 channels (masked values, mask - 0.5, timestamps
standardized with ddof=1, :263-287), the backbone normalizes them again
(biased variance, :168-171) and unfolds patches with the DATASET stride
(:120,126, a reference quirk kept), TTMAPBlocks reshape d_model to
patches by 2^level (:11-44), an optional decoder TTMBlock, the flatten
head behind a hash dropout, and both de-normalizations."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..layers.embed import unfold_patches
from ..layers.fast_dropout import Dropout
from ..layers.ttm_mlp import TTMLayer
from .base import dense, pad_time


class TTMAPBlock(nn.Module):
    """Adaptive patching: [B, M, N, D] -> [B, M, N 2^l, D / 2^l], the
    TTMLayers, and back (reference models/TTM.py:11-44)."""

    def __init__(self, e_layers: int, d_model: int, num_patches: int, n_vars: int, mode: str,
                 level: int, dropout: float):
        super().__init__()
        self.f = 2 ** level
        self.e_layers = e_layers
        for i in range(e_layers):
            setattr(self, f"mixer_{i}", TTMLayer(d_model // self.f, num_patches * self.f,
                                                 n_vars, mode, dropout))

    def forward(self, x):
        B, M, N, D = x.shape
        x = x.reshape(B, M, N * self.f, D // self.f)
        for i in range(self.e_layers):
            x = getattr(self, f"mixer_{i}")(x)
        return x.reshape(B, M, N, D)


class TTMBlock(nn.Module):
    """AP_levels > 0: one TTMAPBlock a level, the coarsest level first
    (`ap_block_<j>` has level AP_levels - 1 - j); else e_layers TTMLayers."""

    def __init__(self, e_layers: int, AP_levels: int, d_model: int, num_patches: int,
                 n_vars: int, mode: str, dropout: float):
        super().__init__()
        if AP_levels > 0:
            self.names = [f"ap_block_{j}" for j in range(AP_levels)]
            for j, level in enumerate(reversed(range(AP_levels))):
                setattr(self, self.names[j], TTMAPBlock(e_layers, d_model, num_patches,
                                                        n_vars, mode, level, dropout))
        else:
            self.names = [f"mixer_{i}" for i in range(e_layers)]
            for name in self.names:
                setattr(self, name, TTMLayer(d_model, num_patches, n_vars, mode, dropout))

    def forward(self, x):
        for name in self.names:
            x = getattr(self, name)(x)
        return x


def num_patches(cfg: Config) -> int:
    return (max(cfg.input_len, cfg.patch_size) - cfg.patch_size) // cfg.stride + 1


class TTM(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        n_vars, N = 2 * cfg.input_dim + 1, num_patches(cfg)
        self.patcher = dense(cfg.patch_size, cfg.d_model)
        self.encoder = TTMBlock(cfg.e_layers, cfg.AP_levels, cfg.d_model, N, n_vars, cfg.mode,
                                cfg.dropout)
        d_head = cfg.d_model
        if cfg.use_decoder:
            self.decoder_adapter = dense(cfg.d_model, cfg.d_d_model)
            self.decoder = TTMBlock(cfg.d_layers, 0, cfg.d_d_model, N, n_vars, cfg.mode,
                                    cfg.dropout)
            d_head = cfg.d_d_model
        self.dropout = Dropout(cfg.dropout)
        self.base_forecast_block = dense(N * d_head, cfg.pred_len)

    def forward(self, tp_to_predict, observed_data, observed_tp, observed_mask):
        cfg = self.cfg
        C, input_len, patch_size = cfg.input_dim, cfg.input_len, cfg.patch_size
        observed_data = pad_time(observed_data, input_len)
        observed_mask = pad_time(observed_mask, input_len)
        observed_tp = pad_time(observed_tp, input_len)
        Lp = tp_to_predict.shape[1]

        vals = observed_data * observed_mask
        tp_ch = observed_tp[:, :, None]
        if cfg.use_norm:  # the adapter's masked normalization (reference :271-287)
            sums = observed_mask.sum(dim=1).clamp(min=1)  # [B, C]
            means = vals.sum(dim=1) / sums
            centered = vals - means[:, None, :]
            stdev = torch.sqrt(((centered * observed_mask) ** 2).sum(dim=1) / sums + 1e-5)
            tp_n = (tp_ch - tp_ch.mean(dim=1, keepdim=True)) / (
                tp_ch.std(dim=1, keepdim=True) + 1e-5)  # ddof=1
            x = torch.cat([centered / stdev[:, None, :], observed_mask - 0.5, tp_n], dim=-1)
            # the model's own, unmasked normalization (reference :168-171)
            m2 = x.mean(dim=1, keepdim=True)
            s2 = torch.sqrt(x.var(dim=1, keepdim=True, unbiased=False) + 1e-5)
            x = (x - m2) / s2
        else:
            x = torch.cat([vals, observed_mask, tp_ch], dim=-1)

        xt = x.transpose(1, 2)  # [B, n_vars, L]
        if xt.shape[-1] < patch_size:
            xt = F.pad(xt, (0, patch_size - xt.shape[-1]))
        h = self.patcher(unfold_patches(xt, patch_size, cfg.stride))  # [B, M, N, D]
        h = self.encoder(h)
        if cfg.use_decoder:
            h = self.decoder(self.decoder_adapter(h))

        B, M, N, D = h.shape
        y = self.base_forecast_block(self.dropout(h.reshape(B, M, N * D)))  # [B, M, pred_len]
        y_hat = y.transpose(1, 2)  # [B, pred_len, n_vars]
        if cfg.use_norm:
            y_hat = y_hat * s2 + m2
        y_data = y_hat[..., :C]
        if cfg.use_norm:
            y_data = y_data * stdev[:, None, :] + means[:, None, :]
        return y_data[:, :Lp]
