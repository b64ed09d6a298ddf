"""DLinear — decomposition-linear forecaster, irregular-adapted (after
imm_tsf_tpu/models/dlinear.py; reference models/DLinear.py:7-134): masked
normalization, moving-average series decomposition, three linear maps
(seasonal / trend / time-channel) from seq_len to pred_len whose weights
start at 1/seq_len (torch's default bias init), de-normalization on the
horizon."""

from __future__ import annotations

import torch
from torch import nn

from ..config import Config
from ..layers.decomp import series_decomp
from .base import masked_norm, pad_time


def _linear(seq_len: int, pred_len: int) -> nn.Linear:
    # the reference overrides only the weights (models/DLinear.py:36-51)
    lin = nn.Linear(seq_len, pred_len)
    nn.init.constant_(lin.weight, 1.0 / seq_len)
    return lin


class DLinear(nn.Module):
    """individual: one linear map a channel (`seasonal_<i>`, `trend_<i>`,
    `time_<i>`) instead of one shared by all channels."""

    def __init__(self, cfg: Config, individual: bool = False):
        super().__init__()
        self.cfg, self.individual = cfg, individual
        seq_len, pred_len, C = cfg.input_len, cfg.pred_len, cfg.input_dim
        names = ("seasonal", "trend", "time")
        if individual:
            for name in names:
                for i in range(C):
                    setattr(self, f"{name}_{i}", _linear(seq_len, pred_len))
        else:
            for name in names:
                setattr(self, name, _linear(seq_len, pred_len))

    def _map(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """[B, C, seq_len] -> [B, C, pred_len] through `name`'s map(s)."""
        if self.individual:
            return torch.stack([getattr(self, f"{name}_{i}")(x[:, i])
                                for i in range(x.shape[1])], dim=1)
        return getattr(self, name)(x)

    def forward(self, tp_to_predict, observed_data, observed_tp, observed_mask):
        cfg = self.cfg
        seq_len, C = cfg.input_len, cfg.input_dim
        observed_data = pad_time(observed_data, seq_len)
        observed_mask = pad_time(observed_mask, seq_len)
        observed_tp = pad_time(observed_tp, seq_len)
        Lp = tp_to_predict.shape[1]

        x, means, stdev = masked_norm(observed_data, observed_mask)
        seasonal, trend = series_decomp(x, cfg.moving_avg)  # [B, L, C]
        time = observed_tp[:, None, :].expand(-1, C, -1)  # [B, C, L]
        dec = (self._map("seasonal", seasonal.permute(0, 2, 1))
               + self._map("trend", trend.permute(0, 2, 1))
               + self._map("time", time)).permute(0, 2, 1)  # [B, pred_len, C]
        dec = dec * stdev + means
        return dec[:, :Lp, :]
