"""TimeMixer — multiscale decomposable mixing, irregular-adapted (after
imm_tsf_tpu/models/timemixer.py; reference models/TimeMixer.py:100-326):
masked normalization, (value, mask, time) channels, avg / max / conv
downsampling with the layer count clamped to what the length supports,
one DataEmbedding shared across scales, PastDecomposableMixing blocks
(moving-average or DFT decomposition, bottom-up season mixing, top-down
trend mixing) and a prediction from the coarsest scale only."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..layers.decomp import dft_decomp, series_decomp
from ..layers.embed import DataEmbedding
from .base import dense, masked_norm, pad_time, variance_scaling_


def clamp_down_layers(input_len: int, down_w: int, requested: int) -> int:
    """Only as many scales as the length supports (reference :176-184)."""
    max_layers, cur = 0, input_len
    while max_layers < requested and cur >= down_w:
        cur //= down_w
        max_layers += 1
    return max_layers


class _TimeMLP(nn.Module):
    """Linear(in -> hidden) + GELU + Linear(hidden -> out) over the last
    axis: the season / trend time mixers (hidden = out) and the cross / out
    feature layers (hidden = d_ff)."""

    def __init__(self, t_in: int, t_out: int, hidden: int | None = None):
        super().__init__()
        self.fc1 = dense(t_in, hidden or t_out)
        self.fc2 = dense(hidden or t_out, t_out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


def _scale_lengths(cfg: Config, down_layers: int) -> list[int]:
    """The time length of each scale: the pools floor L / w, the stride-w
    SAME conv rounds up."""
    lengths = [cfg.input_len]
    for _ in range(down_layers):
        L, w = lengths[-1], cfg.down_sampling_window
        lengths.append(-(-L // w) if cfg.down_sampling_method == "conv" else L // w)
    return lengths


class PastDecomposableMixing(nn.Module):
    def __init__(self, cfg: Config, lengths: list[int]):
        super().__init__()
        self.cfg, self.down_layers = cfg, len(lengths) - 1
        seq_len, w = cfg.input_len, cfg.down_sampling_window
        if not cfg.channel_independence:
            # the JAX package defines cross_layer once for each scale, and
            # flax refuses the second definition (NameInUseError)
            if self.down_layers:
                raise ValueError(
                    "TimeMixer with channel_independence=0 runs one scale only "
                    f"(down_sampling_layers resolves to {self.down_layers}): the JAX "
                    "package's PastDecomposableMixing names one cross_layer a scale, which "
                    "flax refuses")
            self.cross_layer = _TimeMLP(cfg.d_model, cfg.d_model, hidden=cfg.d_ff)
        for i in range(self.down_layers):
            setattr(self, f"season_down_{i}", _TimeMLP(lengths[i], seq_len // w ** (i + 1)))
        for j, i in enumerate(reversed(range(self.down_layers))):
            setattr(self, f"trend_up_{j}", _TimeMLP(lengths[i + 1], seq_len // w ** i))
        self.out_layer = _TimeMLP(cfg.d_model, cfg.d_model, hidden=cfg.d_ff)

    def forward(self, x_list: list[torch.Tensor]) -> list[torch.Tensor]:
        cfg = self.cfg
        seasons, trends = [], []
        for x in x_list:  # [B, T_i, d_model]
            if cfg.decomp_method == "moving_avg":
                s, t = series_decomp(x, cfg.moving_avg)
            else:
                s, t = dft_decomp(x, cfg.top_k)
            if not cfg.channel_independence:
                s, t = self.cross_layer(s), self.cross_layer(t)
            seasons.append(s.transpose(1, 2))  # [B, d_model, T_i]
            trends.append(t.transpose(1, 2))

        # bottom-up season mixing (reference :30-63)
        out_high = seasons[0]
        out_seasons = [out_high.transpose(1, 2)]
        out_low = seasons[1] if len(seasons) > 1 else None
        for i in range(self.down_layers):
            out_low = out_low + getattr(self, f"season_down_{i}")(out_high)
            out_high = out_low
            if i + 2 < len(seasons):
                out_low = seasons[i + 2]
            out_seasons.append(out_high.transpose(1, 2))

        # top-down trend mixing (reference :66-97)
        rev = trends[::-1]
        out_low = rev[0]
        out_trends = [out_low.transpose(1, 2)]
        out_high = rev[1] if len(rev) > 1 else None
        for j in range(self.down_layers):
            out_high = out_high + getattr(self, f"trend_up_{j}")(out_low)
            out_low = out_high
            if j + 2 < len(rev):
                out_high = rev[j + 2]
            out_trends.append(out_low.transpose(1, 2))
        out_trends = out_trends[::-1]

        return [(orig + self.out_layer(s + t))[:, :orig.shape[1]]
                for orig, s, t in zip(x_list, out_seasons, out_trends)]


class TimeMixer(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        C = cfg.input_dim
        self.down_layers = clamp_down_layers(cfg.input_len, cfg.down_sampling_window,
                                             cfg.down_sampling_layers)
        lengths = _scale_lengths(cfg, self.down_layers)
        if cfg.down_sampling_method == "conv":  # flax Conv names: down_conv_1 ...
            for i in range(1, self.down_layers + 1):
                conv = nn.utils.skip_init(nn.Conv1d, 2 * C + 1, 2 * C + 1, 3,
                                          stride=cfg.down_sampling_window, bias=False)
                variance_scaling_(conv.weight, 1.0, 3 * (2 * C + 1))  # flax's lecun normal
                setattr(self, f"down_conv_{i}", conv)
        self.enc_embedding = DataEmbedding(2 * C + 1, cfg.d_model, cfg.dropout)
        for b in range(cfg.e_layers):
            setattr(self, f"pdm_block_{b}", PastDecomposableMixing(cfg, lengths))
        self.predict_layer = dense(lengths[-1], cfg.pred_len)
        self.projection = dense(cfg.d_model, C)

    def _down(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Scale i - 1 -> scale i, [B, T, C] -> [B, T', C]."""
        w, method = self.cfg.down_sampling_window, self.cfg.down_sampling_method
        x = x.transpose(1, 2)
        if method == "max":
            x = F.max_pool1d(x, w, w)
        elif method == "conv":
            # the JAX package's wrap pad by one, cut off again, is the identity;
            # then flax's SAME padding for stride w: the odd element at the end
            L = x.shape[-1]
            total = max((-(-L // w) - 1) * w + 3 - L, 0)
            x = getattr(self, f"down_conv_{i}")(F.pad(x, (total // 2, total - total // 2)))
        else:
            x = F.avg_pool1d(x, w, w)
        return x.transpose(1, 2)

    def forward(self, tp_to_predict, observed_data, observed_tp, observed_mask):
        cfg = self.cfg
        seq_len = cfg.input_len
        observed_data = pad_time(observed_data, seq_len)
        observed_mask = pad_time(observed_mask, seq_len)
        observed_tp = pad_time(observed_tp, seq_len)
        Lp = tp_to_predict.shape[1]

        x, means, stdev = masked_norm(observed_data, observed_mask)
        cur = torch.cat([x, observed_mask, observed_tp[:, :, None]], dim=-1)  # [B, L, 2C+1]
        x_list = [cur]
        for i in range(1, self.down_layers + 1):
            cur = self._down(cur, i)
            x_list.append(cur)

        enc_out_list = [self.enc_embedding(xi) for xi in x_list]
        for b in range(cfg.e_layers):
            enc_out_list = getattr(self, f"pdm_block_{b}")(enc_out_list)

        # predict from the coarsest scale only (reference :318-322)
        dec = self.predict_layer(enc_out_list[-1].transpose(1, 2)).transpose(1, 2)
        dec = self.projection(dec) * stdev + means
        return dec[:, :Lp]
