"""TimesNet — FFT-period 2-D-variation model, irregular-adapted (after
imm_tsf_tpu/models/timesnet.py; reference models/TimesNet.py:9-152):
normalization, DataEmbedding over (value, mask, time) channels, the
predict-time tokens, predict_linear over the time axis, TimesBlocks with
one LayerNorm shared by all of them, the projection and de-normalization.

A TimesBlock takes the k frequency bins of largest batch- and
channel-mean amplitude (lax.top_k's order), folds the series into a
[ceil(T / p), p] grid for each bin's period p, runs two inception
convolutions on it and sums the k results under a softmax of their
amplitudes. This port computes only the k selected periods, as the
reference model does, with a host round trip for the bins. The JAX
package runs every candidate period in shape-bucketed canvases and
gathers the k selected ones (its TPU rewrite); unselected branches never
reach its output, so the values and gradients are the same.

The inception block (kernels 1, 3, ..., 2K-1, SAME padding, their mean)
is one (2K-1)-square conv2d of the mean of the centre-embedded kernels,
as the JAX package's `_apply_inception` fuses it. Its parameters keep
the flax leaves `conv{1,2}_kernel_<i>` [k, k, in, out] and
`conv{1,2}_bias_<i>`; the fused kernel goes to torch's [out, in, kh, kw]
by permute(3, 2, 0, 1) (a layout change, no flip).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..layers.decomp import fft_dtype
from ..layers.embed import DataEmbedding
from .base import dense, pad_time, variance_scaling_
from .timellm import top_lags


def f_to_period(f: int, T: int) -> int:
    """The period of frequency bin f over T steps; T for the DC bin
    (imm_tsf_tpu/models/timesnet.py:169-170)."""
    return T // f if f else T


class TimesBlock(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.k, self.num_kernels = cfg.top_k, cfg.num_kernels
        self._init_inception("conv1", cfg.d_model, cfg.d_ff)
        self._init_inception("conv2", cfg.d_ff, cfg.d_model)

    def _init_inception(self, name: str, c_in: int, c_out: int) -> None:
        """The flax leaves `<name>_kernel_<i>` [k, k, in, out] (kaiming
        normal, k = 2i + 1) and `<name>_bias_<i>` (zeros) (reference
        layers/Conv_Blocks.py:5-30)."""
        for i in range(self.num_kernels):
            k = 2 * i + 1
            w = torch.empty(k, k, c_in, c_out)
            variance_scaling_(w, 2.0, k * k * c_in)
            self.register_parameter(f"{name}_kernel_{i}", nn.Parameter(w))
            self.register_parameter(f"{name}_bias_{i}", nn.Parameter(torch.zeros(c_out)))

    def _inception(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The mean of SAME 2-D convs with kernels 1, 3, ..., 2K-1 over x
        [B, C_in, H, W], as one conv whose kernel is the mean of the
        centre-embedded ones (the JAX package's `_apply_inception`)."""
        n = self.num_kernels
        kernels = [getattr(self, f"{name}_kernel_{i}") for i in range(n)]
        kmax = kernels[-1].shape[0]
        w = sum(F.pad(k, (0, 0, 0, 0, *(((kmax - k.shape[0]) // 2,) * 4))) for k in kernels)
        b = sum(getattr(self, f"{name}_bias_{i}") for i in range(n))
        return F.conv2d(x, (w / n).permute(3, 2, 0, 1), b / n, padding=kmax // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, N]
        B, T, N = x.shape
        amp = torch.fft.rfft(x.to(fft_dtype(x.dtype)), dim=1).abs()  # [B, F, N]
        freq = amp.mean(dim=0).mean(dim=-1).detach()  # [F]; the choice has no gradient
        freq[0] = 0.0
        top = top_lags(freq[None], self.k)[0]
        period_weight = amp.mean(dim=-1)[:, top].to(x.dtype)  # [B, k]
        res = []
        for f in top.tolist():
            p = f_to_period(f, T)
            rows = -(-T // p)
            grid = F.pad(x, (0, 0, 0, rows * p - T)).reshape(B, rows, p, N).permute(0, 3, 1, 2)
            out = self._inception("conv2", F.gelu(self._inception("conv1", grid),
                                                  approximate="tanh"))
            res.append(out.permute(0, 2, 3, 1).reshape(B, rows * p, N)[:, :T])
        pw = torch.softmax(period_weight, dim=1)  # [B, k]
        return (torch.stack(res, dim=-1) * pw[:, None, None, :]).sum(dim=-1) + x


class TimesNet(nn.Module):
    # the epoch loop runs its steps eagerly (training/graphs.eager_reason):
    # a CUDA graph would freeze the periods of the captured batch
    eager_steps = "TimesBlock picks its periods on the host (top.tolist())"

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        total = cfg.input_len + cfg.pred_len
        self.enc_embedding = DataEmbedding(2 * cfg.input_dim + 1, cfg.d_model, cfg.dropout)
        self.predict_linear = dense(total, total)
        for i in range(cfg.e_layers):
            setattr(self, f"times_block_{i}", TimesBlock(cfg))
        # one LayerNorm after every block (reference models/TimesNet.py:88,135)
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)
        self.projection = dense(cfg.d_model, cfg.input_dim)

    def forward(self, tp_to_predict, observed_data, observed_tp, observed_mask):
        cfg = self.cfg
        seq_len, pred_len = cfg.input_len, cfg.pred_len
        observed_data = pad_time(observed_data, seq_len)
        observed_mask = pad_time(observed_mask, seq_len)
        observed_tp = pad_time(observed_tp, seq_len)
        Lp = tp_to_predict.shape[1]
        tp_to_predict = pad_time(tp_to_predict, pred_len)

        means = observed_data.mean(dim=1, keepdim=True)
        x_enc = observed_data - means
        stdev = torch.sqrt(x_enc.var(dim=1, keepdim=True, unbiased=False) + 1e-5)
        x_enc = torch.cat([x_enc / stdev, observed_mask, observed_tp[:, :, None]], dim=-1)

        enc_out = self.enc_embedding(x_enc)  # [B, L, d_model]
        tp_rep = tp_to_predict[:, :, None].expand(-1, -1, cfg.d_model)
        enc_out = torch.cat([enc_out, tp_rep], dim=1)  # [B, L + Lp, d_model]
        enc_out = self.predict_linear(enc_out.transpose(1, 2)).transpose(1, 2)
        for i in range(cfg.e_layers):
            enc_out = self.layer_norm(getattr(self, f"times_block_{i}")(enc_out))

        dec_out = self.projection(enc_out) * stdev + means
        return dec_out[:, -pred_len:][:, :Lp]
