"""MMF (multimodal fusion): correct the numeric forecast with the aligned
text signal (after imm_tsf_tpu/fusion/mmf.py; reference
fusions/MMF_GR_Add.py:9-61, MMF_XAttn_Add.py:10-103).

  MMF_GR_Add    — GRU residual + sigmoid gate
  MMF_XAttn_Add — cross-attention residual + fixed-kappa convex blend

Both: forward(Y_ts [B,T,C], E_txt [B,T,d_txt], M_txt [B,1]) -> [B,T,C].
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..layers.attention import MultiHeadAttention
from ..layers.fast_dropout import Dropout
from ..models.base import dense


class MMF_GR_Add(nn.Module):
    """GRU residual + sigmoid gate. The GRU keeps the JAX weight layout
    (w_ih [D_in, 3H], w_hh [H, 3H], gates stacked [r; z; n], both bias
    vectors, every init U(+/-1/sqrt(H)) as torch nn.GRU); the input
    projections for all steps are one matmul, the recurrence a Python
    loop over the short forecast axis."""

    def __init__(self, d_txt: int, C: int, hidden_dim: int, dropout: float = 0.1):
        super().__init__()
        D_in, H = C + d_txt, hidden_dim
        self.hidden_dim = H
        self.gru_w_ih = nn.Parameter(torch.empty(D_in, 3 * H))
        self.gru_b_ih = nn.Parameter(torch.empty(3 * H))
        self.gru_w_hh = nn.Parameter(torch.empty(H, 3 * H))
        self.gru_b_hh = nn.Parameter(torch.empty(3 * H))
        bound = 1.0 / math.sqrt(H)
        for p in (self.gru_w_ih, self.gru_b_ih, self.gru_w_hh, self.gru_b_hh):
            nn.init.uniform_(p, -bound, bound)
        self.residual_head = nn.Linear(H, C)
        self.layer_norm = nn.LayerNorm(C, eps=1e-5)
        self.dropout = Dropout(dropout)
        self.gate_net = nn.Linear(C + d_txt, C)

    def _gru(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        xi = x @ self.gru_w_ih + self.gru_b_ih  # [B, T, 3H]: all steps at once
        h = x.new_zeros((B, self.hidden_dim))
        hs = []
        for t in range(T):
            hh = h @ self.gru_w_hh + self.gru_b_hh
            xr, xz, xn = xi[:, t].chunk(3, dim=-1)
            hr, hz, hn = hh.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1 - z) * n + z * h
            hs.append(h)
        return torch.stack(hs, dim=1)  # [B, T, H]

    def forward(self, Y_ts, E_txt, M_txt):
        x = torch.cat([Y_ts, E_txt], dim=-1)  # [B,T,C+d_txt]
        delta = self.dropout(self.layer_norm(self.residual_head(self._gru(x))))
        g = torch.sigmoid(self.gate_net(x))
        g = torch.where(M_txt[:, :, None], g, 1.0)  # no text -> base forecast
        return g * Y_ts + (1 - g) * (Y_ts + delta)


class MMF_XAttn_Add(nn.Module):
    """The forecast's steps attend over the aligned text (d_attn wide,
    FusionModel passes d_txt); the attention's residual, normalised over
    the C channels, is blended in as (Y + kappa delta) / (1 + kappa).
    Samples without notes pad every key, so the safe softmax gives zeros
    there (the reference NaN-nukes instead, MMF_XAttn_Add.py:78-80), and
    they return Y_ts / (1 + kappa) + 0."""

    def __init__(self, d_txt: int, C: int, d_attn: int, n_heads_fusion: int = 1,
                 dropout: float = 0.1, kappa: float = 1.0):
        super().__init__()
        self.kappa = kappa
        # flax's default Dense kernel: lecun normal
        self.proj_q = dense(C, d_attn, bias=False, kernel="lecun")
        self.proj_k = dense(d_txt, d_attn, bias=False, kernel="lecun")
        self.proj_v = dense(d_txt, d_attn, bias=False, kernel="lecun")
        self.attn = MultiHeadAttention(d_attn, n_heads_fusion, dropout)
        self.residual_head = nn.Linear(d_attn, C)
        self.layer_norm = nn.LayerNorm(C, eps=1e-5)
        self.dropout = Dropout(dropout)

    def forward(self, Y_ts, E_txt, M_txt):
        B, T, C = Y_ts.shape
        has_text = (M_txt > 0)[:, :, None]  # [B, 1, 1]
        attn_out = self.attn(self.proj_q(Y_ts), self.proj_k(E_txt), self.proj_v(E_txt),
                             key_padding_mask=~has_text[:, :, 0].expand(B, T))
        attn_out = torch.where(has_text, attn_out, 0.0)
        delta = self.dropout(self.layer_norm(self.residual_head(attn_out)))
        delta = torch.where(has_text, delta, 0.0)
        return (Y_ts + self.kappa * delta) / (1.0 + self.kappa)
