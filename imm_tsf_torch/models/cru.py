"""CRU — Continuous Recurrent Units (continuous-discrete Kalman filter)
(after imm_tsf_tpu/models/cru.py; reference models/CRU.py +
lib/cru_components/), for training and inference alike (it has no
dropout):
  - wrapper concatenates history + future times, zero future values,
    obs_valid = any(mask) for history / False for future (models/CRU.py:71-97)
  - encoder: 3x(Linear+ReLU+LayerNorm) -> L2-normalized last hidden layer
    -> mean head + 'square' variance head (cru_models.py:90-105,
    cru_encoder.py:72-99)
  - cell: the Kalman scan of ops/cru_scan.py (update, banded-basis
    transition mixed by a softmax coefficient net, Van Loan expm)
  - learnable elup1 initial covariance (CRU_Module.py:130-142)
  - decoder: mean head 3x(Linear+ReLU+LayerNorm) over posterior means
    (cru_models.py:107-127)

Parameters keep the JAX module's flat names: Linear layers are modules
named as the JAX `<name>_kernel`/`<name>_bias` pairs; the LayerNorm
scales and biases, the bases and the noise parameters are raw tensors
(convert.params_from_jax maps them). The LayerNorm is the JAX package's
hand formula (biased variance, eps 1e-5), not nn.LayerNorm.

With cfg.use_pallas the scan reaches the CUDA kernels on the card (#5
forward and #4 backward on the default route, #6 and #7 under
IMM_TSF_CRU_FUSED=1); without it, their plain versions. `scan_inputs`
carries gradients to every parameter the JAX module's gradient reaches
(tests/test_torch_cru_grad.py holds each one to jax.grad).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..ops.cru_scan import cru_scan_auto


def _elup1(x):
    return torch.log(torch.exp(x) + 1.0)  # reference CRUCell.py:61-67


def _elup1_inv(x):
    return float(np.log(np.exp(x) - 1.0))


def _var_act(x, kind):
    if kind == "exp":
        return torch.exp(x)
    if kind == "relu":
        return torch.clamp(x, min=0.0)
    if kind == "square":
        return torch.square(x)
    if kind == "abs":
        return torch.abs(x)
    return torch.where(x < 0.0, torch.exp(x), x + 1.0)  # elup1 (encoder variant)


class CRU(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.use_pallas = cfg.use_pallas
        C = cfg.input_dim
        lsd = cfg.cru_lsd or cfg.hid_dim  # latent state dim
        lod = lsd // 2  # latent observation dim
        hidden = cfg.cru_hidden_units or cfg.hid_dim
        num_basis, bandwidth = cfg.cru_num_basis, cfg.cru_bandwidth
        self.lsd, self.lod = lsd, lod

        self._mlp3("enc", C, hidden)
        self.enc_mean = nn.Linear(hidden, lod)
        self.enc_logvar = nn.Linear(hidden, lod)

        # transition model params (CRUCell.py:190-236): banded bases
        band = np.triu(np.ones((lod, lod), np.float32), -bandwidth) * np.tril(
            np.ones((lod, lod), np.float32), bandwidth)
        idx0, idx1 = np.nonzero(band)
        self.register_buffer("band_rows", torch.from_numpy(idx0), persistent=False)
        self.register_buffer("band_cols", torch.from_numpy(idx1), persistent=False)
        for k in ("11", "12", "21", "22"):
            self.register_parameter(f"tm_{k}_basis",
                                    nn.Parameter(torch.zeros(num_basis, len(idx0))))
        self.coefficient_net = nn.Linear(lsd, num_basis)
        self.log_transition_noise = nn.Parameter(
            torch.full((1, lsd), _elup1_inv(cfg.cru_trans_covar)))
        self.log_icu = nn.Parameter(torch.full((1, lod), _elup1_inv(cfg.cru_initial_state_variance)))
        self.log_icl = nn.Parameter(torch.full((1, lod), _elup1_inv(cfg.cru_initial_state_variance)))

        self._mlp3("dec_mean", lsd, hidden)
        self.dec_out_mean = nn.Linear(hidden, C)

    def _mlp3(self, name: str, d_in: int, hidden: int) -> None:
        d = d_in
        for i in range(3):
            setattr(self, f"{name}_fc{i}", nn.Linear(d, hidden))
            self.register_parameter(f"{name}_ln{i}_scale", nn.Parameter(torch.ones(hidden)))
            self.register_parameter(f"{name}_ln{i}_bias", nn.Parameter(torch.zeros(hidden)))
            d = hidden

    def _mlp3_apply(self, name: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = torch.relu(getattr(self, f"{name}_fc{i}")(x))
            mu = x.mean(-1, keepdim=True)
            var = ((x - mu) ** 2).mean(-1, keepdim=True)
            x = ((x - mu) / torch.sqrt(var + 1e-5) * getattr(self, f"{name}_ln{i}_scale")
                 + getattr(self, f"{name}_ln{i}_bias"))
        return x

    def scan_inputs(self, tp_to_predict, observed_data, observed_tp, observed_mask) -> dict:
        """The encoder and the transition parameters: the keyword arguments
        of ops.cru_scan.cru_scan_auto for this batch (differentiable)."""
        cfg = self.cfg
        lsd, lod = self.lsd, self.lod
        B, _, C = observed_data.shape
        Lp = tp_to_predict.shape[1]

        # wrapper assembly (models/CRU.py:80-93)
        all_tp = torch.cat([observed_tp, tp_to_predict], dim=1)  # [B, T]
        all_data = torch.cat([observed_data, observed_data.new_zeros((B, Lp, C))], dim=1)
        hist_valid = (observed_mask != 0).any(dim=-1)
        all_valid = torch.cat([hist_valid, hist_valid.new_zeros((B, Lp))], dim=1)

        h = self._mlp3_apply("enc", all_data)
        # L2 "pre" normalization of the last hidden layer (CRU_Module.py:86,
        # cru_encoder.py:77-79), max-guarded at exactly-zero rows
        sq = torch.clamp((h ** 2).sum(-1, keepdim=True), min=1e-16)
        h = h / torch.clamp(torch.sqrt(sq), min=1e-8)
        y_mean = self.enc_mean(h)
        y_var = _var_act(self.enc_logvar(h), cfg.cru_enc_var_activation)

        # densify the banded bases once per forward, outside the scan
        K = self.coefficient_net.out_features
        dense = []
        for k in ("11", "12", "21", "22"):
            d = y_mean.new_zeros((K, lod, lod))
            d[:, self.band_rows, self.band_cols] = getattr(self, f"tm_{k}_basis")
            dense.append(d)
        dts = torch.cat([all_tp[:, 1:] - all_tp[:, :-1], all_tp.new_ones((B, 1))],
                        dim=1)  # [B, T]; final dt=1 as in CRULayer.py:77-80
        return dict(
            y_mean=y_mean, y_var=y_var, valid=all_valid.to(y_mean.dtype), dts=dts,
            coeff_w=self.coefficient_net.weight.t(), coeff_b=self.coefficient_net.bias,
            dense_basis=torch.stack(dense),
            trans_var=_elup1(self.log_transition_noise).reshape(lsd),
            init_cu=_elup1(self.log_icu).reshape(lod),
            init_cl=_elup1(self.log_icl).reshape(lod),
        )

    def forward(self, tp_to_predict, observed_data, observed_tp, observed_mask):
        L_hist = observed_data.shape[1]
        post_means = cru_scan_auto(
            **self.scan_inputs(tp_to_predict, observed_data, observed_tp, observed_mask),
            kernel=self.use_pallas)  # [B, T, lsd]
        out_mean = self.dec_out_mean(self._mlp3_apply("dec_mean", post_means))  # [B,T,C]
        return out_mean[:, L_hist:, :]
