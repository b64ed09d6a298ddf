"""NeuralFlow — latent-VAE skeleton with invertible-flow dynamics (after
imm_tsf_tpu/models/neural_flow.py; reference models/NeuralFlow.py +
lib/neural_flow_components/latent_ode_lib/):

  - a backward LSTM-cell encoder whose hidden state a flow evolves over
    the time delta (t_i - prev_t) between observations
    (encoder_decoder.py:55-79), updated where any feature is observed
    (:7-14);
  - transform_z0 -> (mu, softplus sigma) (:36-53); z0 drawn as the
    LatentODE's (ode/nets.py: `train_eps`, `eval_eps`);
  - one batched decode: the flow evaluated at the absolute prediction
    times (flow.py:39-54, no sequential solve), then a linear decoder.

It reads the standard collate's per-sample times [B, L] (1-D shared axes
are broadcast). The encoder is a Python loop over L; pad steps keep the
state where their masks are zero.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..ode import nets
from ..ode.flows import CouplingFlow, ResNetFlow
from ..ode.nets import add_linear, rubanova_linear


class NeuralFlow(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        D, latents, rec_dims = cfg.input_dim, cfg.nf_latents, cfg.nf_rec_dims
        hidden_dims = [cfg.nf_hidden_dim] * cfg.nf_hidden_layers
        flow = CouplingFlow if cfg.nf_flow_model == "coupling" else ResNetFlow
        self.enc_flow = flow(self, "enc_flow", rec_dims, cfg.nf_flow_layers, hidden_dims,
                             cfg.nf_time_net, cfg.nf_time_hidden_dim)
        self.dec_flow = flow(self, "dec_flow", latents, cfg.nf_flow_layers, hidden_dims,
                             cfg.nf_time_net, cfg.nf_time_hidden_dim)
        add_linear(self, "lstm_ih", 2 * D, 4 * rec_dims, init="lecun")
        add_linear(self, "lstm_hh", rec_dims, 4 * rec_dims, init="lecun")
        self.transform_z0_1 = rubanova_linear(rec_dims, 100)
        self.transform_z0_2 = rubanova_linear(100, 2 * latents)
        self.decoder = rubanova_linear(latents, D)
        self.z0_generator: torch.Generator | None = None  # set by the trainer
        self.data_mesh = None  # parallel/mesh.DataMesh, set by the trainer

    def _lstm_cell(self, x, h, c):
        i, f, g, o = (self.lstm_ih(x) + self.lstm_hh(h)).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new

    def forward(self, tp_to_predict, observed_data, observed_tp, observed_mask):
        D = self.cfg.input_dim
        B = observed_data.shape[0]
        if observed_tp.ndim == 1:
            observed_tp = observed_tp[None].expand(B, -1)
        if tp_to_predict.ndim == 1:
            tp_to_predict = tp_to_predict[None].expand(B, -1)

        # backward scan (nf encoder_decoder.py:55-79)
        ts_rev = observed_tp.flip(1)
        xs_rev = torch.cat([observed_data, observed_mask], dim=-1).flip(1)
        h = observed_data.new_zeros((B, self.cfg.nf_rec_dims))
        c = torch.zeros_like(h)
        prev_t = observed_tp[:, -1] + 0.01
        for i in range(ts_rev.shape[1]):
            t_i, x_i = ts_rev[:, i], xs_rev[:, i]
            h = self.enc_flow(self, h, (t_i - prev_t)[:, None])
            h_new, c_new = self._lstm_cell(x_i, h, c)
            m = (x_i[:, D:].sum(dim=-1, keepdim=True) > 0).to(h.dtype)
            h = m * h_new + (1 - m) * h
            c = m * c_new + (1 - m) * c
            prev_t = t_i

        mean_z0, std_z0 = self.transform_z0_2(torch.tanh(self.transform_z0_1(h))).chunk(2, dim=-1)
        std_z0 = F.softplus(std_z0)
        if self.training:
            z0 = mean_z0 + std_z0 * nets.noise(
                lambda shape: nets.train_eps(shape, mean_z0, self.z0_generator), mean_z0.shape,
                self.data_mesh)
        elif self.cfg.eval_sample_traj:
            z0 = mean_z0 + std_z0 * nets.noise(lambda shape: nets.eval_eps(shape, mean_z0),
                                               mean_z0.shape, self.data_mesh)
        else:
            z0 = mean_z0

        # decode at the absolute prediction times (flow.py:39-54)
        Lp = tp_to_predict.shape[1]
        z0_rep = z0[:, None, :].expand(B, Lp, z0.shape[-1])
        return self.decoder(self.dec_flow(self, z0_rep, tp_to_predict[..., None]))
