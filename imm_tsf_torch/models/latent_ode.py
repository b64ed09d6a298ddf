"""LatentODE — ODE-RNN encoder + latent neural-ODE decoder (after
imm_tsf_tpu/models/latent_ode.py; reference models/LatentODE.py +
lib/latent_ode_components/):

  - a backward ODE-RNN encoder over the batch's union time axis (the ODE
    collate's shared 1-D observed_tp): each interval is evolved by one
    Euler step where the gap is under interval/50 (encoder_decoder.py:
    277-286), else by `ode_substeps` rk4 (3/8) substeps, then the masked
    (mean, std) GRU update (:58-95, 304);
  - transform_z0 -> (mu, |sigma|); z0 = mu + sigma * eps in train mode
    (eps from `nets.train_eps` and the model's `z0_generator`), mu in eval,
    or mu + sigma * jax.random.normal(PRNGKey(0)) under eval_sample_traj
    (`nets.eval_eps`);
  - the generative ODE solved from the first prediction time over the
    prediction axis, one rk4 (3/8) step an interval, and a linear decoder.

The encoder computes both evolutions of every interval and picks one with
torch.where, as the JAX package's scan does: a branch on the host would
read the gap back from the card at every step. The scan is a Python loop
of ~150 torch calls a union time step (on the H100 each Linear is four
launches: cuBLASLt's split-K GEMM, a memset, a scale and the bias
epilogue), so the path is bound by the host (PERF.md; ROADMAP.md, Queue
1, item 2 would capture it in a graph).
Repeat-padded times are dt = 0 steps: the identity for the rk4 and Euler
evolutions, and the GRU skips them (their masks are zero).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import Config
from ..ode import nets
from ..ode.nets import (add_create_net, add_gru_unit, create_net_apply, gru_unit_apply,
                        rubanova_linear)
from ..ode.solvers import odeint_grid, rk4_alt_step


class LatentODE(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        if cfg.ode_substeps < 1:
            raise ValueError("ode_substeps must be >= 1 (0 would silently "
                             "skip the encoder's ODE evolution)")
        self.cfg = cfg
        D, latents, rec_dims = cfg.input_dim, cfg.ode_latents, cfg.ode_rec_dims
        self.rec_ode = add_create_net(self, "rec_ode_func", rec_dims, rec_dims,
                                      n_layers=cfg.ode_rec_layers, n_units=cfg.ode_units)
        self.gru = add_gru_unit(self, "gru", rec_dims, 2 * D, n_units=cfg.ode_gru_units)
        self.transform_z0_1 = rubanova_linear(2 * rec_dims, 100)
        self.transform_z0_2 = rubanova_linear(100, 2 * latents)
        self.gen_ode = add_create_net(self, "gen_ode_func", latents, latents,
                                      n_layers=cfg.ode_gen_layers, n_units=cfg.ode_units)
        self.decoder = rubanova_linear(latents, D)
        self.z0_generator: torch.Generator | None = None  # set by the trainer

    def encode(self, observed_data, observed_tp, observed_mask):
        """The backward ODE-RNN over the shared time axis observed_tp [T]:
        the last (mean, std) state, [B, rec_dims] each."""
        n_sub = self.cfg.ode_substeps
        B = observed_data.shape[0]
        f = lambda t, y: create_net_apply(self.rec_ode, y)
        ts_rev = observed_tp.flip(0)
        xs_rev = torch.cat([observed_data, observed_mask], dim=-1).flip(1)
        # every interval's times at once: prev_t is the step before's t_i
        prev_ts = torch.cat([observed_tp[-1:] + 0.01, ts_rev[:-1]])
        deltas = ts_rev - prev_ts  # t_i - prev_t (negative: the scan runs backward)
        small = prev_ts - ts_rev < (observed_tp[-1] - observed_tp[0]) / 50.0
        dts = deltas / n_sub
        y = observed_data.new_zeros((B, self.cfg.ode_rec_dims))
        std = observed_data.new_zeros((B, self.cfg.ode_rec_dims))
        for i in range(ts_rev.shape[0]):
            k1 = f(None, y)  # the Euler step's slope, and the first substep's
            y_small = torch.addcmul(y, k1, deltas[i])
            y_big = rk4_alt_step(f, y, None, dts[i], k1=k1)
            for _ in range(n_sub - 1):
                y_big = rk4_alt_step(f, y_big, None, dts[i])
            y_ode = torch.where(small[i], y_small, y_big)
            y, std = gru_unit_apply(self.gru, y_ode, std, xs_rev[:, i])
        return y, std

    def forward(self, tp_to_predict, observed_data, observed_tp, observed_mask):
        # the ODE collate's layout: shared 1-D time axes
        if observed_tp.ndim == 2:
            observed_tp = observed_tp[0]
        t_pred = tp_to_predict[0] if tp_to_predict.ndim == 2 else tp_to_predict
        last_y, last_std = self.encode(observed_data, observed_tp, observed_mask)

        tz = self.transform_z0_2(torch.tanh(self.transform_z0_1(
            torch.cat([last_y, last_std], dim=-1))))
        mean_z0, std_z0 = tz.chunk(2, dim=-1)
        std_z0 = torch.abs(std_z0)
        if self.training:
            z0 = mean_z0 + std_z0 * nets.train_eps(mean_z0.shape, mean_z0, self.z0_generator)
        elif self.cfg.eval_sample_traj:
            z0 = mean_z0 + std_z0 * nets.eval_eps(mean_z0.shape, mean_z0)
        else:
            z0 = mean_z0

        f_gen = lambda t, y: create_net_apply(self.gen_ode, y)
        sol = odeint_grid(f_gen, z0, t_pred, method="rk4")  # [Lp, B, latents]
        return self.decoder(sol.transpose(0, 1))  # [B, Lp, D]
