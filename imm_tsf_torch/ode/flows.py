"""Neural Flows: invertible flow "solvers" (Bilos et al. 2021), after
imm_tsf_tpu/ode/flows.py (reference lib/neural_flow_components/models/
flow.py:9-108, rebuilt there from the paper's definitions):

  CouplingFlow: stacked continuous affine coupling layers
      y = z + (1-m) * (x * exp(s(z,t) * phi_s(t)) + b(z,t) * phi_b(t))
    with phi(0) = 0 (TimeLinear: phi(t) = w*t; TimeTanh: tanh(w*t);
    TimeLog: log1p(|w*t|) sign(w*t); TimeFourier: a projection of
    sin(w*t), less its value at 0), so F(x, 0) = x.
  ResNetFlow: stacked residual layers y = x + phi(t) * tanh(g(x, t)).

Both evaluate the solution at any t directly, with no sequential solve.

A flow's tensors live on its `owner` (the model) under the JAX package's
flat names: `<name>_l<i>_latent_fc<j>` / `<name>_l<i>_net_fc<j>` Linear
layers (lecun normal kernels, zero biases), the time net's raw
`<name>_l<i>_time_w` (and TimeFourier's `<name>_l<i>_time_proj` Linear),
and each coupling layer's `_ordered_mask` as the non-persistent buffer
`<name>_l<i>_mask`, a constant. A flow object holds only those names:
call it as flow(owner, x, t).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .nets import add_linear

TIME_NETS = ("TimeLinear", "TimeTanh", "TimeLog", "TimeFourier")


def _ordered_mask(dim: int, parity: int) -> np.ndarray:
    m = np.zeros((dim,), np.float32)
    m[: dim // 2] = 1.0
    if parity % 2 == 1:
        m = 1.0 - m
    return m


def add_mlp(owner: nn.Module, name: str, d_in: int, hidden_dims, d_out: int) -> list[str]:
    dims = [d_in, *hidden_dims, d_out]
    for i in range(len(dims) - 1):
        add_linear(owner, f"{name}_fc{i}", dims[i], dims[i + 1], init="lecun")
    return [f"{name}_fc{i}" for i in range(len(dims) - 1)]


def mlp_apply(owner: nn.Module, names: list[str], x: torch.Tensor) -> torch.Tensor:
    for n in names[:-1]:
        x = torch.tanh(getattr(owner, n)(x))
    return getattr(owner, names[-1])(x)


class TimeNet:
    """phi(t): (..., 1) -> (..., out_dim), phi(0) = 0. Registers `<name>_w`
    (N(0, 0.1^2), TimeFourier's N(0, 1) of hidden_dim) on the owner."""

    def __init__(self, owner: nn.Module, name: str, out_dim: int, kind: str,
                 hidden_dim: int | None = None):
        if kind not in TIME_NETS:
            raise ValueError(f"Unknown time_net {kind}")
        self.name, self.kind = name, kind
        with torch.no_grad():
            if kind == "TimeFourier":
                owner.register_parameter(f"{name}_w", nn.Parameter(
                    torch.randn(hidden_dim or 8)))
                add_linear(owner, f"{name}_proj", hidden_dim or 8, out_dim, init="lecun")
            else:
                owner.register_parameter(f"{name}_w", nn.Parameter(
                    torch.randn(out_dim) * 0.1))

    def __call__(self, owner: nn.Module, t: torch.Tensor) -> torch.Tensor:
        w = getattr(owner, f"{self.name}_w")
        if self.kind == "TimeLinear":
            return t * w
        if self.kind == "TimeTanh":
            return torch.tanh(t * w)
        if self.kind == "TimeLog":
            return torch.log1p(torch.abs(t * w)) * torch.sign(t * w)
        s = torch.sin(t * w)
        proj = getattr(owner, f"{self.name}_proj")
        return proj(s) - proj(torch.zeros_like(s))


class CouplingFlow:
    """x (..., dim) at t (..., 1) -> y (..., dim); y(t=0) = x."""

    def __init__(self, owner: nn.Module, name: str, dim: int, n_layers: int, hidden_dims,
                 time_net: str, time_hidden_dim: int | None):
        self.layers = []
        for i in range(n_layers):
            mask = _ordered_mask(dim, i) if dim > 1 else np.zeros((dim,), np.float32)
            owner.register_buffer(f"{name}_l{i}_mask", torch.from_numpy(mask),
                                  persistent=False)
            self.layers.append((f"{name}_l{i}_mask",
                                add_mlp(owner, f"{name}_l{i}_latent", dim + 1, hidden_dims,
                                        2 * dim),
                                TimeNet(owner, f"{name}_l{i}_time", 2 * dim, time_net,
                                        time_hidden_dim)))

    def __call__(self, owner: nn.Module, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        for mask, latent, time in self.layers:
            m = getattr(owner, mask)
            z = x * m
            scale, shift = mlp_apply(owner, latent, torch.cat([z, t], dim=-1)).chunk(2, dim=-1)
            phi_s, phi_b = time(owner, t).chunk(2, dim=-1)
            x = z + (1 - m) * (x * torch.exp(scale * phi_s) + shift * phi_b)
        return x


class ResNetFlow:
    """x (..., dim) at t (..., 1) -> y (..., dim); y(t=0) = x."""

    def __init__(self, owner: nn.Module, name: str, dim: int, n_layers: int, hidden_dims,
                 time_net: str, time_hidden_dim: int | None):
        self.layers = [(add_mlp(owner, f"{name}_l{i}_net", dim + 1, hidden_dims, dim),
                        TimeNet(owner, f"{name}_l{i}_time", dim, time_net, time_hidden_dim))
                       for i in range(n_layers)]

    def __call__(self, owner: nn.Module, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        for net, time in self.layers:
            g = torch.tanh(mlp_apply(owner, net, torch.cat([x, t], dim=-1)))
            x = x + time(owner, t) * g
        return x



