"""Small nets of the continuous-time models (after imm_tsf_tpu/ode/nets.py),
and the draws of their latent initial state.

The JAX package keeps each Dense as a flat parameter pair at the model's
top level (`<name>_kernel` [in, out] beside `<name>_bias`); the port
registers it as an nn.Linear named `<name>` on the model, which
convert.params_from_jax's flat-pair rule maps to `<name>.weight` and
`<name>.bias` with no rename. The `add_*` helpers register such layers on
their `owner` and return them.

`create_net` is reference lib/utils.py:269-278 (Linear -> n_layers x
(Tanh, Linear) -> Tanh, Linear) with the Rubanova init (normal std 0.1,
zero bias; lib/utils.py:115-119); `gru_unit_apply` the masked (mean, std)
GRU cell (reference lib/latent_ode_components/encoder_decoder.py:19-95).

z0 draws: in train mode the JAX models draw eps from flax's dropout
stream, which no other framework reproduces; the port draws it with
`train_eps` from the model's `z0_generator` (a generator on the model's
device, which the trainer seeds and checkpoints). Under
eval_sample_traj the JAX models draw `jax.random.normal(PRNGKey(0),
(B, latents))`; `eval_eps` gives those exact numbers (layers/jax_prng.py),
made once per shape on the host, so every device serves the same draw.
"""

from __future__ import annotations

import torch
from torch import nn

from ..layers import jax_prng
from ..models.base import dense

RUBANOVA_STD = 0.1


def rubanova_linear(n_in: int, n_out: int, std: float = RUBANOVA_STD) -> nn.Linear:
    """nn.Linear with the kernel ~ N(0, std^2) and a zero bias."""
    lin = nn.utils.skip_init(nn.Linear, n_in, n_out)
    with torch.no_grad():
        lin.weight.normal_(0.0, std)
        lin.bias.zero_()
    return lin


def add_linear(owner: nn.Module, name: str, n_in: int, n_out: int,
               init: str = "rubanova") -> nn.Linear:
    """Register `owner.<name>`: the Rubanova init, or flax's lecun normal
    kernel with a zero bias ("lecun")."""
    lin = rubanova_linear(n_in, n_out) if init == "rubanova" else dense(n_in, n_out,
                                                                        kernel=init)
    owner.add_module(name, lin)
    return lin


def add_create_net(owner: nn.Module, name: str, n_in: int, n_out: int, n_layers: int = 1,
                   n_units: int = 100) -> tuple[nn.Linear, ...]:
    """The reference create_net's layers `<name>_in`, `<name>_h<i>`, `<name>_out`."""
    return (add_linear(owner, f"{name}_in", n_in, n_units),
            *(add_linear(owner, f"{name}_h{i}", n_units, n_units) for i in range(n_layers)),
            add_linear(owner, f"{name}_out", n_units, n_out))


def create_net_apply(layers, x: torch.Tensor) -> torch.Tensor:
    x = layers[0](x)
    for lin in layers[1:-1]:
        x = lin(torch.tanh(x))
    return layers[-1](torch.tanh(x))


def add_gru_unit(owner: nn.Module, name: str, latent_dim: int, input_dim: int,
                 n_units: int = 100) -> dict:
    d_in = 2 * latent_dim + input_dim
    dims = {"update1": (d_in, n_units), "update2": (n_units, latent_dim),
            "reset1": (d_in, n_units), "reset2": (n_units, latent_dim),
            "new1": (d_in, n_units), "new2": (n_units, 2 * latent_dim)}
    return {k: add_linear(owner, f"{name}_{k}", *io) for k, io in dims.items()}


def gru_unit_apply(p: dict, y_mean, y_std, x, masked_update: bool = True):
    """One masked (mean, std) GRU update; a row whose mask half of x is all
    zero keeps its state."""
    concat = torch.cat([y_mean, y_std, x], dim=-1)
    update_gate = torch.sigmoid(p["update2"](torch.tanh(p["update1"](concat))))
    reset_gate = torch.sigmoid(p["reset2"](torch.tanh(p["reset1"](concat))))
    c2 = torch.cat([y_mean * reset_gate, y_std * reset_gate, x], dim=-1)
    new_state, new_state_std = p["new2"](torch.tanh(p["new1"](c2))).chunk(2, dim=-1)
    new_state_std = torch.abs(new_state_std)
    new_y = (1 - update_gate) * new_state + update_gate * y_mean
    new_y_std = (1 - update_gate) * new_state_std + update_gate * y_std
    if masked_update:
        n_data = x.shape[-1] // 2
        mask = (x[..., n_data:].sum(dim=-1, keepdim=True) > 0).to(new_y.dtype)
        new_y = mask * new_y + (1 - mask) * y_mean
        new_y_std = mask * new_y_std + (1 - mask) * y_std
    return new_y, torch.abs(new_y_std)


def train_eps(shape, like: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """The train-mode z0 noise: N(0, 1) of `shape` from `generator` (on
    like's device; torch's default generator when None), like's dtype."""
    return torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)


_EVAL_EPS: dict = {}  # (shape, device, dtype) -> tensor


def eval_eps(shape, like: torch.Tensor) -> torch.Tensor:
    """jax.random.normal(PRNGKey(0), shape) on like's device and dtype."""
    key = (tuple(shape), like.device, like.dtype)
    if key not in _EVAL_EPS:
        draw = jax_prng.normal(jax_prng.prng_key(0), tuple(shape))
        with torch.inference_mode(False):
            _EVAL_EPS[key] = torch.from_numpy(draw).to(like.device, like.dtype)
    return _EVAL_EPS[key]
