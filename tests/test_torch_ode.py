"""The port's ODE and flow library against imm_tsf_tpu/ode, on the CPU
(2e-6 absolute unless stated), weights carried by params_from_jax:

- `rk4_alt_step` and `euler_step` on a time-dependent field, `odeint_grid`
  over a grid with repeated times (exact identity steps there), and
  `solve_fixed_substeps`;
- `create_net` and the masked (mean, std) `gru_unit_apply` (rows with no
  observation keep their state exactly);
- every flow (coupling, resnet) x time net (TimeLinear, TimeTanh,
  TimeLog, TimeFourier), and F(x, 0) = x exactly;
- `jax_prng.normal` against `jax.random.normal` (1e-6), and `eval_eps`.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from imm_tsf_tpu.ode import flows as jflows
from imm_tsf_tpu.ode import nets as jnets
from imm_tsf_tpu.ode import solvers as jsolvers

from imm_tsf_torch.layers import jax_prng
from imm_tsf_torch.ode import flows, nets, solvers

from torch_port_parity import perturbed, port_state

torch.set_num_threads(1)

ATOL = 2e-6
T = lambda a: torch.from_numpy(np.asarray(a))


def _field_jax(t, y):
    return jnp.sin(3 * t) - 0.7 * y * jnp.cos(t) + 0.1 * y * y


def _field_torch(t, y):
    return torch.sin(3 * t) - 0.7 * y * torch.cos(t) + 0.1 * y * y


@pytest.mark.parametrize("method", ["rk4", "euler"])
def test_steps_and_grid_solves_match_jax(method):
    rng = np.random.default_rng(0)
    y0 = rng.standard_normal((4, 5)).astype(np.float32)
    ts = np.sort(rng.uniform(0, 2, 9)).astype(np.float32)
    ts[4] = ts[3]  # a repeated time: an identity step
    ts[-1] = ts[-2]
    step, jstep = solvers._STEPS[method], jsolvers._STEPS[method]
    np.testing.assert_allclose(
        step(_field_torch, T(y0), T(ts[1]), T(ts[2] - ts[1])).numpy(),
        np.asarray(jstep(_field_jax, y0, ts[1], ts[2] - ts[1])), atol=ATOL, rtol=0)
    got = solvers.odeint_grid(_field_torch, T(y0), T(ts), method).numpy()
    want = np.asarray(jsolvers.odeint_grid(_field_jax, y0, ts, method))
    assert got.shape == (9, 4, 5)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.array_equal(got[0], y0) and np.array_equal(got[4], got[3])
    assert np.array_equal(got[-1], got[-2])
    got = solvers.solve_fixed_substeps(_field_torch, T(y0), T(ts[0]), T(ts[-1]), 4, method)
    want = jsolvers.solve_fixed_substeps(_field_jax, y0, ts[0], ts[-1], 4, method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    if method == "rk4":  # an autonomous field stepped without stage times: the same numbers
        auto = lambda t, y: torch.tanh(y) * 0.5
        dt = T(ts[2] - ts[1])
        assert torch.equal(step(auto, T(y0), None, dt), step(auto, T(y0), T(ts[1]), dt))


class _JNets(fnn.Module):
    @fnn.compact
    def __call__(self, y, y_std, x):
        net = jnets.create_net_params(self, "net", 6, 6, n_layers=2, n_units=8)
        gru = jnets.gru_unit_params(self, "gru", 6, x.shape[-1], n_units=8)
        return jnets.create_net_apply(net, y), *jnets.gru_unit_apply(gru, y, y_std, x)


class _TNets(nn.Module):
    def __init__(self, d_x):
        super().__init__()
        self.net = nets.add_create_net(self, "net", 6, 6, n_layers=2, n_units=8)
        self.gru = nets.add_gru_unit(self, "gru", 6, d_x, n_units=8)

    def forward(self, y, y_std, x):
        return nets.create_net_apply(self.net, y), *nets.gru_unit_apply(self.gru, y, y_std, x)


def test_create_net_and_gru_unit_match_jax():
    rng = np.random.default_rng(1)
    y, y_std = (rng.standard_normal((5, 6)).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((5, 8)).astype(np.float32)
    x[:, 4:] = (rng.random((5, 4)) < 0.5).astype(np.float32)
    x[2, 4:] = 0.0  # a row with nothing observed
    jm = _JNets()
    params = perturbed(jm.init(jax.random.PRNGKey(0), y, y_std, x)["params"])
    want = jm.apply({"params": params}, y, y_std, x)
    tm = _TNets(8)
    tm.load_state_dict(port_state(params))
    got = tm(T(y), T(y_std), T(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=ATOL, rtol=0)
    assert torch.equal(got[1][2], T(y[2])) and torch.equal(got[2][2], T(np.abs(y_std[2])))


class _JFlow(fnn.Module):
    kind: str
    time_net: str

    @fnn.compact
    def __call__(self, x, t):
        make, apply = ((jflows.coupling_flow_params, jflows.coupling_flow_apply)
                       if self.kind == "coupling" else
                       (jflows.resnet_flow_params, jflows.resnet_flow_apply))
        return apply(make(self, "flow", x.shape[-1], 2, [8, 8], self.time_net, 4), x, t)


class _TFlow(nn.Module):
    def __init__(self, kind, time_net, dim):
        super().__init__()
        flow = flows.CouplingFlow if kind == "coupling" else flows.ResNetFlow
        self.flow = flow(self, "flow", dim, 2, [8, 8], time_net, 4)

    def forward(self, x, t):
        return self.flow(self, x, t)


@pytest.mark.parametrize("time_net", flows.TIME_NETS)
@pytest.mark.parametrize("kind", ["coupling", "resnet"])
def test_flows_match_jax_and_start_at_x(kind, time_net):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 4, 5)).astype(np.float32)
    t = rng.uniform(-0.5, 1.5, (3, 4, 1)).astype(np.float32)
    jm = _JFlow(kind, time_net)
    params = perturbed(jm.init(jax.random.PRNGKey(0), x, t)["params"])
    tm = _TFlow(kind, time_net, 5)
    tm.load_state_dict(port_state(params))  # the masks are buffers, not state
    want = np.asarray(jm.apply({"params": params}, x, t))
    with torch.no_grad():
        np.testing.assert_allclose(tm(T(x), T(t)).numpy(), want, atol=ATOL, rtol=0)
        assert torch.equal(tm(T(x), torch.zeros(3, 4, 1)), T(x))  # F(x, 0) = x
    if kind == "coupling":
        assert [n for n, _ in tm.named_buffers()] == ["flow_l0_mask", "flow_l1_mask"]
        assert not any("mask" in k for k in tm.state_dict())


@pytest.mark.parametrize("shape, seed", [((64, 20), 0), ((8, 40), 3), ((7,), 5),
                                         ((300, 17), 1)])
def test_normal_matches_jax_random_normal(shape, seed):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = jax_prng.normal(jax_prng.prng_key(seed), shape)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_eval_eps_is_the_key_0_draw_made_once():
    like = torch.zeros(3, dtype=torch.float64)
    e = nets.eval_eps((6, 4), like)
    assert e.dtype == torch.float64 and e is nets.eval_eps((6, 4), like)
    np.testing.assert_allclose(e.numpy(), np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (6, 4))), atol=1e-6, rtol=0)
