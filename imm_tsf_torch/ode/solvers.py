"""Fixed-step ODE solvers (after imm_tsf_tpu/ode/solvers.py), as Python
loops over tensors.

The reference hard-codes torchdiffeq's fixed-grid rk4 (the 3/8-rule
variant, `rk4_alt_step_func`) for every solve (lib/latent_ode_components/
diffeq_solver.py:44-47). A grid solve takes one step per interval of the
evaluation times, so a repeated time is a dt = 0 identity step (the ODE
collate's repeat-padded axes). The times stay on the device: nothing here
reads a value back to the host.

An autonomous `func` (one that ignores t, as the LatentODE's encoder
net does) may be stepped with t = None: the stage times are then not
formed, which saves three launches a step on the card and changes no
result.
"""

from __future__ import annotations

import torch


def rk4_alt_step(func, y, t, dt, k1=None):
    """torchdiffeq rk4_alt_step_func (3/8 rule): y -> y + increment. Each
    stage input is one fused multiply-add (y + dt * k1 / 3 as
    addcmul(y, k1, dt, 1/3), and so on), which rounds a little differently
    from the separate ops but halves the launches between the field's
    evaluations. k1, when given, is func(t, y), already evaluated."""
    if k1 is None:
        k1 = func(t, y)
    k2 = func(None if t is None else t + dt / 3, torch.addcmul(y, k1, dt, value=1 / 3))
    k3 = func(None if t is None else t + dt * 2 / 3,
              torch.addcmul(y, torch.sub(k2, k1, alpha=1 / 3), dt))
    k4 = func(None if t is None else t + dt, torch.addcmul(y, k1 - k2 + k3, dt))
    return torch.addcmul(y, torch.add(k1, k2 + k3, alpha=3) + k4, dt, value=0.125)


def euler_step(func, y, t, dt):
    return torch.addcmul(y, func(t, y), dt)


_STEPS = {"rk4": rk4_alt_step, "euler": euler_step}


def odeint_grid(func, y0: torch.Tensor, ts: torch.Tensor, method: str = "rk4") -> torch.Tensor:
    """Integrate dy/dt = func(t, y), evaluating at every ts[i].

    ts: [T] (monotone; repeats allowed -> identity steps).
    Returns [T, *y0.shape] with sol[0] == y0 (the torchdiffeq fixed-grid
    contract, diffeq_solver.py:52-54)."""
    step = _STEPS[method]
    dts = ts[1:] - ts[:-1]
    ys = [y0]
    for i in range(ts.shape[0] - 1):
        ys.append(step(func, ys[-1], ts[i], dts[i]))
    return torch.stack(ys)


def solve_fixed_substeps(func, y0, t0, t1, n_sub: int, method: str = "rk4"):
    """Integrate from t0 to t1 in n_sub equal steps (the JAX package's
    static replacement for the reference encoder's data-dependent sub-grid,
    encoder_decoder.py:287-291)."""
    step = _STEPS[method]
    dt = (t1 - t0) / n_sub
    y = y0
    for i in range(n_sub):
        y = step(func, y, t0 + i * dt, dt)
    return y
