#!/usr/bin/env python3
"""The LatentODE's float32 drift over a long union time axis, in both
packages, on the CPU.

    python tools/torch_ode_drift.py

Takes chip_smoke.ode_drift_case (the preset LatentODE with seeded weights
and a seeded ODE-collated batch of the trained run's shape: B 32, union
axes of 768 + 768 times), carries the weights to the JAX package's
LatentODE and prints one JSON line: the max |float32 - float64| of the
JAX forward and of the port's, both from the port's float64 forward (eval
mode), and the bound that chip_smoke.py holds the card to, 4 x JAX's
distance + 1e-6 (chip_smoke.ODE_DRIFT_JAX / ODE_DRIFT_MAX).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def flax_params(state: dict) -> dict:
    """The LatentODE's port state dict -> its flax params: every layer is a
    flat pair `<name>_kernel` [in, out], `<name>_bias`."""
    out = {}
    for k, v in state.items():
        name, leaf = k.rsplit(".", 1)
        out[f"{name}_kernel" if leaf == "weight" else f"{name}_bias"] = (
            v.numpy().T.copy() if leaf == "weight" else v.numpy())
    return out


def drift(model, args) -> dict:
    """max |float32 - float64 port| of the JAX package's and the port's
    forward of `model` (the port's LatentODE, eval mode) on `args`."""
    import jax

    from imm_tsf_tpu.config import Config as JConfig
    from imm_tsf_tpu.models import get_model as j_get_model

    cfg = model.cfg
    jcfg = JConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(JConfig)
                      if hasattr(cfg, f.name)})
    m64 = copy.deepcopy(model).double()
    with torch.inference_mode():
        want = m64(*(a.double() for a in args)).numpy()
        got = model(*args).numpy()
    jax_out = jax.jit(lambda p, *a: j_get_model(jcfg).apply({"params": p}, *a, train=False))(
        flax_params(model.state_dict()), *(a.numpy() for a in args))
    jax_out = np.asarray(jax_out, np.float64)
    jax_d = float(np.abs(jax_out - want).max())
    return {"union": [args[2].shape[0], args[0].shape[0]], "batch": args[1].shape[0],
            "port_from_float64": float(np.abs(got - want).max()),
            "jax_from_float64": jax_d,
            "port_from_jax": float(np.abs(got - jax_out).max()),
            "largest_float64": float(np.abs(want).max()),
            "bound": 4 * jax_d + 1e-6}


def main() -> int:
    import chip_smoke as cs

    torch.set_num_threads(1)
    print(json.dumps(drift(*cs.ode_drift_case())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
