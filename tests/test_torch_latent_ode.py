"""LatentODE, the port against the JAX package, on the CPU:

- the forward on an ODE-collated batch (union axes with repeat pads, an
  all-zero padded row), at ode_substeps 4 and 1 and under
  eval_sample_traj, through params_from_jax (2e-5 absolute);
- ode_substeps < 1 raises in both packages;
- train-mode gradients under one pinned z0 noise (`pinned_z0`: the JAX
  module's jax.random.normal and the port's nets.train_eps), 1e-4 of the
  largest entry;
- a LatentODE + TTF_RecAvg + MMF_GR_Add service against the JAX service,
  request by request in both (1e-4);
- `trainable` from the JAX init against the JAX `trainable` with z0's
  noise pinned on both sides and the union axes at one fixed size
  (per-step losses 1e-5 relative);
- the fresh init against the JAX `init_state` (zeros exact, std 10 %);
- the forward over a union axis of the trained length (768 times, B 32,
  chip_smoke's `ode_drift_case`): the port's float32 distance from its float64 run
  within 4x the JAX package's plus 1e-6, and the JAX distance that
  chip_smoke.py holds the card to (ODE_DRIFT_JAX) still the one measured.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.data import collate as JC
from imm_tsf_tpu.data.dataset import Chunk
from imm_tsf_tpu.models import get_model as j_get_model
from imm_tsf_tpu.models import latent_ode as jlatent_ode

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.data import collate as TC
from imm_tsf_torch.models import get_model

from torch_port_parity import (assert_model_matches, init_matches_jax, perturbed, pinned_z0,
                               port_state, service_matches_jax, trainable_matches_jax)

torch.set_num_threads(1)

ATOL = 2e-5
SMALL = dict(model="LatentODE", ode_rec_dims=8, ode_units=16, ode_gru_units=8, ode_latents=4)


def ode_batch(seed: int, B: int = 6, D: int = 3):
    """(tp_to_predict, observed_data, observed_tp, observed_mask) of the
    ODE collate over B ragged chunks (history 7, 14 days in all); the last
    row all zeros (a padded batch row)."""
    rng = np.random.default_rng(seed)
    chunks = []
    for b in range(B):
        tt = np.unique(np.round(rng.uniform(0, 14, int(rng.integers(4, 14))), 3)).astype(
            np.float32)
        mask = (rng.random((len(tt), D)) < 0.7).astype(np.float32)
        if b == B - 1:
            mask[:] = 0.0
        vals = rng.standard_normal((len(tt), D)).astype(np.float32) * mask
        chunks.append(Chunk(f"r{b}_chunk0", tt, vals, mask, np.zeros(0, np.float32), []))
    out = JC.ode_collate(chunks, 7.0, 14.0)
    return (out["tp_to_predict"], out["observed_data"], out["observed_tp"],
            out["observed_mask"])


@pytest.mark.parametrize("over", [{}, dict(ode_substeps=1), dict(eval_sample_traj=True)],
                         ids=["substeps4", "substeps1", "eval_sample"])
def test_latent_ode_matches_jax(over):
    batch = ode_batch(0)
    tobs, tpred = batch[2], batch[0]
    assert tobs[-1] == tobs[-2] and tpred[-1] == tpred[-2]  # both union axes repeat-padded
    kw = dict(SMALL, input_dim=3, **over)
    assert_model_matches(j_get_model(JConfig(**kw)), get_model(TConfig(**kw)), batch, ATOL)


def test_ode_substeps_below_one_raises():
    kw = dict(SMALL, input_dim=3, ode_substeps=0)
    with pytest.raises(ValueError, match="ode_substeps"):
        get_model(TConfig(**kw))
    with pytest.raises(ValueError, match="ode_substeps"):
        j_get_model(JConfig(**kw)).init(jax.random.PRNGKey(0), *ode_batch(1))


def test_train_mode_gradients_match_jax(monkeypatch):
    batch = ode_batch(2)
    kw = dict(SMALL, input_dim=3)
    jm, tm = j_get_model(JConfig(**kw)), get_model(TConfig(**kw))
    params = perturbed(jm.init(jax.random.PRNGKey(0), *batch)["params"])
    tm.load_state_dict(port_state(params))
    eps = np.random.default_rng(3).standard_normal((6, 4)).astype(np.float32)
    pinned_z0(monkeypatch, jlatent_ode, eps)
    g = np.random.default_rng(4).standard_normal((6, batch[0].shape[0], 3)).astype(np.float32)

    def loss(p):
        out = jm.apply({"params": p}, *batch, train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return (out * g).sum()

    want_loss, want = jax.value_and_grad(loss)(params)
    want = port_state(jax.tree_util.tree_map(np.asarray, want))
    out = tm.train()(*(torch.from_numpy(a) for a in batch))
    got_loss = (out * torch.from_numpy(g)).sum()
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=1e-5)
    top = max(float(v.abs().max()) for v in want.values())
    for n, p in tm.named_parameters():
        w = want[n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-6 * top, err_msg=n)


def test_service_matches_jax_request_by_request(tmp_path):
    metrics = service_matches_jax(tmp_path, dict(SMALL, input_dim=3, input_len=16, pred_len=8),
                                  n_requests=6)
    assert metrics["dispatches_total"] == metrics["requests_total"] == 6


def test_trainable_from_jax_init_matches_jax_trainable(tmp_path, monkeypatch):
    """Both loaders' ODE collates pinned to one union-axis size (96, past
    every batch's union here), so the JAX trainer compiles its steps once
    rather than once a bucket pair; the buckets are held above."""
    eps = np.random.default_rng(5).standard_normal((8, 4)).astype(np.float32)
    pinned_z0(monkeypatch, jlatent_ode, eps)
    for mod in (JC, TC):
        monkeypatch.setattr(mod, "ode_collate", lambda b, h, tm, f=mod.ode_collate: f(
            b, h, tm, t_obs_cap=96, t_pred_cap=96))
    trainable_matches_jax(tmp_path, SMALL)


def test_fresh_init_draws_as_the_jax_package():
    kw = dict(model="LatentODE", input_dim=8, ode_rec_dims=32, ode_units=32, ode_gru_units=32)
    tp, data, tobs, mask = ode_batch(6, D=8)
    held = init_matches_jax(kw, dict(tp_to_predict=tp, observed_data=data, observed_tp=tobs,
                                     observed_mask=mask))
    assert {"gru_update1.weight", "rec_ode_func_h0.weight", "transform_z0_1.weight"} <= set(held)


def test_trained_union_scan_within_float64_bound():
    import chip_smoke as cs

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    try:
        from torch_ode_drift import drift
    finally:
        sys.path.pop(0)
    got = drift(*cs.ode_drift_case())
    assert got["union"] == [768, 768]
    assert got["port_from_float64"] <= got["bound"], got
    assert got["port_from_jax"] <= ATOL, got
    assert abs(got["jax_from_float64"] - cs.ODE_DRIFT_JAX) <= 0.5 * cs.ODE_DRIFT_JAX, got
