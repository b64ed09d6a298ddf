"""NeuralFlow, the port against the JAX package, on the CPU:

- the forward on a standard-collate batch (per-sample times, an all-zero
  padded row) with the coupling flow and the resnet flow, and under
  eval_sample_traj, through params_from_jax (2e-5 absolute; the flows
  and time nets one by one are in test_torch_ode.py);
- train-mode gradients under one pinned z0 noise (`pinned_z0`), 1e-4 of
  the largest entry;
- a NeuralFlow + TTF_RecAvg + MMF_GR_Add service against the JAX service
  (1e-4), and `trainable` from the JAX init against the JAX `trainable`
  with z0's noise pinned (per-step losses 1e-5 relative);
- the fresh init against the JAX `init_state` (zeros exact, std 10 %).
"""

import jax
import numpy as np
import pytest
import torch

from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.models import get_model as j_get_model
from imm_tsf_tpu.models import neural_flow as jneural_flow

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.models import get_model

from torch_port_parity import (assert_model_matches, init_matches_jax, model_batch, perturbed,
                               pinned_z0, port_state, service_matches_jax,
                               trainable_matches_jax)

torch.set_num_threads(1)

ATOL = 2e-5
SMALL = dict(model="NeuralFlow", nf_hidden_dim=16, nf_hidden_layers=2, nf_rec_dims=8,
             nf_latents=6)


@pytest.mark.parametrize("over", [dict(nf_flow_model="coupling"),
                                  dict(nf_flow_model="resnet", nf_time_net="TimeTanh"),
                                  dict(eval_sample_traj=True)],
                         ids=["coupling", "resnet", "eval_sample"])
def test_neural_flow_matches_jax(over):
    kw = dict(SMALL, input_dim=3, **over)
    assert_model_matches(j_get_model(JConfig(**kw)), get_model(TConfig(**kw)),
                         model_batch(0, 5, 14, 7, 3), ATOL)


def test_train_mode_gradients_match_jax(monkeypatch):
    batch = model_batch(1, 5, 14, 7, 3)
    kw = dict(SMALL, input_dim=3)
    jm, tm = j_get_model(JConfig(**kw)), get_model(TConfig(**kw))
    params = perturbed(jm.init(jax.random.PRNGKey(0), *batch)["params"])
    tm.load_state_dict(port_state(params))
    pinned_z0(monkeypatch, jneural_flow,
              np.random.default_rng(3).standard_normal((5, 6)).astype(np.float32))
    g = np.random.default_rng(4).standard_normal((5, 7, 3)).astype(np.float32)

    def loss(p):
        out = jm.apply({"params": p}, *batch, train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return (out * g).sum()

    want_loss, want = jax.jit(jax.value_and_grad(loss))(params)
    want = port_state(jax.tree_util.tree_map(np.asarray, want))
    got_loss = (tm.train()(*(torch.from_numpy(a) for a in batch)) * torch.from_numpy(g)).sum()
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=1e-5)
    top = max(float(v.abs().max()) for v in want.values())
    for n, p in tm.named_parameters():
        w = want[n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-6 * top, err_msg=n)


def test_service_matches_jax(tmp_path):
    service_matches_jax(tmp_path, dict(SMALL, input_dim=3, input_len=16, pred_len=8),
                        n_requests=8)


def test_trainable_from_jax_init_matches_jax_trainable(tmp_path, monkeypatch):
    pinned_z0(monkeypatch, jneural_flow,
              np.random.default_rng(5).standard_normal((8, 6)).astype(np.float32))
    trainable_matches_jax(tmp_path, SMALL)


def test_fresh_init_draws_as_the_jax_package():
    kw = dict(model="NeuralFlow", input_dim=8, nf_time_net="TimeFourier")
    tp, data, tobs, mask = model_batch(2, 4, 12, 6, 8)
    held = init_matches_jax(kw, dict(tp_to_predict=tp, observed_data=data, observed_tp=tobs,
                                     observed_mask=mask))
    assert {"enc_flow_l0_latent_fc1.weight", "lstm_ih.weight", "lstm_hh.weight",
            "transform_z0_1.weight"} <= set(held)
