"""tPatchGNN, the port against the JAX package, on the CPU:

- the torch-style encoder layer (post-LN, relu FFN 2048, fixed dropout
  0.1) in eval, and in train mode under shared hash salts
  (`pinned_salts`: four dropout sites a layer), 2e-5 absolute;
- the model on a patch-collated batch, the Linear and the CNN temporal
  aggregation, two graph layers and two hops, one patch with no point at
  all (its TTCN softmax is uniform), through params_from_jax, whose
  flax-named `Dense_<i>` land in the port's Sequentials (2e-5);
- train-mode gradients under shared salts (1e-4 of the largest entry);
- a tPatchGNN + TTF_RecAvg + MMF_GR_Add service against the JAX service
  (1e-4), and `trainable` from the JAX init against the JAX `trainable`
  under shared salts (per-step losses 1e-5 relative);
- the fresh init against the JAX `init_state` (zeros exact, std 10 %).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.models import get_model as j_get_model
from imm_tsf_tpu.models.tpatchgnn import TorchTransformerEncoderLayer as JLayer

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.models import get_model
from imm_tsf_torch.models.tpatchgnn import TorchTransformerEncoderLayer

from torch_port_parity import (assert_model_matches, init_matches_jax, perturbed, pinned_salts,
                               port_state, service_matches_jax, trainable_matches_jax)
from torch_port_parity import jitted_jax_init  # noqa: F401 -- autouse: JAX's init jitted

torch.set_num_threads(1)

ATOL = 2e-5
SMALL = dict(model="tPatchGNN", hid_dim=8, te_dim=4, node_dim=5, n_heads=2, patch_size=2,
             patch_stride=2, npatch=4)


def patch_batch(seed: int, B: int = 3, M: int = 4, L: int = 5, N: int = 3, Lp: int = 6):
    """(tp_to_predict, observed_data, observed_tp, observed_mask) in the
    patch collate's layout: each (b, patch, feature)'s points first, then
    zeros; patch 1 of sample 0 holds no point."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, L + 1, (B, M, N))
    n[0, 1] = 0
    mask = (np.arange(L)[None, None, :, None] < n[:, :, None, :]).astype(np.float32)
    tp = np.sort(rng.uniform(0, 0.5, (B, M, L, N)), axis=2).astype(np.float32) * mask
    data = rng.standard_normal((B, M, L, N)).astype(np.float32) * mask
    tpp = np.sort(rng.uniform(0.5, 1, (B, Lp)), axis=1).astype(np.float32)
    return tpp, data, tp, mask


@pytest.mark.parametrize("train", [False, True])
def test_encoder_layer_matches_jax(train, monkeypatch):
    x = np.random.default_rng(0).standard_normal((6, 4, 8)).astype(np.float32)
    jm, tm = JLayer(8, 2), TorchTransformerEncoderLayer(8, 2)
    params = perturbed(jm.init(jax.random.PRNGKey(0), x)["params"])
    tm.load_state_dict(port_state(params))
    if train:
        pinned_salts(monkeypatch, 4)
    want = jm.apply({"params": params}, x, train=train,
                    rngs={"dropout": jax.random.PRNGKey(1)} if train else None)
    got = tm.train(train)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("outlayer", ["Linear", "CNN"])
def test_tpatchgnn_matches_jax(outlayer):
    kw = dict(SMALL, input_dim=3, outlayer=outlayer, nlayer=2, hop=2)
    assert_model_matches(j_get_model(JConfig(**kw)), get_model(TConfig(**kw)), patch_batch(1),
                         ATOL)


def test_train_mode_gradients_match_jax(monkeypatch):
    batch = patch_batch(2)
    kw = dict(SMALL, input_dim=3, outlayer="CNN", nlayer=2)
    jm, tm = j_get_model(JConfig(**kw)), get_model(TConfig(**kw))
    params = perturbed(jm.init(jax.random.PRNGKey(0), *batch)["params"])
    tm.load_state_dict(port_state(params))
    pinned_salts(monkeypatch, 8)  # two layers of four sites
    g = np.random.default_rng(4).standard_normal((3, 6, 3)).astype(np.float32)

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
    pinned_salts(monkeypatch, 4)
    trainable_matches_jax(tmp_path, dict(SMALL, npatch=None))


def test_fresh_init_draws_as_the_jax_package():
    kw = dict(model="tPatchGNN", input_dim=8, npatch=4, outlayer="CNN", hid_dim=32)
    tp, data, tobs, mask = patch_batch(3, B=2, N=8)
    held = init_matches_jax(kw, dict(tp_to_predict=tp, observed_data=data, observed_tp=tobs,
                                     observed_mask=mask), seeds=range(4))
    assert {"tf_0_0.linear1.weight", "filter_generators.4.weight", "temporal_agg.weight",
            "decoder.0.weight"} <= set(held)
