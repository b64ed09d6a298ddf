"""TimeMixer, the port against the JAX package, on the CPU (2e-5
absolute): `clamp_down_layers`; `PastDecomposableMixing` on three scales
with either decomposition; the model through `params_from_jax` with avg,
max and conv downsampling (the conv's flax kernel [3, in, out] reversed to
[out, in, 3]), `moving_avg` and `dft_decomp`, channel_independence 1 and 0
(one scale: with more, the JAX package's flax module refuses the second
`cross_layer` definition, and the port refuses the configuration); a
TimeMixer + TTF_RecAvg + MMF_GR_Add service against the JAX service
(1e-4); and `trainable` from the JAX init against the JAX `trainable`
(dropout 0): per-step losses to 1e-5 relative."""

import flax
import jax
import numpy as np
import pytest
import torch

from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.models import timemixer as jtimemixer

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.models import get_model, timemixer

from torch_port_parity import (assert_model_matches, model_batch, perturbed, port_state,
                               service_matches_jax, trainable_matches_jax)

torch.set_num_threads(1)

ATOL = 2e-5


@pytest.mark.parametrize("L, w, req", [(16, 2, 3), (16, 2, 9), (5, 2, 3), (1, 2, 3), (27, 3, 2)])
def test_clamp_down_layers_matches_jax(L, w, req):
    assert timemixer.clamp_down_layers(L, w, req) == jtimemixer.clamp_down_layers(L, w, req)


@pytest.mark.parametrize("decomp_method", ["moving_avg", "dft_decomp"])
def test_past_decomposable_mixing_matches_jax(decomp_method):
    kw = dict(model="TimeMixer", input_len=16, d_model=8, d_ff=12, down_sampling_window=2,
              moving_avg=5, top_k=2, decomp_method=decomp_method)
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((3, 16 // 2 ** i, 8)).astype(np.float32) for i in range(3)]
    jm = jtimemixer.PastDecomposableMixing(JConfig(**kw), 2)
    params = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), xs)["params"])
    tm = timemixer.PastDecomposableMixing(TConfig(**kw), [16, 8, 4])
    tm.load_state_dict(port_state(params))
    want = jm.apply({"params": params}, xs)
    with torch.inference_mode():
        got = tm([torch.from_numpy(x) for x in xs])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


CFG_KW = dict(model="TimeMixer", input_dim=3, input_len=16, pred_len=8, d_model=8, d_ff=16,
              e_layers=2, down_sampling_layers=3, down_sampling_window=2, moving_avg=5,
              top_k=3)


@pytest.mark.parametrize("over", [
    dict(down_sampling_method="avg"),
    dict(down_sampling_method="max"),
    dict(down_sampling_method="conv"),
    dict(down_sampling_method="avg", decomp_method="dft_decomp"),
    dict(down_sampling_method="avg", channel_independence=0, down_sampling_layers=0),
], ids=["avg", "max", "conv", "dft", "cross_layer"])
def test_timemixer_through_params_from_jax_matches_jax(over):
    kw = dict(CFG_KW, **over)
    batch = model_batch(6, B=4, L=16, Lp=8, K=3)
    short = (batch[0][:, :5], batch[1][:, :13], batch[2][:, :13], batch[3][:, :13])
    tm = get_model(TConfig(**kw))
    assert isinstance(tm, timemixer.TimeMixer)
    params = assert_model_matches(jtimemixer.TimeMixer(JConfig(**kw)), tm, batch, ATOL, short)
    if kw["down_sampling_method"] == "conv":
        assert params["down_conv_3"]["kernel"].shape == (3, 7, 7)
    if not kw.get("channel_independence", 1):
        assert "cross_layer" in params["pdm_block_0"]


def test_channel_independence_0_on_several_scales_is_refused_as_in_jax():
    kw = dict(CFG_KW, channel_independence=0)
    batch = model_batch(6, B=2, L=16, Lp=8, K=3)
    with pytest.raises(flax.errors.NameInUseError):
        jtimemixer.TimeMixer(JConfig(**kw)).init(jax.random.PRNGKey(0), *batch)
    with pytest.raises(ValueError, match="one scale only"):
        get_model(TConfig(**kw))


def test_timemixer_service_matches_jax_service(tmp_path):
    service_matches_jax(tmp_path, dict(CFG_KW, down_sampling_method="conv"))


def test_timemixer_trainable_from_jax_init_matches_jax_trainable(tmp_path):
    got = trainable_matches_jax(tmp_path, dict(
        model="TimeMixer", d_model=8, d_ff=16, e_layers=2, down_sampling_layers=3,
        down_sampling_window=2, moving_avg=5, decomp_method="dft_decomp", top_k=3))
    assert isinstance(got["model"], timemixer.TimeMixer)
