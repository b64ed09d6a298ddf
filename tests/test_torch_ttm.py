"""TTM, the port against the JAX package, on the CPU (2e-5 absolute):
`TTMLayer` in each mode (the channel mixer in mix_channel only, the patch
mixer with more than one patch only); TTM through `params_from_jax` (the
nested encoder/ap_block_<j>/mixer_<i>/... names) with the patching
apply_presets gives EPA-Air (L 36: patch 1, the dataset stride 7, 6
patches) and ILINet (L 36: patch 9, stride 4, 7 patches), with and
without the decoder, and without use_norm; a TTM + TTF_RecAvg +
MMF_GR_Add service against the JAX service (1e-4); and `trainable` from
the JAX init against the JAX `trainable` (dropout 0): per-step losses to
1e-5 relative."""

import jax
import numpy as np
import pytest
import torch

from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.config import apply_presets as j_apply_presets
from imm_tsf_tpu.layers.ttm_mlp import TTMLayer as JTTMLayer
from imm_tsf_tpu.models.ttm import TTM as JTTM

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.config import apply_presets
from imm_tsf_torch.layers.ttm_mlp import TTMLayer
from imm_tsf_torch.models import get_model, ttm

from torch_port_parity import (assert_model_matches, model_batch, perturbed, port_state,
                               service_matches_jax, trainable_matches_jax)
from torch_port_parity import jitted_jax_init  # noqa: F401 -- autouse: JAX's init jitted

torch.set_num_threads(1)

ATOL = 2e-5


@pytest.mark.parametrize("mode, num_patches", [("mix_channel", 4), ("common_channel", 4),
                                               ("mix_channel", 1)])
def test_ttm_layer_matches_jax(mode, num_patches):
    x = np.random.default_rng(2).standard_normal((2, 5, num_patches, 8)).astype(np.float32)
    jm = JTTMLayer(8, num_patches, 5, mode, 0.1)
    params = perturbed(jm.init(jax.random.PRNGKey(0), x)["params"])
    assert ("channel_feature_mixer" in params) == (mode == "mix_channel")
    assert ("patch_mixer" in params) == (num_patches > 1)
    tm = TTMLayer(8, num_patches, 5, mode, 0.1).eval()
    tm.load_state_dict(port_state(params))
    want = np.asarray(jm.apply({"params": params}, x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# the presets (d_model 1024, e_layers 3, d_layers 2, d_d_model 64, AP_levels 3) cut to 64,
# 1, 1, 16 and 2 levels; the patching is the dataset's, as apply_presets sets it
SMALL = dict(d_model=64, e_layers=1, d_layers=1, d_d_model=16, AP_levels=2)


def _presets(dataset: str, config):
    cfg = config(model="TTM", dataset=dataset, input_dim=3)
    apply = apply_presets if config is TConfig else j_apply_presets
    cfg = apply(cfg.replace(overwrite_args=True), {}, {})
    return cfg.replace(input_len=36, pred_len=36, **SMALL)


@pytest.mark.parametrize("dataset, over", [
    ("EPA-Air", {}), ("ILINet", {}), ("ILINet", dict(use_decoder=False)),
    ("EPA-Air", dict(use_norm=0))], ids=["EPA-Air", "ILINet", "ILINet-no-decoder", "no-norm"])
def test_ttm_through_params_from_jax_matches_jax(dataset, over):
    jcfg, tcfg = (_presets(dataset, c).replace(**over) for c in (JConfig, TConfig))
    patching = {"EPA-Air": (1, 7, 6), "ILINet": (9, 4, 7)}[dataset]
    assert (tcfg.patch_size, tcfg.stride, ttm.num_patches(tcfg)) == patching
    assert (jcfg.patch_size, jcfg.stride) == patching[:2]
    batch = model_batch(7, B=3, L=36, Lp=36, K=3)
    short = (batch[0][:, :20], batch[1][:, :30], batch[2][:, :30], batch[3][:, :30])
    tm = get_model(tcfg)
    assert isinstance(tm, ttm.TTM)
    params = assert_model_matches(JTTM(jcfg), tm, batch, ATOL, short)
    assert "mixer_0" in params["encoder"]["ap_block_1"]
    assert ("decoder" in params) == tcfg.use_decoder


def test_ttm_service_matches_jax_service(tmp_path):
    service_matches_jax(tmp_path, dict(model="TTM", input_dim=3, input_len=16, pred_len=8,
                                       patch_size=4, stride=4, **SMALL))


def test_ttm_trainable_from_jax_init_matches_jax_trainable(tmp_path):
    got = trainable_matches_jax(tmp_path, dict(model="TTM", patch_size=2, **SMALL))
    assert isinstance(got["model"], ttm.TTM)
