"""The port's fresh init against the JAX package's, on the CPU.

For each model the JAX `init_state` is drawn under PRNG keys 0-5 and the
port's fresh modules under `torch.manual_seed(0..5)`; the tensors are
matched by their `params_from_jax` names and pooled over the seeds. Each
tensor named below is held to its family, as flax draws it in the JAX
package:

  - "zero": a flax Dense's or Conv's default bias; exactly zero on both
    sides, every seed.
  - "uniform": the JAX package's `torch_linear_kernel_init`,
    U(+-1/sqrt(fan_in)); "truncated" scale s: flax's
    variance_scaling(s, "fan_in", "truncated_normal"), lecun_normal for
    s = 1 (a Dense's or Conv's default kernel), kaiming_normal for s = 2,
    bounded by 2 sqrt(s / fan_in) / 0.8796; "normal": an Embed table,
    N(0, 1 / features). The port's std must lie within 10 % of the JAX
    one (at least 1,500 pooled draws a tensor: several of its standard
    errors), and every draw on both sides within the family's bound
    (uniform and truncated).

The models: Informer (distil, a decoder) behind the default fusion pair,
whose MMF_XAttn_Add holds the lecun-normal projections; PatchTST; and
TimeLLM (one GPT-2 block at full width), its Denses and frozen GPT-2.
"""

import re

import jax
import numpy as np
import pytest
import torch

from imm_tsf_tpu.config import MODEL_PRESETS
from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.fusion.fusion_model import FusionModel as JFusionModel
from imm_tsf_tpu.models import get_model as j_get_model
from imm_tsf_tpu.training.trainer import init_state

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.convert import params_from_jax
from imm_tsf_torch.fusion.fusion_model import FusionModel
from imm_tsf_torch.models import get_model

torch.set_num_threads(1)

SEEDS = range(6)
STD_BAND = 0.10
TRUNC_STD = 0.87962566103423978  # std of the unit normal truncated to [-2, 2]

PROJ = r"(query|key|value|out)_projection"
FAMILIES = (  # (name pattern, family); the first match decides
    (rf"\.{PROJ}\.bias$", "zero"), (rf"\.{PROJ}\.weight$", "uniform"),
    (r"\.conv[12]\.bias$", "zero"), (r"\.conv[12]\.weight$", "uniform"),
    (r"\.downConv\.bias$", "zero"), (r"\.downConv\.weight$", ("truncated", 1.0)),
    (r"^decoder\.projection\.bias$", "zero"), (r"^decoder\.projection\.weight$", "uniform"),
    (r"^head_linear\.bias$", "zero"), (r"^head_linear\.weight$", "uniform"),
    (r"\.tokenConv\.weight$", ("truncated", 2.0)),
    (r"^fusion\.mmf\.proj_[qkv]\.weight$", ("truncated", 1.0)),
    (r"^(mapping_layer|stat_prompt|output_projection)\.bias$", "zero"),
    (r"^(mapping_layer|stat_prompt|output_projection)\.weight$", "uniform"),
    (r"^patch_embedding\.value_embedding\.weight$", "uniform"),
    (r"^frozen_llm\.h\.\d+\.c_\w+\.bias$", "zero"),
    (r"^frozen_llm\.h\.\d+\.c_\w+\.weight$", ("truncated", 1.0)),
    (r"^frozen_llm\.w[tp]e\.weight$", "normal"),
)

BASE = dict(dataset="EPA-Air", input_dim=8, input_len=24, pred_len=12, d_model=32, d_ff=64,
            n_heads=2, d_txt=64)
MODELS = {
    "Informer": dict(BASE, model="Informer", enable_text=True, use_text_embeddings=True,
                     TTF_module="TTF_T2V_XAttn", MMF_module="MMF_XAttn_Add",
                     **MODEL_PRESETS["Informer"]),
    "PatchTST": dict(BASE, model="PatchTST", **MODEL_PRESETS["PatchTST"]),
    "TimeLLM": dict(BASE, model="TimeLLM", stride=4, ts_vocab_size=64,
                    **dict(MODEL_PRESETS["TimeLLM"], d_model=64, llm_layers_timellm=1,
                           input_token_len=4)),
}
# every tensor of the port's init repair, and each of TimeLLM's Denses
EXPECTED = {
    "Informer": ["encoder.layers.0.attention.query_projection.bias",
                 "decoder.layers.0.cross_attention.out_projection.bias",
                 "encoder.layers.1.conv1.bias", "decoder.layers.0.conv2.bias",
                 "encoder.conv_layers.0.downConv.weight", "encoder.conv_layers.0.downConv.bias",
                 "decoder.projection.bias", "enc_embedding.value_embedding.tokenConv.weight",
                 "fusion.mmf.proj_q.weight", "fusion.mmf.proj_k.weight",
                 "fusion.mmf.proj_v.weight"],
    "PatchTST": ["head_linear.bias", "head_linear.weight", "encoder.layers.0.conv1.bias",
                 "encoder.layers.0.attention.value_projection.bias"],
    "TimeLLM": ["stat_prompt.weight", "stat_prompt.bias", "mapping_layer.weight",
                "mapping_layer.bias", "reprogramming_layer.query_projection.bias",
                "reprogramming_layer.key_projection.weight",
                "reprogramming_layer.out_projection.bias", "output_projection.weight",
                "output_projection.bias", "patch_embedding.value_embedding.weight",
                "frozen_llm.h.0.c_attn.weight", "frozen_llm.h.0.c_fc.bias",
                "frozen_llm.wte.weight"],
}


def _batch(cfg, B=4, N=3, seed=0):
    rng = np.random.default_rng(seed)
    L, Lp, C = cfg.input_len, cfg.pred_len, cfg.input_dim
    return dict(
        tp_to_predict=np.sort(1 + rng.random((B, Lp)), 1).astype(np.float32),
        observed_data=rng.standard_normal((B, L, C)).astype(np.float32),
        observed_tp=np.sort(rng.random((B, L)), 1).astype(np.float32),
        observed_mask=np.ones((B, L, C), np.float32),
        data_to_predict=rng.standard_normal((B, Lp, C)).astype(np.float32),
        mask_predicted_data=np.ones((B, Lp, C), np.float32),
        notes_embeddings=rng.standard_normal((B, N, cfg.d_txt)).astype(np.float32),
        tau=rng.random((B, N)).astype(np.float32), notes_mask=np.ones((B, N), np.float32))


def _named(model_state, fusion_state) -> dict:
    out = dict(model_state)
    out.update({f"fusion.{k}": v for k, v in (fusion_state or {}).items()})
    return {k: v.float().numpy() for k, v in out.items() if v.is_floating_point()}


@pytest.fixture(scope="module", params=sorted(MODELS))
def draws(request):
    """(model name, {tensor name: (JAX draws, port draws)}) over SEEDS."""
    kw = MODELS[request.param]
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    batch = _batch(jcfg)
    fusion = JFusionModel(jcfg) if jcfg.enable_text else None
    init = jax.jit(lambda key: init_state(jcfg, j_get_model(jcfg), fusion, batch, key)[0])
    jax_draws, port_draws = {}, {}
    for seed in SEEDS:
        params = init(jax.random.PRNGKey(seed))
        for k, v in _named(*params_from_jax(jax.tree_util.tree_map(np.asarray, params))).items():
            jax_draws.setdefault(k, []).append(v)
        torch.manual_seed(seed)
        model = get_model(tcfg)
        fusion = FusionModel(tcfg).state_dict() if tcfg.enable_text else None
        for k, v in _named(model.state_dict(), fusion).items():
            port_draws.setdefault(k, []).append(v)
    assert sorted(jax_draws) == sorted(port_draws)
    return request.param, {k: (np.stack(jax_draws[k]), np.stack(port_draws[k]))
                           for k in jax_draws}


def _family(name):
    for pattern, family in FAMILIES:
        if re.search(pattern, name):
            return family
    return None


def test_fresh_init_draws_as_the_jax_package(draws):
    model, tensors = draws
    checked = {n: f for n in tensors if (f := _family(n)) is not None}
    assert set(EXPECTED[model]) <= set(checked), sorted(set(EXPECTED[model]) - set(checked))
    for name, family in sorted(checked.items()):
        want, got = tensors[name]
        assert want.shape == got.shape, name
        if family == "zero":
            assert not want.any(), name
            assert not got.any(), f"{name}: the port's bias is not exactly zero"
            continue
        assert want.size >= 1500, name
        ratio = got.std() / want.std()
        assert abs(ratio - 1) <= STD_BAND, f"{name}: std {got.std():.4g} vs JAX {want.std():.4g}"
        if family == "normal":
            continue
        shape = want.shape[1:]  # [out, in] or a conv's [out, in, k]
        fan_in = int(np.prod(shape[1:]))
        if family == "uniform":
            limit = 1.0 / np.sqrt(fan_in)
        else:
            limit = 2.0 * np.sqrt(family[1] / fan_in) / TRUNC_STD
        for side, arr in (("JAX", want), ("port", got)):
            assert np.abs(arr).max() <= limit * (1 + 1e-6), \
                f"{name}: a {side} draw {np.abs(arr).max():.4g} beyond {limit:.4g}"
