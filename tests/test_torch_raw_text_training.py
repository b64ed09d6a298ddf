"""Training on raw-text notes, the port against the JAX package, on the CPU.

PatchTST (d_model 16, d_ff 32, 2 heads, 1 layer) + TTF_RecAvg + MMF_GR_Add
with dropout 0 on a synthetic dataset's text notes. The notes go through a
frozen GPT-2 (full width, one block, the JAX package's random init with
key 0, carried into the port by `convert.gpt2_params_from_jax`, hash
tokenizer) in the trainer's loader stage (`wrap_data_loaders`), on both of
the port's attention routes. The port's `trainable`, started from the JAX
init, is held to the JAX `trainable` (streaming loop): per-step losses to
1e-5 relative and the same best epoch. The stage goes on a copy of the
caller's `data_obj`: its loaders stay unwrapped, and a second run on it
trains as a run on a freshly parsed dataset at the same point of the
shuffle stream does. The hash tokenizer's ids depend on PYTHONHASHSEED,
so both packages run in this one process.
"""

import jax
import numpy as np
import pytest
import torch

import imm_tsf_tpu.training.trainer as jtrainer
from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.data.loader import parse_datasets as j_parse_datasets
from imm_tsf_tpu.data.synthetic import make_synthetic_dataset
from imm_tsf_tpu.fusion.fusion_model import FusionModel as JFusionModel
from imm_tsf_tpu.llm import loader as jloader
from imm_tsf_tpu.models import get_model as j_get_model

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.convert import gpt2_params_from_jax, params_from_jax
from imm_tsf_torch.data.loader import parse_datasets
from imm_tsf_torch.kernels import attn
from imm_tsf_torch.llm import loader
from imm_tsf_torch.training.trainer import _EmbedNotesLoader, trainable
from torch_port_parity import jitted_jax_init  # noqa: F401 -- autouse: JAX's init jitted

torch.set_num_threads(1)

SLICE_KW = dict(
    dataset="EPA-Air", model="PatchTST", history=7, pred_window=7, stride=7,
    time_unit="days", d_model=16, d_ff=32, n_heads=2, e_layers=1, enable_text=True,
    use_text_embeddings=False, TTF_module="TTF_RecAvg", MMF_module="MMF_GR_Add",
    llm_model_fusion="GPT2", llm_layers_fusion=1, d_txt=16, max_length=64, batch_size=8,
    epoch=2, patience=3, dropout=0.0, seed=3, lr=1e-3, w_decay=0.01, device_loop=False,
    host_prefetch=0)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """(data_root, JAX init params, per-step losses, best-epoch metrics) of
    the JAX trainable, and the JAX GPT-2's params."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("IMM_TSF_LLM_DIR", raising=False)  # the random init, key 0
        root = str(tmp_path_factory.mktemp("raw_text"))
        make_synthetic_dataset(f"{root}/EPA-Air", n_entities=3, n_features=4, n_days=80,
                               obs_per_day=1.2, notes_per_day=0.7, d_txt=16, seed=0)
        cfg = JConfig(data_root=root, **SLICE_KW)
        data = jtrainer.wrap_data_loaders(cfg, j_parse_datasets(cfg, verbose=False))
        jcfg = data["cfg"]
        rng = jax.random.key(jcfg.seed, impl=jcfg.rng_impl)
        rng, init_rng = jax.random.split(rng)
        sample = next(iter(data["train_dataloader"]))
        assert sample["notes_embeddings"].shape[-1] == 768
        params, _ = jtrainer.init_state(jcfg, j_get_model(jcfg), JFusionModel(jcfg), sample,
                                        init_rng)
        params = jax.tree_util.tree_map(np.asarray, params)
        losses = []
        build_steps = jtrainer.build_steps

        def recording_build_steps(*a, **k):
            train_step, eval_step = build_steps(*a, **k)

            def step(*args):
                out = train_step(*args)
                losses.append(float(out[-1]))
                return out

            return step, eval_step

        jtrainer.build_steps = recording_build_steps
        try:
            res = jtrainer.trainable(cfg)
        finally:
            jtrainer.build_steps = build_steps
        _, llm_params, _ = jloader.load_llm("GPT2", SLICE_KW["llm_layers_fusion"])
    return root, params, losses, res, jax.tree_util.tree_map(np.asarray, llm_params)


@pytest.fixture
def jax_gpt2(jax_run, monkeypatch):
    """The port's load_llm gives the JAX package's GPT-2 weights."""
    monkeypatch.delenv("IMM_TSF_LLM_DIR", raising=False)
    load_llm = loader.load_llm

    def load_jax_weights(*a, **k):
        model, tok = load_llm(*a, **k)
        model.load_state_dict(gpt2_params_from_jax(jax_run[4]))
        return model, tok

    monkeypatch.setattr(loader, "load_llm", load_jax_weights)


def _losses(res):
    return [x for h in res["history"] for x in h["step_losses"]]


@pytest.mark.parametrize("fused", [True, False])
def test_trainable_on_raw_text_matches_jax_trainable(jax_run, jax_gpt2, fused):
    root, params, want_losses, want, _ = jax_run
    launches = attn.launches
    got = trainable(TConfig(data_root=root, use_fused_attn=fused, **SLICE_KW), device="cpu",
                    initial_state=params_from_jax(params))
    assert attn.launches == launches  # CPU tensors: the plain attention
    got_losses = _losses(got)
    assert len(got_losses) == len(want_losses) > 3
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    assert got["best_iter"] == want["best_iter"]
    for k in ("loss", "mse", "mae"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_a_second_run_on_the_same_data_does_not_stack_stages(jax_run, jax_gpt2):
    cfg = TConfig(data_root=jax_run[0], **dict(SLICE_KW, epoch=1))
    data = parse_datasets(cfg, verbose=False)
    loaders = {k: data[k] for k in ("train_dataloader", "val_dataloader", "test_dataloader")}
    trainable(cfg, data_obj=data, device="cpu")
    assert {k: data[k] for k in loaders} == loaders  # the caller's loaders, unwrapped
    assert not any(isinstance(ld, _EmbedNotesLoader) for ld in loaders.values())
    # the shuffle stream moved on; a fresh dataset at the same point of it
    # trains the same second run
    fresh = parse_datasets(cfg, verbose=False)
    fresh["train_dataloader"]._rng.bit_generator.state = \
        data["train_dataloader"]._rng.bit_generator.state
    second = trainable(cfg, data_obj=data, device="cpu")
    assert _losses(second) == _losses(trainable(cfg, data_obj=fresh, device="cpu"))
