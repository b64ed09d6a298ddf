"""TTF_RecAvg on notes wider or narrower than d_txt, the port against the
JAX package, on the CPU.

Flax takes `input_proj`'s input width from its init batch and draws the
layer from U(+-1/sqrt(d_model_llm)); the port takes the width as
`d_notes` (from the trainer's sample batch, or from a checkpoint when
serving) and draws from the same bound. Modules agree to 2e-5 absolute
(float32, torch vs XLA summation order, the bar of
tests/test_torch_patchtst_fusion.py) on both routes (`use_pallas` runs the
plain version on the CPU); a small PatchTST `trainable` on notes 24 wide
with d_txt 16, started from the JAX init, matches the JAX per-step losses
to 1e-5 relative, as tests/test_torch_patchtst_training.py holds it at
equal widths.
"""

import math

import jax
import numpy as np
import pytest
import torch

import imm_tsf_tpu.training.trainer as jtrainer
from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.data.loader import parse_datasets as j_parse_datasets
from imm_tsf_tpu.data.synthetic import make_synthetic_dataset
from imm_tsf_tpu.fusion.fusion_model import FusionModel as JFusionModel
from imm_tsf_tpu.fusion.ttf import TTF_RecAvg as JTTF
from imm_tsf_tpu.models import get_model as j_get_model

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.convert import params_from_jax
from imm_tsf_torch.fusion.fusion_model import FusionModel
from imm_tsf_torch.fusion.ttf import TTF_RecAvg
from imm_tsf_torch.models import get_model
from imm_tsf_torch.serving import ForecastService
from imm_tsf_torch.training.checkpoint import save_experiment
from imm_tsf_torch.training.trainer import trainable

torch.set_num_threads(1)

ATOL = 2e-5
D_MODEL_LLM = 768  # GPT-2's width: the fan-in of input_proj's init


def _notes(width, B=3, N=5, T=6, seed=0):
    """Ragged notes `width` wide: sample 0 has 2 notes, sample 2 none."""
    rng = np.random.default_rng(seed)
    mask = np.ones((B, N), np.float32)
    mask[0, 2:] = 0.0
    mask[2] = 0.0
    notes = rng.standard_normal((B, N, width)).astype(np.float32) * mask[:, :, None]
    tau = np.sort(rng.uniform(0, 5, (B, N)).astype(np.float32), axis=1) * mask
    t_hat = np.tile(np.linspace(5.0, 7.0, T, dtype=np.float32), (B, 1))
    return notes, tau, t_hat, mask


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("width,d_txt", [(16, 16), (24, 16), (40, 8)])
def test_ttf_recavg_takes_any_note_width(width, d_txt, use_pallas):
    notes, tau, t_hat, mask = _notes(width)
    jm = JTTF(d_txt=d_txt, d_model_llm=D_MODEL_LLM, recency_sigma=0.7, use_pallas=use_pallas)
    v = jm.init({"params": jax.random.PRNGKey(2)}, notes, tau, t_hat, mask)
    assert v["params"]["input_proj"]["kernel"].shape == (width, d_txt)
    state, _ = params_from_jax({"model": jax.tree_util.tree_map(np.asarray, v["params"])})
    assert tuple(state["input_proj.weight"].shape) == (d_txt, width)  # transposed
    tm = TTF_RecAvg(d_txt, D_MODEL_LLM, recency_sigma=0.7, use_pallas=use_pallas,
                    d_notes=width).eval()
    tm.load_state_dict(state)
    E_j, M_j = jm.apply(v, notes, tau, t_hat, mask)
    with torch.inference_mode():
        E_t, M_t = tm(*(torch.from_numpy(a) for a in (notes, tau, t_hat, mask)))
    assert E_t.shape == (3, 6, d_txt)
    np.testing.assert_array_equal(M_t.numpy(), np.asarray(M_j))
    np.testing.assert_allclose(E_t.numpy(), np.asarray(E_j), atol=ATOL, rtol=0)


def test_params_from_jax_transposes_a_wide_input_proj():
    kernel = np.random.default_rng(1).standard_normal((1024, 768)).astype(np.float32)
    _, fusion = params_from_jax({"model": {}, "fusion": {"ttf": {"input_proj": {
        "kernel": kernel, "bias": np.zeros(768, np.float32)}}}})
    assert tuple(fusion["ttf.input_proj.weight"].shape) == (768, 1024)
    np.testing.assert_array_equal(fusion["ttf.input_proj.weight"].numpy(), kernel.T)


def test_input_proj_init_bound_is_the_llm_fan_in():
    bound = 1.0 / math.sqrt(D_MODEL_LLM)
    torch.manual_seed(0)
    ttf = TTF_RecAvg(16, D_MODEL_LLM, d_notes=24)
    w, b = ttf.input_proj.weight.detach(), ttf.input_proj.bias.detach()
    assert tuple(w.shape) == (16, 24) and tuple(b.shape) == (16,)
    # 384 draws from U(+-bound): the largest lies within 1 % of the bound
    assert 0.99 * bound < float(w.abs().max()) <= bound
    assert float(b.abs().max()) <= bound
    cfg = TConfig(input_dim=3, enable_text=True, TTF_module="TTF_RecAvg",
                  MMF_module="MMF_GR_Add", d_txt=16, llm_model_fusion="GPT2")
    assert tuple(FusionModel(cfg, d_notes=40).ttf.input_proj.weight.shape) == (16, 40)
    assert tuple(FusionModel(cfg).ttf.input_proj.weight.shape) == (16, 16)


SLICE_KW = dict(
    dataset="EPA-Air", model="PatchTST", history=7, pred_window=7, stride=7,
    time_unit="days", d_model=16, d_ff=32, n_heads=2, e_layers=1, enable_text=True,
    use_text_embeddings=True, TTF_module="TTF_RecAvg", MMF_module="MMF_GR_Add",
    llm_model_fusion="GPT2", llm_layers_fusion=6, d_txt=16, batch_size=8, epoch=3,
    patience=3, dropout=0.0, seed=3, lr=1e-3, w_decay=0.01, device_loop=False,
    host_prefetch=0, grad_clip=True)
KERNEL_ROUTE = dict(use_pallas=True, use_fused_ffn=True)  # plain versions on the CPU
NOTE_WIDTH = 24


def test_trainable_on_wider_notes_matches_jax_trainable(tmp_path):
    root = str(tmp_path)
    make_synthetic_dataset(f"{root}/EPA-Air", n_entities=4, n_features=8, n_days=100,
                           obs_per_day=1.2, notes_per_day=0.7, d_txt=NOTE_WIDTH, seed=0)
    cfg = JConfig(data_root=root, **SLICE_KW)
    # the JAX trainer's init: the same key split and sample batch as trainable()
    data = j_parse_datasets(cfg, verbose=False)
    jcfg = data["cfg"]
    sample = next(iter(data["train_dataloader"]))
    assert sample["notes_embeddings"].shape[-1] == NOTE_WIDTH
    rng = jax.random.key(jcfg.seed, impl=jcfg.rng_impl)
    rng, init_rng = jax.random.split(rng)
    params, _ = jtrainer.init_state(jcfg, j_get_model(jcfg), JFusionModel(jcfg), sample,
                                    init_rng)
    params = jax.tree_util.tree_map(np.asarray, params)
    assert params["fusion"]["ttf"]["input_proj"]["kernel"].shape == (NOTE_WIDTH, 16)

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
        want = jtrainer.trainable(cfg)
    finally:
        jtrainer.build_steps = build_steps

    got = trainable(TConfig(data_root=root, **SLICE_KW, **KERNEL_ROUTE), device="cpu",
                    initial_state=params_from_jax(params))
    got_losses = [x for h in got["history"] for x in h["step_losses"]]
    assert len(got_losses) == len(losses) > 3
    np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
    assert got["best_iter"] == want["best_iter"]


def test_service_refuses_notes_wider_than_requests_carry(tmp_path):
    """A request's note embedding must be d_txt wide (the JAX package's
    rule), so an experiment trained on notes of another width cannot be
    served: the service says so when it loads the checkpoint."""
    cfg = TConfig(**SLICE_KW, input_dim=3, input_len=16, pred_len=8)
    save_experiment(str(tmp_path), cfg, get_model(cfg).state_dict(),
                    FusionModel(cfg, d_notes=NOTE_WIDTH).state_dict())
    with pytest.raises(ValueError, match="notes 24 wide"):
        ForecastService(str(tmp_path), device="cpu")
