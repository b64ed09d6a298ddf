"""PatchTST training, the port against the JAX package, on the CPU.

One `EncoderLayer` in train mode with dropout on: the kernel route
(`use_fused_ffn`: kernel #2's training form and hand backward, their plain
versions on the CPU) against the plain route (the unfused FFN under
autograd), under the same salt stream: the same output, the same masks,
gradients within float32 rounding of two backward algebras (1e-5 + 1e-5
|ref|). Then the slice as a whole: the port's `trainable` started from the
JAX package's init (`params_from_jax`) against the JAX `trainable`
(streaming loop) on the same synthetic dataset, PatchTST (d_model 16,
d_ff 32, 2 heads, 1 layer) + TTF_RecAvg + MMF_GR_Add with dropout 0, on
both routes: per-step losses within 1e-5 relative and the same best epoch,
as tests/test_torch_training.py holds CRU.
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
from imm_tsf_tpu.models import get_model as j_get_model

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.convert import params_from_jax
from imm_tsf_torch.kernels import ffn as tffn
from imm_tsf_torch.layers.transformer import AttentionLayer, EncoderLayer, FullAttention
from imm_tsf_torch.training.trainer import check_trainable, trainable

torch.set_num_threads(1)

ROUTES = {"kernel": dict(use_pallas=True, use_fused_ffn=True),
          "plain": dict(use_pallas=False, use_fused_ffn=False)}


def _layer(fused: bool, act: str, seed: int = 0) -> EncoderLayer:
    torch.manual_seed(seed)
    layer = EncoderLayer(AttentionLayer(FullAttention(False, attention_dropout=0.1), 32, 2),
                         32, 64, dropout=0.2, activation=act, use_fused_ffn=fused)
    return layer.train()


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_encoder_layer_trains_alike_on_both_routes(act):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 11, 32)).astype(np.float32)
    g = rng.standard_normal((3, 11, 32)).astype(np.float32)
    res = {}
    for fused in (True, False):
        layer = _layer(fused, act)
        gen = torch.Generator().manual_seed(7)  # one salt stream, as the trainer sets it
        for m in layer.modules():
            if hasattr(m, "generator"):
                m.generator = gen
        xt = torch.from_numpy(x).requires_grad_()
        before = (tffn.launches, tffn.train_launches)
        out = layer(xt)
        out.backward(torch.from_numpy(g))
        assert (tffn.launches, tffn.train_launches) == before  # CPU: plain versions
        res[fused] = (out.detach(), xt.grad,
                      {n: p.grad for n, p in layer.named_parameters()})
    (out_k, gx_k, gp_k), (out_p, gx_p, gp_p) = res[True], res[False]
    assert torch.equal(out_k, out_p)  # the same forward arithmetic and masks
    with torch.no_grad():
        layer = _layer(False, act).eval()
        assert not torch.allclose(layer(torch.from_numpy(x)), out_p)  # dropout was on
    torch.testing.assert_close(gx_k, gx_p, atol=1e-5, rtol=1e-5)
    assert sorted(gp_k) == sorted(gp_p)
    for n in gp_p:
        torch.testing.assert_close(gp_k[n], gp_p[n], atol=1e-5, rtol=1e-5,
                                   msg=lambda m, n=n: f"{n}: {m}")


def test_patchtst_is_trainable_on_both_routes():
    for route in ROUTES.values():
        check_trainable(TConfig(model="PatchTST", enable_text=True, use_text_embeddings=True,
                                **route))


# ------------------------------------------------------------ the slice
SLICE_KW = dict(
    dataset="EPA-Air", model="PatchTST", history=7, pred_window=7, stride=7,
    time_unit="days", d_model=16, d_ff=32, n_heads=2, e_layers=1, enable_text=True,
    use_text_embeddings=True, TTF_module="TTF_RecAvg", MMF_module="MMF_GR_Add",
    llm_model_fusion="GPT2", llm_layers_fusion=6, d_txt=16, batch_size=8, epoch=3,
    patience=3, dropout=0.0, seed=3, lr=1e-3, w_decay=0.01, device_loop=False,
    host_prefetch=0, grad_clip=True)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """(data_root, JAX init params, per-step losses, best-epoch metrics)
    of the JAX trainable on a synthetic dataset."""
    root = str(tmp_path_factory.mktemp("patchtst"))
    make_synthetic_dataset(f"{root}/EPA-Air", n_entities=4, n_features=8, n_days=100,
                           obs_per_day=1.2, notes_per_day=0.7, d_txt=16, seed=0)
    cfg = JConfig(data_root=root, **SLICE_KW)
    # the JAX trainer's init: the same key split and sample batch as trainable()
    data = j_parse_datasets(cfg, verbose=False)
    jcfg = data["cfg"]
    rng = jax.random.key(jcfg.seed, impl=jcfg.rng_impl)
    rng, init_rng = jax.random.split(rng)
    params, _ = jtrainer.init_state(jcfg, j_get_model(jcfg), JFusionModel(jcfg),
                                    next(iter(data["train_dataloader"])), init_rng)
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
    return root, params, losses, res


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_trainable_from_jax_init_matches_jax_trainable(jax_run, route):
    root, params, want_losses, want = jax_run
    got = trainable(TConfig(data_root=root, **SLICE_KW, **ROUTES[route]), device="cpu",
                    initial_state=params_from_jax(params))
    got_losses = [x for h in got["history"] for x in h["step_losses"]]
    assert len(got_losses) == len(want_losses) > 3
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    assert got["best_iter"] == want["best_iter"]
    for k in ("loss", "mse", "mae", "rmse", "mape"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
