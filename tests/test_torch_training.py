"""The port's training path against the JAX package, on the CPU.

Evaluation functions and the optimizer against their JAX counterparts
(float32 in another summation order: metrics 1e-6 of the largest value; Adam after
the global-norm clip within 1e-6 over 5 steps: torch's clip adds 1e-6 to
the norm, optax does not), hash dropout bit for bit given the same
salts, and the slice as a whole: the port's `trainable` started from the
JAX package's init against the JAX `trainable` (streaming loop) on the
same synthetic dataset, CRU + TTF_RecAvg + MMF_GR_Add at a small width
with dropout 0, on both of the port's scan routes. Per-step losses agree
within 1e-5 relative and the best epoch's metrics within 1e-4 (float32
rounding of the Kalman scan, carried through a few Adam steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import imm_tsf_tpu.training.trainer as jtrainer
from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.data.loader import parse_datasets as j_parse_datasets
from imm_tsf_tpu.data.synthetic import make_synthetic_dataset
from imm_tsf_tpu.fusion.fusion_model import FusionModel as JFusionModel
from imm_tsf_tpu.layers.fast_dropout import _hash_dropout
from imm_tsf_tpu.models import get_model as j_get_model
from imm_tsf_tpu.training import evaluation as jev
from imm_tsf_tpu.training.optim import make_optimizer as j_make_optimizer

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.convert import params_from_jax
from imm_tsf_torch.layers.fast_dropout import Dropout, draw_salts, hash_dropout
from imm_tsf_torch.training import evaluation as tev
from imm_tsf_torch.training.optim import clip_and_step, make_optimizer
from imm_tsf_torch.training.trainer import check_trainable, trainable

torch.set_num_threads(1)


def _pred_truth_mask(seed=0, B=6, T=9, D=4):
    """Some masks empty (padding rows, an unobserved variable) and some
    truths exactly 0 (MAPE's guard)."""
    rng = np.random.default_rng(seed)
    truth = rng.standard_normal((B, T, D)).astype(np.float32)
    truth[0, :3] = 0.0
    pred = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = (rng.random((B, T, D)) < 0.6).astype(np.float32)
    mask[-1] = 0.0  # a padding row
    mask[..., 2] = 0.0  # a variable never observed
    return pred, truth, mask


@pytest.mark.parametrize("func", ["MSE", "MAE", "MAPE"])
@pytest.mark.parametrize("reduce", ["mean", "sum"])
def test_compute_error_matches_jax(func, reduce):
    pred, truth, mask = _pred_truth_mask()
    want = jev.compute_error(jnp.asarray(truth), jnp.asarray(pred), jnp.asarray(mask),
                             func, reduce)
    got = tev.compute_error(torch.from_numpy(truth), torch.from_numpy(pred),
                            torch.from_numpy(mask), func, reduce)
    for g, w in zip(got if reduce == "sum" else [got], want if reduce == "sum" else [want]):
        w = np.asarray(w)  # sums of float32 terms in another order: 1e-6 of the largest
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max())


def test_loss_sums_and_metrics_match_jax():
    pred, truth, mask = _pred_truth_mask(1)
    t = [torch.from_numpy(a) for a in (pred, truth, mask)]
    j = [jnp.asarray(a) for a in (pred, truth, mask)]
    np.testing.assert_allclose(tev.masked_mse_loss(*t).numpy(),
                               np.asarray(jev.masked_mse_loss(*j)), rtol=1e-6)
    got, want = tev.batch_error_sums(*t), jev.batch_error_sums(*j)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max(),
                                   err_msg=k)
    acc = {k: np.asarray(v, np.float64) for k, v in want.items()}
    assert tev.finalize_metrics(acc) == jev.finalize_metrics(acc)
    batches = [dict(zip(("pred", "truth", "mask"), _pred_truth_mask(s))) for s in (2, 3)]
    got = tev.evaluation(lambda b: tuple(torch.from_numpy(b[k]) for k in ("pred", "truth", "mask")),
                         batches)
    want = jev.evaluation(lambda b: jnp.asarray(b["pred"]),
                          [dict(b, data_to_predict=b["truth"], mask_predicted_data=b["mask"])
                           for b in batches])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_optimizer_matches_optax_chain():
    """Clip to global norm 1, L2 into the gradient, Adam: 5 steps, some
    gradients above the clip norm and some below."""
    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    tx = j_make_optimizer(1e-2, 0.01, clip_norm=1.0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p0[k].copy())) for k in ("w", "b")]
    opt = make_optimizer(tp, 1e-2, 0.01)
    for step, scale in enumerate((3.0, 0.1, 1.5, 0.05, 10.0)):
        grads = {k: (rng.standard_normal(p0[k].shape) * scale).astype(np.float32) for k in p0}
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, k in zip(tp, ("w", "b")):
            p.grad = torch.from_numpy(grads[k].copy())
        clip_and_step(opt, tp, 1.0)
        for p, k in zip(tp, ("w", "b")):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6,
                                       rtol=0, err_msg=f"{k} step {step}")


def test_frozen_parameters_take_no_update():
    from imm_tsf_torch.training.optim import trainable_parameters

    m = torch.nn.Module()
    m.head = torch.nn.Linear(2, 2)
    m.frozen_llm = torch.nn.Linear(2, 2)
    assert trainable_parameters(m, None) == list(m.head.parameters())


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_dropout_is_bit_identical_to_jax_hash_dropout(rate):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 40)).astype(np.float32)
    g = rng.standard_normal((3, 7, 40)).astype(np.float32)
    layer = Dropout(rate).train()
    layer.generator = torch.Generator().manual_seed(5)
    s0, s1 = draw_salts(torch.Generator().manual_seed(5))  # the salts the layer draws
    xt = torch.from_numpy(x).requires_grad_()
    out = layer(xt)
    (gt,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    want, vjp = jax.vjp(lambda a: _hash_dropout(a, jnp.uint32(s0), jnp.uint32(s1), 1.0 - rate,
                                                x.shape), jnp.asarray(x))
    (wg,) = vjp(jnp.asarray(g))
    assert np.array_equal(out.detach().numpy(), np.asarray(want))
    assert np.array_equal(gt.numpy(), np.asarray(wg))
    assert torch.equal(hash_dropout(xt, s0, s1, 1.0 - rate), out)
    assert torch.equal(layer.eval()(xt), xt)


def test_refused_configurations_name_their_slice():
    base = dict(model="CRU", enable_text=True, use_text_embeddings=True)
    for kw, match in ((dict(dropout_impl="flax"), "Queue 1, item 19"),
                      (dict(mesh_shape=(2,)), "Queue 1, item 16")):
        with pytest.raises(NotImplementedError, match=match):
            check_trainable(TConfig(**dict(base, **kw)))
    # kernel #3 has its backward and raw-text notes have their loader stage
    for kw in ({}, dict(model="PatchTST", use_fused_ffn=True, use_fused_attn=True),
               dict(use_fused_attn=True), dict(use_text_embeddings=False),
               dict(model="TimeLLM", use_fused_attn=True, timellm_exact_prompt=True)):
        check_trainable(TConfig(**dict(base, **kw)))


# ------------------------------------------------------------ the slice
SLICE_KW = dict(
    dataset="EPA-Air", model="CRU", history=7, pred_window=7, stride=7, time_unit="days",
    cru_lsd=8, cru_hidden_units=16, enable_text=True, use_text_embeddings=True,
    TTF_module="TTF_RecAvg", MMF_module="MMF_GR_Add", llm_model_fusion="GPT2",
    llm_layers_fusion=6, d_txt=16, batch_size=8, epoch=3, patience=3, dropout=0.0, seed=3,
    lr=1e-3, w_decay=0.01, device_loop=False, host_prefetch=0, grad_clip=True)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """(data_root, JAX init params, per-step losses, best-epoch metrics)
    of the JAX trainable on a synthetic dataset."""
    root = str(tmp_path_factory.mktemp("slice"))
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


@pytest.mark.parametrize("fused", [False, True])
def test_trainable_from_jax_init_matches_jax_trainable(jax_run, fused, monkeypatch):
    root, params, want_losses, want = jax_run
    if fused:
        monkeypatch.setenv("IMM_TSF_CRU_FUSED", "1")
    got = trainable(TConfig(data_root=root, **SLICE_KW), device="cpu",
                    initial_state=params_from_jax(params))
    got_losses = [x for h in got["history"] for x in h["step_losses"]]
    assert len(got_losses) == len(want_losses) > 3
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    assert got["best_iter"] == want["best_iter"]
    for k in ("loss", "mse", "mae", "rmse", "mape"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_trained_experiment_is_served(jax_run, tmp_path):
    """trainable(checkpoint_dir=...) writes what ForecastService loads."""
    from imm_tsf_torch.serving import ForecastService

    root = jax_run[0]
    exp = str(tmp_path / "exp")
    res = trainable(TConfig(data_root=root, **dict(SLICE_KW, epoch=1)), device="cpu",
                    checkpoint_dir=exp)
    svc = ForecastService(exp, max_batch=4, max_wait_ms=5.0, device="cpu")
    try:
        inst = {"observed_tp": [0.5, 2.0, 5.5], "observed_data": [[0.1] * 8] * 3,
                "tp_to_predict": [7.5, 9.0],
                "notes": [{"tau": 1.0, "embedding": [0.3] * 16}]}
        out = svc.submit(inst).result(timeout=120)
    finally:
        svc.close()
    pred = np.asarray(out["prediction"])
    assert pred.shape == (2, 8) and np.isfinite(pred).all()
    assert res["best_iter"] == 0
