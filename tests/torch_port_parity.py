"""Shared checks of a backbone's port against the JAX package, on the CPU:
a bare module's forward through `params_from_jax`, an experiment served
by both packages' ForecastService (with TTF_RecAvg + MMF_GR_Add), and the
port's `trainable` from the JAX init against the JAX `trainable`."""

import os

import jax
import numpy as np
import torch

import imm_tsf_tpu.training.trainer as jtrainer
from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.data.loader import parse_datasets as j_parse_datasets
from imm_tsf_tpu.data.synthetic import make_synthetic_dataset
from imm_tsf_tpu.fusion.fusion_model import FusionModel as JFusionModel
from imm_tsf_tpu.models import get_model as j_get_model

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.convert import params_from_jax
from imm_tsf_torch.serving import ForecastService
from imm_tsf_torch.training.checkpoint import save_experiment
from imm_tsf_torch.training.trainer import trainable

D_TXT = 16
# the served and trained experiment: EPA-Air's windows, TTF_RecAvg + MMF_GR_Add
EXPERIMENT = dict(dataset="EPA-Air", history=7, pred_window=7, stride=7, time_unit="days",
                  enable_text=True, use_text_embeddings=True, llm_model_fusion="GPT2",
                  d_txt=D_TXT, TTF_module="TTF_RecAvg", MMF_module="MMF_GR_Add")


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturbed(params, scale: float = 0.05):
    """Every leaf moved off its init (zero biases, unit LayerNorm scales),
    so a bias or scale the port drops or misplaces shows."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * np.random.default_rng(a.size).standard_normal(
            a.shape).astype(np.float32), params)


def port_state(params) -> dict:
    """A bare module's flax params -> the port's state dict."""
    state, _ = params_from_jax({"model": np_tree(params)})
    return state


def model_batch(seed: int, B: int, L: int, Lp: int, K: int):
    """(tp_to_predict, observed_data, observed_tp, observed_mask), a fifth of
    the values missing, the last row all zeros (a padded batch row)."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((B, L, K)).astype(np.float32)
    mask = (rng.random((B, L, K)) < 0.8).astype(np.float32)
    tp = np.sort(rng.uniform(0, 0.5, (B, L)), axis=1).astype(np.float32)
    tpp = np.sort(rng.uniform(0.5, 1.0, (B, Lp)), axis=1).astype(np.float32)
    obs[-1] = mask[-1] = tp[-1] = 0.0
    return tpp, obs * mask, tp, mask


def assert_model_matches(jm, tm, batch, atol: float, short=None):
    """jm (flax) and tm (the port, eval) on `batch`, and on `short` (inputs
    shorter than input_len / pred_len) when given, to `atol`: the JAX
    params moved off their init go through params_from_jax."""
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), *batch)
    params = perturbed(v["params"])
    tm.load_state_dict(port_state(params))
    tm.eval()
    for args in [batch] + ([short] if short is not None else []):
        want = np.asarray(jax.jit(jm.apply)({"params": params}, *args))
        with torch.inference_mode():
            got = tm(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args)).numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    return params


def service_matches_jax(tmp_path, cfg_kw: dict, n_requests: int = 10):
    """One experiment (cfg_kw + TTF_RecAvg + MMF_GR_Add, the JAX init under
    key 3) served by the JAX ForecastService and the port's on the CPU:
    every answer to 1e-4 + 1e-4|ref|."""
    from imm_tsf_tpu.data import collate as C
    from imm_tsf_tpu.data.dataset import Chunk
    from imm_tsf_tpu.serving import ForecastService as JForecastService
    from imm_tsf_tpu.training.checkpoint import save_checkpoint

    from imm_tsf_torch.config import load_saved_config

    cfg = JConfig(**{**EXPERIMENT, **cfg_kw})
    K = cfg.input_dim
    jdir, tdir = str(tmp_path / "jax_exp"), str(tmp_path / "port_exp")
    chunk = Chunk("warm_chunk0", np.asarray([0.0, 1.0, 8.0], np.float32),
                  np.zeros((3, K), np.float32), np.ones((3, K), np.float32),
                  np.asarray([0.5], np.float32), [np.ones(D_TXT, np.float32)])
    batch = C.add_multimodal(C.standard_collate([chunk], 7.0, 14.0, cfg.input_len,
                                                cfg.pred_len), [chunk], True, True, 1, D_TXT)
    jm, jf = j_get_model(cfg), JFusionModel(cfg)
    params, stats = jax.jit(lambda key: jtrainer.init_state(cfg, jm, jf, batch, key))(
        jax.random.PRNGKey(3))
    params = {"model": perturbed(params["model"], 0.02), "fusion": np_tree(params["fusion"])}
    params["fusion"]["ttf"]["log_recency_sigma"] = np.float32(np.log(1.7))
    os.makedirs(jdir)
    with open(os.path.join(jdir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    save_checkpoint(os.path.join(jdir, "best"), params, stats, 0)
    mstate, fstate = params_from_jax(params)
    save_experiment(tdir, load_saved_config(os.path.join(jdir, "config.json")), mstate,
                    fstate)

    rng = np.random.default_rng(0)
    insts = []
    for i in range(n_requests):
        n, m = int(rng.integers(0, cfg.input_len + 1)), int(rng.integers(1, cfg.pred_len + 1))
        vals = rng.standard_normal((n, K))
        vals[rng.random(vals.shape) < 0.2] = np.nan
        insts.append({
            "observed_tp": np.sort(rng.choice(np.linspace(0, 6.99, 60), n,
                                              replace=False)).tolist(),
            "observed_data": vals.tolist(),
            "tp_to_predict": np.sort(rng.choice(np.linspace(7.0, 14.0, 30), m,
                                                replace=False)).tolist(),
            "notes": [{"tau": float(rng.uniform(0, 7)),
                       "embedding": rng.standard_normal(D_TXT).tolist()}
                      for _ in range(0 if i % 4 == 1 else int(rng.integers(1, 7)))]})
    jsvc = JForecastService(jdir, max_batch=4, max_wait_ms=20.0)
    try:
        want = [f.result(timeout=300) for f in [jsvc.submit(i) for i in insts]]
    finally:
        jsvc.close()
    tsvc = ForecastService(tdir, max_batch=4, max_wait_ms=20.0, device="cpu")
    try:
        got = [f.result(timeout=300) for f in [tsvc.submit(i) for i in insts]]
        assert type(tsvc.model).__name__ == cfg.model
    finally:
        tsvc.close()
    for inst, g, w in zip(insts, got, want):
        assert g["tp"] == w["tp"]
        ga = np.asarray(g["prediction"])
        assert ga.shape == (len(inst["tp_to_predict"]), K) and np.isfinite(ga).all()
        np.testing.assert_allclose(ga, np.asarray(w["prediction"]), atol=1e-4, rtol=1e-4)


def trainable_matches_jax(tmp_path, slice_kw: dict):
    """The port's trainable from the JAX init against the JAX trainable on
    one synthetic EPA-Air fixture (dropout 0): per-step losses to 1e-5
    relative, best_iter equal, test metrics to 1e-4. Returns the port's
    result."""
    root = str(tmp_path)
    make_synthetic_dataset(f"{root}/EPA-Air", n_entities=4, n_features=3, n_days=100,
                           obs_per_day=1.2, notes_per_day=0.7, d_txt=D_TXT, seed=0)
    kw = {**EXPERIMENT, **dict(batch_size=8, epoch=2, patience=3, dropout=0.0, seed=3,
                               lr=1e-3, w_decay=0.01, device_loop=False, host_prefetch=0,
                               data_root=root), **slice_kw}
    cfg = JConfig(**kw)
    data = j_parse_datasets(cfg, verbose=False)
    jcfg = data["cfg"]
    rng = jax.random.key(jcfg.seed, impl=jcfg.rng_impl)
    rng, init_rng = jax.random.split(rng)
    params, _ = jtrainer.init_state(jcfg, j_get_model(jcfg), JFusionModel(jcfg),
                                    next(iter(data["train_dataloader"])), init_rng)
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
    got = trainable(TConfig(**kw), device="cpu", initial_state=params_from_jax(np_tree(params)))
    got_losses = [x for h in got["history"] for x in h["step_losses"]]
    assert len(got_losses) == len(losses) > 3
    np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
    assert got["best_iter"] == want["best_iter"]
    for k in ("loss", "mse", "mae", "rmse"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    return got
