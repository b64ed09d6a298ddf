"""DLinear, the port against the JAX package, on the CPU: `moving_avg` and
`series_decomp` (k 25, and an even k, which loses a row in `moving_avg`
and so cannot be subtracted in `series_decomp`, in either package),
`masked_norm`, the model in both `individual` forms through
`params_from_jax` to 2e-5 absolute; then DLinear + TTF_T2V_XAttn +
MMF_XAttn_Add (the config's default fusion pair) served against the JAX
service (1e-4, as tests/test_torch_serving.py holds PatchTST's), and the
port's `trainable` from the JAX init against the JAX `trainable` (dropout
0): per-step losses to 1e-5 relative."""

import os

import jax
import numpy as np
import pytest
import torch

import imm_tsf_tpu.training.trainer as jtrainer
from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.data.loader import parse_datasets as j_parse_datasets
from imm_tsf_tpu.data.synthetic import make_synthetic_dataset
from imm_tsf_tpu.fusion.fusion_model import FusionModel as JFusionModel
from imm_tsf_tpu.layers import decomp as jdecomp
from imm_tsf_tpu.models import get_model as j_get_model
from imm_tsf_tpu.models import base as jbase
from imm_tsf_tpu.models.dlinear import DLinear as JDLinear

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.convert import params_from_jax
from imm_tsf_torch.layers import decomp
from imm_tsf_torch.models import base, get_model
from imm_tsf_torch.models.dlinear import DLinear
from imm_tsf_torch.serving import ForecastService
from imm_tsf_torch.training.checkpoint import save_experiment
from imm_tsf_torch.training.trainer import trainable
from torch_port_parity import jitted_jax_init  # noqa: F401 -- autouse: JAX's init jitted

torch.set_num_threads(1)

ATOL = 2e-5
T = torch.from_numpy


@pytest.mark.parametrize("k", [25, 4, 3])
def test_moving_avg_and_series_decomp_match_jax(k):
    x = np.random.default_rng(k).standard_normal((3, 30, 4)).astype(np.float32)
    want = np.asarray(jdecomp.moving_avg(x, k))
    got = decomp.moving_avg(T(x), k).numpy()
    assert got.shape == want.shape == (3, 30 - (1 - k % 2), 4)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if k % 2:
        for g, w in zip(decomp.series_decomp(T(x), k), jdecomp.series_decomp(x, k)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    else:  # L - 1 rows of trend against L of x
        with pytest.raises(TypeError):
            jdecomp.series_decomp(x, k)
        with pytest.raises(RuntimeError):
            decomp.series_decomp(T(x), k)


def test_masked_norm_matches_jax():
    rng = np.random.default_rng(1)
    mask = (rng.random((4, 16, 3)) < 0.6).astype(np.float32)
    mask[0, :, 1] = 0.0  # a channel with nothing observed
    data = rng.standard_normal((4, 16, 3)).astype(np.float32) * 3 + 1
    for g, w in zip(base.masked_norm(T(data), T(mask)), jbase.masked_norm(data, mask)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


CFG_KW = dict(model="DLinear", input_dim=3, input_len=24, pred_len=12, moving_avg=25)


@pytest.mark.parametrize("individual", [False, True])
def test_dlinear_through_params_from_jax_matches_jax(individual):
    rng = np.random.default_rng(2)
    B = 4
    mask = (rng.random((B, 24, 3)) < 0.7).astype(np.float32)
    batch = (np.sort(rng.uniform(0.5, 1, (B, 12)), 1).astype(np.float32),
             rng.standard_normal((B, 24, 3)).astype(np.float32) * mask,
             np.sort(rng.uniform(0, 0.5, (B, 24)), 1).astype(np.float32), mask)
    jm = JDLinear(JConfig(**CFG_KW), individual=individual)
    v = jm.init(jax.random.PRNGKey(0), *batch)
    # move the weights off their constant init, so a transposed map shows
    v = jax.tree_util.tree_map(
        lambda a: a + 0.05 * np.random.default_rng(a.size).standard_normal(a.shape), v)
    state, _ = params_from_jax({"model": jax.tree_util.tree_map(np.asarray, v["params"])})
    tm = DLinear(TConfig(**CFG_KW), individual=individual).eval()
    tm.load_state_dict(state)
    if not individual:
        assert float(DLinear(TConfig(**CFG_KW)).trend.weight.detach().sub(1 / 24).abs().max()) == 0
    want = np.asarray(jm.apply(v, *batch))
    with torch.inference_mode():
        got = tm(*(T(a) for a in batch)).numpy()
    assert got.shape == (B, 12, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    short = (batch[0][:, :5], batch[1][:, :20], batch[2][:, :20], batch[3][:, :20])
    with torch.inference_mode():
        got_s = tm(*(T(np.ascontiguousarray(a)) for a in short)).numpy()
    np.testing.assert_allclose(got_s, np.asarray(jm.apply(v, *short)), atol=ATOL, rtol=0)


def test_default_pair_service_matches_jax_service(tmp_path):
    from imm_tsf_tpu.data import collate as C
    from imm_tsf_tpu.data.dataset import Chunk
    from imm_tsf_tpu.serving import ForecastService as JForecastService
    from imm_tsf_tpu.training.checkpoint import save_checkpoint

    from imm_tsf_torch.config import load_saved_config

    d_txt = 16
    cfg = JConfig(model="DLinear", dataset="EPA-Air", history=7, pred_window=7, stride=7,
                  time_unit="days", input_dim=3, input_len=16, pred_len=8, enable_text=True,
                  use_text_embeddings=True, llm_model_fusion="GPT2", d_txt=d_txt,
                  n_heads_fusion=2)
    assert (cfg.TTF_module, cfg.MMF_module) == ("TTF_T2V_XAttn", "MMF_XAttn_Add")
    jdir, tdir = str(tmp_path / "jax_exp"), str(tmp_path / "port_exp")
    chunk = Chunk("warm_chunk0", np.asarray([0.0, 1.0, 8.0], np.float32),
                  np.zeros((3, 3), np.float32), np.ones((3, 3), np.float32),
                  np.asarray([0.5], np.float32), [np.ones(d_txt, np.float32)])
    batch = C.add_multimodal(C.standard_collate([chunk], 7.0, 14.0, cfg.input_len,
                                                cfg.pred_len), [chunk], True, True, 1, d_txt)
    jm, jf = j_get_model(cfg), JFusionModel(cfg)
    params, stats = jax.jit(lambda key: jtrainer.init_state(cfg, jm, jf, batch, key))(
        jax.random.PRNGKey(3))
    os.makedirs(jdir)
    with open(os.path.join(jdir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    save_checkpoint(os.path.join(jdir, "best"), params, stats, 0)
    mstate, fstate = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    save_experiment(tdir, load_saved_config(os.path.join(jdir, "config.json")), mstate,
                    fstate)

    rng = np.random.default_rng(0)
    insts = []
    for i in range(10):
        n, m = int(rng.integers(0, 17)), int(rng.integers(1, 9))
        vals = rng.standard_normal((n, 3))
        vals[rng.random(vals.shape) < 0.2] = np.nan
        insts.append({
            "observed_tp": np.sort(rng.choice(np.linspace(0, 6.99, 60), n,
                                              replace=False)).tolist(),
            "observed_data": vals.tolist(),
            "tp_to_predict": np.sort(rng.choice(np.linspace(7.0, 14.0, 30), m,
                                                replace=False)).tolist(),
            "notes": [{"tau": float(rng.uniform(0, 7)),
                       "embedding": rng.standard_normal(d_txt).tolist()}
                      for _ in range(0 if i % 4 == 1 else int(rng.integers(1, 7)))]})
    jsvc = JForecastService(jdir, max_batch=4, max_wait_ms=20.0)
    try:
        want = [f.result(timeout=300) for f in [jsvc.submit(i) for i in insts]]
    finally:
        jsvc.close()
    tsvc = ForecastService(tdir, max_batch=4, max_wait_ms=20.0, device="cpu")
    try:
        got = [f.result(timeout=300) for f in [tsvc.submit(i) for i in insts]]
    finally:
        tsvc.close()
    for inst, g, w in zip(insts, got, want):
        assert g["tp"] == w["tp"]
        ga = np.asarray(g["prediction"])
        assert ga.shape == (len(inst["tp_to_predict"]), 3) and np.isfinite(ga).all()
        np.testing.assert_allclose(ga, np.asarray(w["prediction"]), atol=1e-4, rtol=1e-4)


SLICE_KW = dict(
    dataset="EPA-Air", model="DLinear", history=7, pred_window=7, stride=7,
    time_unit="days", enable_text=True, use_text_embeddings=True,
    llm_model_fusion="GPT2", llm_layers_fusion=6, d_txt=16, batch_size=8, epoch=3,
    patience=3, dropout=0.0, seed=3, lr=1e-3, w_decay=0.01, device_loop=False,
    host_prefetch=0, grad_clip=True)


def test_default_pair_trainable_from_jax_init_matches_jax_trainable(tmp_path):
    root = str(tmp_path)
    make_synthetic_dataset(f"{root}/EPA-Air", n_entities=4, n_features=8, n_days=100,
                           obs_per_day=1.2, notes_per_day=0.7, d_txt=16, seed=0)
    cfg = JConfig(data_root=root, **SLICE_KW)
    assert (cfg.TTF_module, cfg.MMF_module) == ("TTF_T2V_XAttn", "MMF_XAttn_Add")
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
        want = jtrainer.trainable(cfg)
    finally:
        jtrainer.build_steps = build_steps
    got = trainable(TConfig(data_root=root, **SLICE_KW), device="cpu",
                    initial_state=params_from_jax(params))
    got_losses = [x for h in got["history"] for x in h["step_losses"]]
    assert len(got_losses) == len(losses) > 3
    np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
    assert got["best_iter"] == want["best_iter"]
    assert isinstance(got["model"], DLinear)
    for k in ("loss", "mse", "mae", "rmse"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_get_model_builds_dlinear_and_informer():
    for name in ("DLinear", "Informer"):
        m = get_model(TConfig(model=name, input_dim=3, input_len=12, pred_len=6, d_model=16,
                              d_ff=32))
        assert type(m).__name__ == name
