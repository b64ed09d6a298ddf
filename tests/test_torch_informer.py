"""Informer, the port against the JAX package, on the CPU.

Modules in eval, from the same weights (`params_from_jax`), to 2e-5
absolute (float32, torch vs XLA summation order): `DataEmbedding`,
`ProbAttention` (both mask flags, both layouts, L_Q != L_K), `ConvLayer`
(eval, and one train call: output and the updated BatchNorm statistics
against flax's `mutable=["batch_stats"]`), `DecoderLayer` on both FFN
routes (the kernel route runs #2's plain version on the CPU), and the
whole `Informer` with distil on and off. Then an Informer + TTF_RecAvg +
MMF_GR_Add service against the JAX service (1e-4, as
tests/test_torch_serving.py holds PatchTST's), and the port's `trainable`
from the JAX init against the JAX `trainable` on both routes (dropout 0;
per-step losses to 1e-5 relative). In train mode the JAX package draws
ProbAttention's key sample from its dropout stream, which the port cannot
reproduce: the test pins both sides to the eval sample (a monkeypatch of
each module's sampler; nothing in either package changes).

Two trained trajectories of Informer part faster than PatchTST's: the key
projections' biases get a gradient that vanishes in exact arithmetic (the
selected queries' softmax ignores a shift common to all keys, and the
top-u selection has no gradient; float64 reads 1e-19 of the largest
entry, float32 1e-10), yet the forward reads them through the sparsity
measure M. Adam turns each side's rounding noise there into steps of its
own, and the top-u sets then part at a near tie: over 3 epochs (12 steps)
the kernel route matched the JAX losses to 1.5e-6 for 10 steps, then
read 0.37 % apart at step 11, where the plain route's u-th and
(u+1)-th M differed by 1e-5. So the trainable comparison runs 2 epochs.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imm_tsf_tpu.layers.prob_attention as jpa
import imm_tsf_tpu.training.trainer as jtrainer
from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.data.loader import parse_datasets as j_parse_datasets
from imm_tsf_tpu.data.synthetic import make_synthetic_dataset
from imm_tsf_tpu.fusion.fusion_model import FusionModel as JFusionModel
from imm_tsf_tpu.layers import embed as jembed
from imm_tsf_tpu.layers import transformer as jtr
from imm_tsf_tpu.models import get_model as j_get_model

import imm_tsf_torch.layers.prob_attention as tpa
from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.convert import params_from_jax
from imm_tsf_torch.layers.embed import DataEmbedding
from imm_tsf_torch.layers.transformer import (AttentionLayer, ConvLayer, DecoderLayer)
from imm_tsf_torch.models import get_model
from imm_tsf_torch.serving import ForecastService
from imm_tsf_torch.training.checkpoint import save_experiment
from imm_tsf_torch.training.trainer import trainable

torch.set_num_threads(1)

ATOL = 2e-5
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)


def _load(module, variables):
    """Load a flax module's variables into the port's module (strict)."""
    params = np_tree(variables["params"])
    stats = {k: np_tree(v) for k, v in variables.items() if k != "params"}
    state, _ = params_from_jax({"model": params}, {"model": stats})
    module.load_state_dict(state)
    return module


def _stats_away_from_init(variables, seed):
    """BatchNorm running stats moved off (0, 1), so eval reads them."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name == "mean":
            return jnp.asarray(0.3 * rng.standard_normal(shape), jnp.float32)
        return jnp.asarray(0.5 + rng.random(shape), jnp.float32)

    out = dict(variables)
    out["batch_stats"] = jax.tree_util.tree_map_with_path(move, variables["batch_stats"])
    return out


@pytest.mark.parametrize("with_marks", [False, True])
def test_data_embedding_matches_jax(with_marks):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 12, 7)).astype(np.float32)
    marks = (rng.standard_normal((3, 12, 4)).astype(np.float32),) if with_marks else ()
    jm = jembed.DataEmbedding(32, dropout=0.1)
    v = jm.init(jax.random.PRNGKey(1), x, *marks)
    assert v["params"]["value_embedding"]["tokenConv"]["kernel"].shape == (3, 7, 32)
    tm = _load(DataEmbedding(7, 32, dropout=0.1, d_mark=4 if with_marks else None).eval(), v)
    with torch.inference_mode():
        got = tm(T(x), *(T(m) for m in marks)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, x, *marks)), atol=ATOL, rtol=0)


def test_conv_transpose_is_the_torch_weight_layout():
    """flax Conv kernel [k, in, out] -> torch Conv1d weight [out, in, k]."""
    kernel = np.arange(3 * 5 * 4, dtype=np.float32).reshape(3, 5, 4)
    state, _ = params_from_jax({"model": {"tokenConv": {"kernel": kernel}}})
    w = state["tokenConv.weight"].numpy()
    assert w.shape == (4, 5, 3)
    for k in range(3):
        np.testing.assert_array_equal(w[:, :, k], kernel[k].T)


@pytest.mark.parametrize("mask_flag,L_Q,L_K", [(False, 24, 25), (False, 19, 48),
                                               (True, 24, 24), (True, 36, 36)])
@pytest.mark.parametrize("ref_layout", [True, False])
def test_prob_attention_matches_jax(mask_flag, L_Q, L_K, ref_layout):
    rng = np.random.default_rng(L_Q * 100 + L_K)
    B, H, D = 3, 2, 8
    q = rng.standard_normal((B, L_Q, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, L_K, H, D)).astype(np.float32) for _ in range(2))
    jm = jpa.ProbAttention(mask_flag, factor=3, ref_layout=ref_layout)
    want = np.asarray(jm.apply({}, q, k, v))
    tm = tpa.ProbAttention(mask_flag, factor=3, ref_layout=ref_layout).eval()
    with torch.inference_mode():
        got = tm(T(q), T(k), T(v)).numpy()
    assert got.shape == (B, L_Q, H, D)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_prob_attention_eval_sample_is_jax_randint():
    for L_Q, U, L_K in ((24, 12, 25), (48, 12, 48), (13, 9, 19)):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (L_Q, U), 0, L_K))
        got = tpa.eval_sample(L_Q, U, L_K, torch.device("cpu"))
        np.testing.assert_array_equal(got.numpy(), want)
        assert tpa.eval_sample(L_Q, U, L_K, "cpu") is got  # made once a device


@pytest.mark.parametrize("L", [12, 13])
def test_conv_layer_matches_flax_in_eval_and_one_train_call(L):
    x = np.random.default_rng(L).standard_normal((3, L, 16)).astype(np.float32)
    jm = jtr.ConvLayer(16)
    v = _stats_away_from_init(jm.init(jax.random.PRNGKey(2), x), seed=L)
    tm = _load(ConvLayer(16), v)
    assert tuple(tm.state_dict()) == ("downConv.weight", "downConv.bias", "norm.weight",
                                      "norm.bias", "norm.running_mean", "norm.running_var")
    with torch.inference_mode():
        got = tm.eval()(T(x)).numpy()
    assert got.shape == (3, (L + 1) // 2 + 1, 16)
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, x)), atol=ATOL, rtol=0)

    want, new = jm.apply(v, x, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = tm.train()(T(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    for name, buf in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(getattr(tm.norm, buf).numpy(),
                                   np.asarray(new["batch_stats"]["norm"][name]),
                                   atol=1e-6, rtol=1e-6)


def _prob_layer(mask_flag, d, H, jax_side):
    if jax_side:
        return jtr.AttentionLayer(jpa.ProbAttention(mask_flag, 3, attention_dropout=0.0), d, H)
    return AttentionLayer(tpa.ProbAttention(mask_flag, 3, attention_dropout=0.0), d, H)


@pytest.mark.parametrize("fused", [False, True])
def test_decoder_layer_matches_jax(fused):
    rng = np.random.default_rng(5)
    d, H, F = 32, 2, 64
    x = rng.standard_normal((3, 12, d)).astype(np.float32)
    cross = rng.standard_normal((3, 7, d)).astype(np.float32)
    jm = jtr.DecoderLayer(_prob_layer(True, d, H, True), _prob_layer(False, d, H, True),
                          d, F, dropout=0.1)
    v = jm.init(jax.random.PRNGKey(3), x, cross)
    assert set(v["params"]) == {"self_attention", "cross_attention", "conv1", "conv2",
                                "norm1", "norm2", "norm3"}
    tm = _load(DecoderLayer(_prob_layer(True, d, H, False), _prob_layer(False, d, H, False),
                            d, F, dropout=0.1, use_fused_ffn=fused).eval(), v)
    with torch.inference_mode():
        got = tm(T(x), T(cross)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, x, cross)), atol=ATOL, rtol=0)


CFG_KW = dict(model="Informer", input_dim=3, input_len=12, pred_len=6, d_model=32, d_ff=64,
              n_heads=2, e_layers=2, d_layers=1, factor=3, dropout=0.1)


def _batch(B, L, Lp, C, seed):
    rng = np.random.default_rng(seed)
    mask = (rng.random((B, L, C)) < 0.7).astype(np.float32)
    data = rng.standard_normal((B, L, C)).astype(np.float32) * mask
    tp = np.sort(rng.uniform(0, 0.5, (B, L)), axis=1).astype(np.float32)
    tp_pred = np.sort(rng.uniform(0.5, 1.0, (B, Lp)), axis=1).astype(np.float32)
    return tp_pred, data, tp, mask


@pytest.mark.parametrize("distil", [True, False])
def test_informer_through_params_from_jax_matches_jax(distil):
    jcfg, tcfg = JConfig(**CFG_KW, distil=distil), TConfig(**CFG_KW, distil=distil)
    batch = _batch(4, 12, 6, 3, seed=7)
    jm = j_get_model(jcfg)
    v = jax.jit(jm.init)(jax.random.PRNGKey(4), *batch)
    if distil:
        v = _stats_away_from_init(v, seed=8)
    else:
        assert "batch_stats" not in v
    params, stats = jtrainer._split_variables(v)
    mstate, _ = params_from_jax({"model": np_tree(params)}, {"model": np_tree(stats)})
    if distil:
        np.testing.assert_array_equal(mstate["encoder.conv_layers.0.norm.running_var"],
                                      np.asarray(v["batch_stats"]["conv_layer_0"]["norm"]["var"]))
    tm = get_model(tcfg).eval()
    tm.load_state_dict(mstate)
    apply = jax.jit(jm.apply)
    want = np.asarray(apply(v, *batch))
    with torch.inference_mode():
        got = tm(*(T(a) for a in batch)).numpy()
    assert got.shape == (4, 6, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # shorter inputs are zero-padded to input_len/pred_len as in the JAX model
    short = (batch[0][:, :4], batch[1][:, :9], batch[2][:, :9], batch[3][:, :9])
    with torch.inference_mode():
        got_s = tm(*(T(a) for a in short)).numpy()
    np.testing.assert_allclose(got_s, np.asarray(apply(v, *short)), atol=ATOL, rtol=0)


def test_informer_renames_and_buffers_round_trip(tmp_path):
    """Every flax name lands on the port's module (strict load), the
    decoder's two attention blocks follow the encoder's, and the BatchNorm
    buffers survive save_experiment and the service's load."""
    cfg_kw = dict(CFG_KW, e_layers=3, d_layers=2)
    jcfg = JConfig(**cfg_kw)
    v = _stats_away_from_init(jax.jit(j_get_model(jcfg).init)(jax.random.PRNGKey(5),
                                                              *_batch(2, 12, 6, 3, 0)), seed=9)
    params, stats = jtrainer._split_variables(v)
    mstate, fstate = params_from_jax({"model": np_tree(params)}, {"model": np_tree(stats)})
    assert fstate is None
    kq = lambda i: np.asarray(params[f"AttentionLayer_{i}"]["query_projection"]["kernel"]).T
    for key, i in (("encoder.layers.2.attention", 2), ("decoder.layers.0.self_attention", 3),
                   ("decoder.layers.0.cross_attention", 4),
                   ("decoder.layers.1.self_attention", 5),
                   ("decoder.layers.1.cross_attention", 6)):
        np.testing.assert_array_equal(mstate[f"{key}.query_projection.weight"].numpy(), kq(i))
    model = get_model(TConfig(**cfg_kw))
    model.load_state_dict(mstate)  # strict: no name missing or left over
    # without stats the buffers take flax's init
    bare, _ = params_from_jax({"model": np_tree(params)})
    assert float(bare["encoder.conv_layers.1.norm.running_var"].min()) == 1.0

    scfg = TConfig(**cfg_kw, dataset="EPA-Air", history=7, pred_window=7, stride=7,
                   time_unit="days")
    save_experiment(str(tmp_path), scfg, model.state_dict(), None)
    svc = ForecastService(str(tmp_path), max_batch=2, device="cpu")
    try:
        for name, buf in svc.model.named_buffers():
            np.testing.assert_array_equal(buf.numpy(), mstate[name].numpy())
        ans = svc.forecast([{"observed_tp": [0.5, 1.0], "observed_data": [[0.1] * 3] * 2,
                             "tp_to_predict": [8.0, 9.0]}])
        assert np.isfinite(ans[0]["prediction"]).all()
    finally:
        svc.close()


# ------------------------------------------------------------ serving
D_TXT = 16
SERVE_KW = dict(CFG_KW, dataset="EPA-Air", history=7, pred_window=7, stride=7,
                time_unit="days", input_len=16, pred_len=8, enable_text=True,
                use_text_embeddings=True, TTF_module="TTF_RecAvg", MMF_module="MMF_GR_Add",
                llm_model_fusion="GPT2", d_txt=D_TXT, recency_sigma=2.0, use_pallas=True,
                use_fused_ffn=True)


def _requests(seed, k):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        n, m = int(rng.integers(0, 17)), int(rng.integers(1, 9))
        vals = rng.standard_normal((n, 3))
        vals[rng.random(vals.shape) < 0.2] = np.nan
        inst = {"observed_tp": np.sort(rng.choice(np.linspace(0, 6.99, 60), n,
                                                  replace=False)).tolist(),
                "observed_data": vals.tolist(),
                "tp_to_predict": np.sort(rng.choice(np.linspace(7.0, 14.0, 30), m,
                                                    replace=False)).tolist(),
                "notes": [{"tau": float(rng.uniform(0, 7)),
                           "embedding": rng.standard_normal(D_TXT).tolist()}
                          for _ in range(0 if i % 4 == 1 else int(rng.integers(1, 7)))]}
        if i % 3 == 0:
            inst["mean"] = rng.standard_normal(3).tolist()
            inst["std"] = (0.5 + rng.random(3)).tolist()
        out.append(inst)
    return out


def test_informer_service_matches_jax_service(tmp_path):
    from imm_tsf_tpu.data import collate as C
    from imm_tsf_tpu.data.dataset import Chunk
    from imm_tsf_tpu.serving import ForecastService as JForecastService
    from imm_tsf_tpu.training.checkpoint import save_checkpoint

    from imm_tsf_torch.config import load_saved_config

    cfg = JConfig(**SERVE_KW)
    jdir, tdir = str(tmp_path / "jax_exp"), str(tmp_path / "port_exp")
    chunk = Chunk("warm_chunk0", np.asarray([0.0, 1.0, 8.0], np.float32),
                  np.zeros((3, 3), np.float32), np.ones((3, 3), np.float32),
                  np.asarray([0.5], np.float32), [np.ones(D_TXT, np.float32)])
    batch = C.add_multimodal(C.standard_collate([chunk], 7.0, 14.0, cfg.input_len,
                                                cfg.pred_len), [chunk], True, True, 1, D_TXT)
    jm, jf = j_get_model(cfg), JFusionModel(cfg)
    params, stats = jax.jit(lambda key: jtrainer.init_state(cfg, jm, jf, batch, key))(
        jax.random.PRNGKey(3))
    params = np_tree(params)
    stats = {"model": _stats_away_from_init(stats["model"], seed=1), "fusion": stats["fusion"]}
    params["fusion"]["ttf"]["log_recency_sigma"] = np.float32(np.log(1.7))
    os.makedirs(jdir)
    with open(os.path.join(jdir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    save_checkpoint(os.path.join(jdir, "best"), params, stats, 0)
    mstate, fstate = params_from_jax(np_tree(params), np_tree(stats))
    save_experiment(tdir, load_saved_config(os.path.join(jdir, "config.json")), mstate,
                    fstate)

    insts = _requests(0, 10)
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


# ------------------------------------------------------------ training
SLICE_KW = dict(
    dataset="EPA-Air", model="Informer", history=7, pred_window=7, stride=7,
    time_unit="days", d_model=16, d_ff=32, n_heads=2, e_layers=2, d_layers=1, factor=3,
    enable_text=True, use_text_embeddings=True, TTF_module="TTF_RecAvg",
    MMF_module="MMF_GR_Add", llm_model_fusion="GPT2", llm_layers_fusion=6, d_txt=16,
    batch_size=8, epoch=2, patience=3, dropout=0.0, seed=3, lr=1e-3, w_decay=0.01,
    device_loop=False, host_prefetch=0, grad_clip=True)
ROUTES = {"kernel": dict(use_pallas=True, use_fused_ffn=True),
          "plain": dict(use_pallas=False, use_fused_ffn=False)}


def _pinned_jax():
    """The JAX module as prob_attention sees it, with randint drawing the
    eval sample whatever key it is given."""
    pinned = types.SimpleNamespace(
        PRNGKey=jax.random.PRNGKey,
        randint=lambda key, shape, lo, hi: jax.random.randint(jax.random.PRNGKey(0),
                                                               shape, lo, hi))
    return types.SimpleNamespace(random=pinned, lax=jax.lax)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("informer"))
    make_synthetic_dataset(f"{root}/EPA-Air", n_entities=4, n_features=8, n_days=100,
                           obs_per_day=1.2, notes_per_day=0.7, d_txt=16, seed=0)
    cfg = JConfig(data_root=root, **SLICE_KW)
    data = j_parse_datasets(cfg, verbose=False)
    jcfg = data["cfg"]
    rng = jax.random.key(jcfg.seed, impl=jcfg.rng_impl)
    rng, init_rng = jax.random.split(rng)
    params, stats = jtrainer.init_state(jcfg, j_get_model(jcfg), JFusionModel(jcfg),
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

    mp = pytest.MonkeyPatch()
    mp.setattr(jtrainer, "build_steps", recording_build_steps)
    mp.setattr(jpa, "jax", _pinned_jax())
    try:
        res = jtrainer.trainable(cfg)
    finally:
        mp.undo()
    return root, np_tree(params), np_tree(stats), losses, res


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_trainable_from_jax_init_matches_jax_trainable(jax_run, route, monkeypatch):
    root, params, stats, want_losses, want = jax_run
    monkeypatch.setattr(tpa, "train_sample",
                        lambda L_Q, U, L_K, device, gen: tpa.eval_sample(L_Q, U, L_K, device))
    got = trainable(TConfig(data_root=root, **SLICE_KW, **ROUTES[route]), device="cpu",
                    initial_state=params_from_jax(params, stats))
    got_losses = [x for h in got["history"] for x in h["step_losses"]]
    assert len(got_losses) == len(want_losses) > 3
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    assert got["best_iter"] == want["best_iter"]
    # MAPE is left out: it divides by near-zero targets, and the two
    # trajectories' weights part by the key biases' noise (module docstring):
    # it reads 1.8e-4 and 3.4e-4 apart on the two routes while MSE reads
    # 2.6e-5 and 5.5e-5
    for k in ("loss", "mse", "mae", "rmse"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    # the distilling BatchNorm's running stats moved in the steps
    assert float(got["model"].encoder.conv_layers[0].norm.running_var.sub(1).abs().max()) > 0
