"""compute_dtype="amp_bf16" in training and through the port's entry
points, on the CPU (the forward, the dtype map and the pieces are
tests/test_torch_amp.py, whose helpers this file shares):

  - one amp training step of each MTS/LMTS backbone against the JAX
    package's (strict_jit: XLA's excess precision off, so every bf16 op
    rounds as the program states it): the loss, the f32 masters'
    gradients and the updated masters; Informer's BatchNorm statistics stay
    f32;
  - `python -m imm_tsf_torch.main --compute_dtype amp_bf16`: the epoch
    loop against streaming, and --load resume, bit for bit;
  - the stacked-replica sweep: a replica against its single run, bit for
    bit;
  - an amp ForecastService against make_forward's amp eval;
  - predict under amp against the JAX package's predict.py;
  - an exported amp artifact against the live service;
  - `main_all --compute_dtype amp_bf16`."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imm_tsf_tpu.training.trainer as jtrainer
from imm_tsf_tpu.training.optim import make_optimizer as j_make_optimizer

from imm_tsf_torch.convert import params_from_jax
from imm_tsf_torch.training import trainer
from imm_tsf_torch.training.optim import clip_and_step, make_optimizer, trainable_parameters

from test_torch_amp import MODELS, _batch, _cfg, _jax_state, _np, _port, _tensors, strict_jit
from torch_port_parity import pinned_salts
from torch_port_parity import jitted_jax_init  # noqa: F401 -- autouse: JAX's init jitted

torch.set_num_threads(1)


# ------------------------------------------------------------ training
def _score(got: np.ndarray, want: np.ndarray, floor: float) -> float:
    """||got - want|| / (||want|| + floor sqrt(n)): the tensor's relative
    error, floored at `floor` an element (a thousandth of the largest
    gradient of the step, so a gradient that is rounding noise, as a key
    projection's bias's under a softmax, is held to the step's scale)."""
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + floor * np.sqrt(want.size)))


# The step's scores (_score), largest over the loss and the masters'
# gradients. The gradients reach the f32 masters through the bf16 cast
# (each rounded to bf16, as JAX's astype VJP rounds it), and a bf16 backward
# rounds at other points in torch's autograd than in JAX's, so the
# bf16-end-to-end models and the bf16 layers score a few bf16 ulps (2^-8
# relative each); a gradient that is noise scores more (TimeLLM's worst is
# the reprogramming key projection's bias, which the softmax cancels).
# Adam's first step moves every master by about lr in its gradient's sign,
# which rounding noise flips where the gradient is noise: 99 % of the
# updated masters are held to a tenth of lr. Measured worst scores:
# DLinear 0.0049 (seasonal.bias), Informer 6.7e-5, PatchTST 3.8e-4,
# TimesNet 0.0031, TimeMixer 2.6e-6, TimeLLM 0.056, TTM 0.042.
STEP_TOL = {"DLinear": 0.02, "Informer": 1e-3, "PatchTST": 2e-3, "TimesNet": 0.01,
            "TimeMixer": 1e-3, "TimeLLM": 0.1, "TTM": 0.1}
STEP_KW = {"Informer": dict(factor=100),  # every query selected: the key sample has no effect
           "TTM": dict(dropout=0.1)}      # salts pinned on both sides


@pytest.mark.parametrize("model", MODELS)
def test_training_step_matches_jax(model, monkeypatch):
    """One amp step from the same state: the loss, each f32 master's gradient
    and the masters after clip + Adam, scored by _score against STEP_TOL.
    Dropout 0 except TTM's (both packages' salts pinned); the BatchNorm
    statistics stay f32."""
    kw = dict(dict(dropout=0.0), **STEP_KW.get(model, {}))
    jcfg, batch = _cfg(model, True, **kw), _batch(1)
    if jcfg.dropout > 0:
        pinned_salts(monkeypatch, 64)
    jm, jf, params, stats = _jax_state(jcfg, batch)
    dev = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_fn = jtrainer.make_loss_fn(jtrainer.make_forward(jcfg, jm, jf))
    (jloss, jstats), jgrads = strict_jit(jax.value_and_grad(loss_fn, has_aux=True),
                                         params, stats, dev, jax.random.PRNGKey(5))
    tx = j_make_optimizer(jcfg.lr, jcfg.w_decay)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    want_p = params_from_jax(_np(jax.tree_util.tree_map(lambda p, u: p + u, params, updates)))
    want_g = params_from_jax(_np(jgrads))

    tcfg, tm, tf = _port(jcfg, params, stats)
    tm.train(), tf.train()
    tparams = trainable_parameters(tm, tf)
    loss = trainer.make_loss_fn(trainer.make_forward(tcfg, tm, tf))(_tensors(batch))
    loss.backward()
    scores = {"loss": abs(float(loss) - float(jloss)) / abs(float(jloss))}
    floor = 1e-3 * max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(_np(jgrads)))
    for mod, wg in ((tm, want_g[0]), (tf, want_g[1])):
        for n, p in mod.named_parameters():
            if p.requires_grad:
                w = wg[n].numpy()
                if p.grad is None:  # a parameter the forward does not reach: JAX's is 0
                    assert not w.any(), n
                    continue
                assert p.grad.dtype == torch.float32, n
                scores[f"grad {n}"] = _score(p.grad.numpy(), w, floor)
    worst = max(scores, key=scores.get)
    print(f"{model}: worst {worst} {scores[worst]:.3g}")
    assert scores[worst] <= STEP_TOL[model], (worst, scores[worst])
    clip_and_step(make_optimizer(tparams, jcfg.lr, jcfg.w_decay), tparams, 1.0)
    moved = [(p.detach().numpy(), wp[n].numpy()) for mod, wp in ((tm, want_p[0]), (tf, want_p[1]))
             for n, p in mod.named_parameters() if p.grad is not None]
    assert all(p.dtype == np.float32 for p, _ in moved)
    close = np.concatenate([(np.abs(p - w) <= 0.1 * jcfg.lr).ravel() for p, w in moved])
    assert close.mean() >= 0.99, close.mean()
    if model == "Informer":  # the distilling BatchNorms' statistics: f32, moved as JAX's
        bufs = {n: b for n, b in tm.named_buffers() if "running" in n}
        want_s = params_from_jax(params, _np(jstats))[0]
        assert bufs
        for n, b in bufs.items():
            assert b.dtype == torch.float32, n
            np.testing.assert_allclose(b.numpy(), want_s[n].numpy(), atol=1e-5, rtol=0,
                                       err_msg=n)


# --------------------------------------------------------- entry points
def _main_flags(root, model="PatchTST"):
    return ["--dataset", "EPA-Air", "--data_root", root, "--model", model, "--history", "7",
            "--pred_window", "7", "--stride", "7", "--enable_text", "--use_text_embeddings",
            "--d_txt", "16", "--TTF_module", "TTF_RecAvg", "--MMF_module", "MMF_GR_Add",
            "--batch_size", "8", "--d_model", "16", "--d_ff", "32", "--n_heads", "2",
            "--e_layers", "1", "--dropout", "0.1", "--use_pallas", "--use_fused_ffn",
            "--compute_dtype", "amp_bf16", "--device", "cpu"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from imm_tsf_torch.data.synthetic import make_synthetic_dataset

    root = str(tmp_path_factory.mktemp("amp"))
    make_synthetic_dataset(f"{root}/EPA-Air", n_entities=4, n_features=3, n_days=100,
                           obs_per_day=1.2, notes_per_day=0.7, d_txt=16, seed=0)
    return root


def _losses(res):
    return [x for h in res["history"] for x in h["step_losses"]]


def _same_weights(a, b):
    for mod in ("model", "fusion"):
        sa, sb = a[mod].state_dict(), b[mod].state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


def test_main_epoch_loop_equals_streaming_and_resumes(root, tmp_path):
    """PatchTST + the pair on kernel #2's route, dropout 0.1, under amp:
    the epoch loop equals streaming, and a run stopped after epoch 0 and
    resumed with --load equals the uninterrupted one, bit for bit."""
    from imm_tsf_torch import main as tmain

    flags = _main_flags(root) + ["--epoch", "2", "--patience", "5"]
    loop = tmain.main(flags + ["--save", str(tmp_path / "loop")])
    stream = tmain.main(flags + ["--device_loop", "false", "--save", str(tmp_path / "stream")])
    assert _losses(loop) == _losses(stream) and len(_losses(loop)) >= 4
    _same_weights(loop, stream)
    assert np.isfinite(_losses(loop)).all()
    save = str(tmp_path / "res")
    tmain.main(_main_flags(root) + ["--epoch", "1", "--patience", "5", "--save", save])
    exp = os.listdir(save)[0].split("experiment_")[1]
    resumed = tmain.main(flags + ["--save", save, "--load", exp])
    assert _losses(resumed) == _losses(loop)
    _same_weights(resumed, loop)
    for p in resumed["model"].parameters():  # the masters stay f32
        assert p.dtype == torch.float32


def test_sweep_replica_equals_its_single_run(root, tmp_path):
    """`--vmap_seeds 2` under amp: replica 1 equals the single run of its
    seed on the sweep's data seed, bit for bit."""
    from imm_tsf_torch import main as tmain

    flags = _main_flags(root) + ["--epoch", "1"]
    sweep = tmain.main(flags + ["--vmap_seeds", "2", "--seed", "3",
                                "--save", str(tmp_path / "sweep")])
    single = tmain.main(flags + ["--seed", "4", "--data_seed", "3",
                                 "--save", str(tmp_path / "single")])
    assert [r["seed"] for r in sweep] == [3, 4]
    assert _losses(sweep[1]) == _losses(single)
    _same_weights(sweep[1], single)


@pytest.mark.parametrize("model", ["PatchTST", "DLinear"])
def test_service_equals_make_forward_eval(tmp_path, model):
    """An amp ForecastService (PatchTST on kernel #2's route, DLinear) answers
    as make_forward's amp eval of the same weights on the same collated
    batch (rtol 1e-5, atol 1e-6: a dispatch may batch the requests
    otherwise)."""
    from imm_tsf_torch.serving import ForecastService, _build_chunk, gather_results, \
        restore_modules
    from imm_tsf_torch.training.checkpoint import load_weights

    from test_torch_export import LIVE_TOL, _port_experiment
    from torch_port_parity import assert_answers_match, mixed_requests

    exp = str(tmp_path / "exp")
    kw = dict(e_layers=1, use_pallas=True, use_fused_ffn=True) if model == "PatchTST" else {}
    cfg = _port_experiment(exp, model=model, compute_dtype="amp_bf16", **kw)
    insts = mixed_requests(cfg, 8)
    svc = ForecastService(exp, max_batch=8, max_wait_ms=20.0, device="cpu")
    try:
        got = svc.forecast(insts)
        built = [_build_chunk(i, cfg, svc.d_txt) for i in insts]
        out = svc._collate([b[0] for b in built])
    finally:
        svc.close()
    model_, fusion = restore_modules(cfg, load_weights(os.path.join(exp, "best")), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in out.items() if isinstance(v, np.ndarray)}
    with torch.inference_mode():
        pred = trainer.make_forward(cfg, model_, fusion)(batch).numpy()
    want = gather_results(cfg, built, out, pred)
    assert_answers_match(insts, got, want, cfg.input_dim, **LIVE_TOL)


def test_predict_matches_the_jax_predict_script(synth_root, tmp_path):
    """A DLinear experiment trained under amp by the JAX package's main.py,
    converted, predicted by both entry points under amp: the same windows
    in the same order, predictions to 2^-7 (atol and rtol). DLinear's amp
    forward equals JAX's op by op (tests/test_torch_amp.py), but predict.py
    runs it jitted with XLA's excess precision on, which keeps some bf16
    intermediates in f32: measured up to 3.9e-3 (2^-8, a bf16 ulp of the
    forecasts of order 1)."""
    import main as jax_main
    import predict as jax_predict
    from imm_tsf_tpu.training.checkpoint import load_checkpoint

    from imm_tsf_torch import predict
    from imm_tsf_torch.config import load_saved_config
    from imm_tsf_torch.training.checkpoint import save_experiment

    flags = ["--dataset", "EPA-Air", "--model", "DLinear", "--batch_size", "8",
             "--compute_dtype", "amp_bf16", "--data_root", synth_root]
    jsave, tsave = str(tmp_path / "jax_ckpts"), str(tmp_path / "port_ckpts")
    jax_main.main(flags + ["--epoch", "1", "--patience", "1", "--save", jsave, "--seed", "3"])
    exp = os.listdir(jsave)[0].split("experiment_")[1]
    jdir = os.path.join(jsave, f"experiment_{exp}")
    params, stats, step = load_checkpoint(os.path.join(jdir, "best"))
    mstate, fstate = params_from_jax(_np(params), _np(stats))
    tcfg = load_saved_config(os.path.join(jdir, "config.json"))
    assert tcfg.compute_dtype == "amp_bf16"
    save_experiment(os.path.join(tsave, f"experiment_{exp}"), tcfg, mstate, fstate, step)
    common = ["--load", exp, "--data_root", synth_root, "--split", "val"]
    want = jax_predict.main(common + ["--save", jsave, "--out", str(tmp_path / "j.npz")])
    got = predict.main(common + ["--save", tsave, "--device", "cpu",
                                 "--out", str(tmp_path / "t.npz")])
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    np.testing.assert_array_equal(zt["tp_to_predict"], zj["tp_to_predict"])
    np.testing.assert_allclose(zt["pred"], zj["pred"], rtol=2.0**-7, atol=2.0**-7)
    assert got["n_windows"] == want["n_windows"]
    assert abs(got["val_mse"] - want["val_mse"]) <= 2.0**-7 * want["val_mse"]


def test_exported_artifact_equals_the_live_service(tmp_path):
    """An amp PatchTST on kernel #2's route exported on the CPU: meta.json
    records the compute dtype, the program casts the weights to bf16 at run
    time and calls the FFN op with them, and its answers equal the live
    service's (rtol 1e-5, atol 1e-6: tests/test_torch_export.py)."""
    from imm_tsf_torch.export import ExportedForecaster, export_experiment
    from imm_tsf_torch.serving import ForecastService

    from test_torch_export import LIVE_TOL, _port_experiment
    from torch_port_parity import assert_answers_match, mixed_requests

    exp, art = str(tmp_path / "exp"), str(tmp_path / "art")
    cfg = _port_experiment(exp, model="PatchTST", e_layers=1, use_pallas=True,
                           use_fused_ffn=True, compute_dtype="amp_bf16")
    meta = export_experiment(exp, art, batch_sizes=(4,), device="cpu")
    assert meta["compute_dtype"] == "amp_bf16"
    assert meta["ops"]["4"] == {"fused_encoder_ffn": 1, "recency_weighted_average": 1}
    ep = torch.export.load(os.path.join(art, "forecast_b4.pt2"))
    ffn_node = next(n for n in ep.graph.nodes if "fused_encoder_ffn" in str(n.target))
    assert ffn_node.args[0].meta["val"].dtype == torch.float32
    assert all(a.meta["val"].dtype == torch.bfloat16 for a in ffn_node.args[1:7])
    insts = mixed_requests(cfg, 8)
    fc = ExportedForecaster(art, device="cpu")
    got = [a for i in range(0, 8, 4) for a in fc.forecast(insts[i:i + 4])]
    svc = ForecastService(exp, max_batch=4, max_wait_ms=20.0, device="cpu")
    try:
        live = [f.result(timeout=300) for f in [svc.submit(i) for i in insts]]
    finally:
        svc.close()
    assert_answers_match(insts, got, live, cfg.input_dim, **LIVE_TOL)


def test_main_all_sweeps_under_amp(synth_root, tmp_path):
    """`main_all --compute_dtype amp_bf16`: each combination trains under amp
    (the provenance says so) into a result file of its own kind, beside the
    float32 one; a continuous-time model refuses it."""
    import json

    from imm_tsf_torch import main_all

    argv = ["--datasets", "EPA-Air", "--models", "DLinear", "--enable_text", "0",
            "--batch_size", "16", "--epoch", "1", "--data_root", synth_root,
            "--results_dir", str(tmp_path / "res"), "--device", "cpu"]
    main_all.main(argv + ["--compute_dtype", "amp_bf16"])
    main_all.main(argv)
    files = {f.name: json.loads(f.read_text()) for f in (tmp_path / "res").glob("*.json")}
    assert len(files) == 2
    (amp_name,) = [n for n in files if "_compute_dtype=amp_bf16" in n]
    assert files[amp_name]["provenance"]["compute_dtype"] == "amp_bf16"
    (f32_name,) = [n for n in files if n != amp_name]
    assert files[f32_name]["provenance"]["compute_dtype"] == "float32"
    assert files[amp_name]["metrics"]["mse"] != files[f32_name]["metrics"]["mse"]
    with pytest.raises(ValueError, match="amp_bf16"):
        main_all.main(argv[:3] + ["CRU"] + argv[4:] + ["--compute_dtype", "amp_bf16"])
