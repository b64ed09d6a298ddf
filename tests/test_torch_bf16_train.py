"""compute_dtype="bfloat16" in training and through the port's entry
points, on the CPU (tests/test_torch_bf16.py says what the bf16 product
oracle is; the backbones' eval forwards are tests/test_torch_bf16_models.py):

  - one training step's loss and gradients against jax.value_and_grad under
    the oracle, traced under the context as a whole (so the custom VJPs'
    backward products are DEFAULT, as the TPU runs them): PatchTST on the
    kernel route (#2's one-pass forms) and the plain route, Informer,
    TimeLLM with the fused attention (#3's), the CRU on both scan routes,
    which part in JAX;
  - `python -m imm_tsf_torch.main --compute_dtype bfloat16`: the epoch loop
    against streaming, --load resume and predict, bit for bit;
  - the stacked-replica sweep: a replica against its single run;
  - a ForecastService against make_forward's eval, an exported artifact
    (which names the one-pass ops) against the live service;
  - `main_all --compute_dtype bfloat16`."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imm_tsf_tpu.training.trainer as jtrainer

from imm_tsf_torch.convert import params_from_jax
from imm_tsf_torch.kernels import attn as tattn
from imm_tsf_torch.kernels import ffn as tffn
from imm_tsf_torch.training import trainer

from torch_port_parity import (backbone_case, install_bf16_oracle, np_tree, port_modules,
                               tensors)
from torch_port_parity import jitted_jax_init  # noqa: F401 -- autouse: JAX's init jitted

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def oracle():
    restore = install_bf16_oracle()
    yield
    restore()


def _score(got: np.ndarray, want: np.ndarray, floor: float) -> float:
    """||got - want|| / (||want|| + floor sqrt(n)): the tensor's relative
    error, floored at `floor` an element (tests/test_torch_amp_train.py)."""
    return float(np.linalg.norm(got - want)
                 / (np.linalg.norm(want) + floor * np.sqrt(want.size)))


STEPS = {  # case: (model, config overrides)
    "PatchTST_kernel": ("PatchTST", dict(use_pallas=True, use_fused_ffn=True)),
    "PatchTST_plain": ("PatchTST", dict(use_pallas=False, use_fused_ffn=False)),
    "Informer": ("Informer", dict(factor=100)),  # every query: the key sample has no effect
    "TimeLLM": ("TimeLLM", dict(use_fused_attn=True)),
    "CRU_default": ("CRU", {}),
    "CRU_fused": ("CRU", {}),
}
# The step's scores (_score, floor a thousandth of the largest JAX gradient),
# largest over the loss and every gradient, 1e-4 unless named: the float32
# summation order (measured: PatchTST kernel 3.0e-7 and plain 3.3e-7, CRU
# default 1.1e-6 and fused 1.2e-6). Informer's distilling ConvLayer
# normalises with batch statistics that torch and flax sum in another order;
# the values that then round the other way pass back through BatchNorm's
# backward, which couples every row of the batch, into encoder layer 0
# (measured 5.1e-3 there; with one encoder layer and no ConvLayer, 5e-7).
# TimeLLM's 768-wide GPT-2 spreads the flips of its forward and backward
# (tests/test_torch_bf16_models.py; measured 1.8e-2, mapping_layer's bias).
STEP_TOL = {"Informer": 0.02, "TimeLLM": 0.05}
# TimeLLM's STEP_TOL would pass a float32 step too, so the norm of its
# gradients' distance to JAX's (all parameters together) is also held under
# this share of the port's float32 step's: over 8 draws of the case (drawn
# anew in each process) it was 0.31-0.49, a float32 step's being 1. The
# loss is not held so: its float32 distance is one scalar, which the
# rounding can leave near 0 by chance (0.009-3.9 of it over the same draws).
GRAD_FLOAT32_SHARE = {"TimeLLM": 0.75}


class _TpuBackend:
    """The `jax` name of the JAX package's fusion/ttf.py, reporting the TPU
    backend: TTF_RecAvg with use_pallas then takes kernel #1 and its custom
    VJP, as on the TPU (the Pallas kernel still runs in interpret mode here),
    which the port's kernel route mirrors. On the CPU it would take the
    einsum, whose autodiff rounds 1/denom into other operands than `_bwd`
    does (a score of 3.5e-3 on TTF_RecAvg's input_proj)."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend() -> str:
        return "tpu"


def _jax_step(jcfg, models, params, stats, batch):
    loss_fn = jtrainer.make_loss_fn(jtrainer.make_forward(jcfg, *models))
    dev = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("bfloat16"):
        (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, stats, dev, jax.random.PRNGKey(5))
    return float(loss), grads


def _port_step(tcfg, tm, tf, batch):
    """The port's loss and each trainable parameter's gradient, keyed (0
    backbone / 1 fusion stack, name), None where the forward does not
    reach it, after one training-mode step on `batch`."""
    tm.train(), tf.train()
    loss = trainer.make_loss_fn(trainer.make_forward(tcfg, tm, tf))(tensors(batch))
    loss.backward()
    grads = {(i, n): None if p.grad is None else p.grad.numpy()
             for i, mod in enumerate((tm, tf)) for n, p in mod.named_parameters()
             if p.requires_grad}
    return float(loss.detach()), grads


@pytest.mark.parametrize("case", list(STEPS))
def test_training_step_matches_jax(oracle, case, monkeypatch):
    """One step from the same state, dropout 0, each route against the same
    route of the JAX package: the loss and each parameter's gradient scored
    against STEP_TOL (1e-4 unless named), TimeLLM's gradients also against
    GRAD_FLOAT32_SHARE; the CRU routes' JAX losses part (the fused scan
    stays HIGHEST)."""
    from imm_tsf_tpu.fusion import ttf as jttf

    model, kw = STEPS[case]
    if kw.get("use_pallas", True):  # BF16_BASE's kernel routes
        monkeypatch.setattr(jttf, "jax", _TpuBackend())
    if case == "CRU_fused":
        monkeypatch.setenv("IMM_TSF_CRU_FUSED", "1")
        jax.clear_caches()
    jcfg, batch, models, params, stats = backbone_case(model, dropout=0.0, **kw)
    jloss, jgrads = _jax_step(jcfg, models, params, stats, batch)
    want_g = params_from_jax(np_tree(jgrads))

    tcfg, tm, tf = port_modules(jcfg, params, stats)
    counts = (tffn.launches, tattn.launches)
    loss, grads = _port_step(tcfg, tm, tf, batch)
    assert (tffn.launches, tattn.launches) == counts  # CPU tensors take the plain versions
    scores = {"loss": abs(loss - jloss) / abs(jloss)}
    floor = 1e-3 * max(float(np.abs(g).max())
                       for g in jax.tree_util.tree_leaves(np_tree(jgrads)))
    for (i, n), g in grads.items():
        w = want_g[i][n].numpy()
        if g is None:  # a parameter the forward does not reach: JAX's is 0
            assert not w.any(), n
            continue
        scores[f"grad {n}"] = _score(g, w, floor)
    worst = max(scores, key=scores.get)
    print(f"{case}: worst {worst} {scores[worst]:.3g}")
    assert scores[worst] <= STEP_TOL.get(case, 1e-4), (worst, scores[worst])
    if case in GRAD_FLOAT32_SHARE:
        _, f32 = _port_step(tcfg.replace(compute_dtype="float32"),
                            *port_modules(jcfg, params, stats)[1:], batch)
        keys = [k for k, g in grads.items() if g is not None]
        flat = lambda gs: np.concatenate([gs[k].ravel() for k in keys])
        want = np.concatenate([want_g[i][n].numpy().ravel() for i, n in keys])
        share = (np.linalg.norm(flat(grads) - want) / np.linalg.norm(flat(f32) - want))
        assert share <= GRAD_FLOAT32_SHARE[case], share
    if case == "CRU_fused":
        monkeypatch.delenv("IMM_TSF_CRU_FUSED")
        jax.clear_caches()
        default_loss, _ = _jax_step(jcfg, models, params, stats, batch)
        assert abs(default_loss - jloss) >= 1e-5 * abs(jloss)


# --------------------------------------------------------- entry points
def _main_flags(root, model="PatchTST"):
    return ["--dataset", "EPA-Air", "--data_root", root, "--model", model, "--history", "7",
            "--pred_window", "7", "--stride", "7", "--enable_text", "--use_text_embeddings",
            "--d_txt", "16", "--TTF_module", "TTF_RecAvg", "--MMF_module", "MMF_GR_Add",
            "--batch_size", "8", "--d_model", "16", "--d_ff", "32", "--n_heads", "2",
            "--e_layers", "1", "--dropout", "0.1", "--use_pallas", "--use_fused_ffn",
            "--compute_dtype", "bfloat16", "--device", "cpu"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from imm_tsf_torch.data.synthetic import make_synthetic_dataset

    root = str(tmp_path_factory.mktemp("bf16"))
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


def test_main_epoch_loop_equals_streaming_resumes_and_predicts(root, tmp_path):
    """PatchTST + the pair on #2's one-pass route, dropout 0.1 (the hash
    masks are float32's: shapes and salts), under "bfloat16": the epoch loop
    equals streaming, a run stopped after epoch 0 and resumed with --load
    equals the uninterrupted one, bit for bit, and predict on its best
    weights gives its test metrics; the losses are not float32's."""
    from imm_tsf_torch import main as tmain
    from imm_tsf_torch import predict

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
    for p in resumed["model"].parameters():  # the parameters stay float32
        assert p.dtype == torch.float32
    out = predict.main(["--load", exp, "--save", save, "--data_root", root, "--device", "cpu"])
    for k in ("mse", "mae", "rmse"):
        assert abs(out[f"test_{k}"] - resumed[k]) < 1e-9
    f32 = [f if f != "bfloat16" else "float32" for f in flags]
    float32 = tmain.main(f32 + ["--epoch", "1", "--save", str(tmp_path / "f32")])
    assert _losses(float32)[0] != _losses(loop)[0]


def test_sweep_replica_equals_its_single_run(root, tmp_path):
    """`--vmap_seeds 2` under "bfloat16": replica 1 equals the single run of
    its seed on the sweep's data seed, bit for bit."""
    from imm_tsf_torch import main as tmain

    flags = _main_flags(root) + ["--epoch", "1"]
    sweep = tmain.main(flags + ["--vmap_seeds", "2", "--seed", "3",
                                "--save", str(tmp_path / "sweep")])
    single = tmain.main(flags + ["--seed", "4", "--data_seed", "3",
                                 "--save", str(tmp_path / "single")])
    assert [r["seed"] for r in sweep] == [3, 4]
    assert _losses(sweep[1]) == _losses(single)
    _same_weights(sweep[1], single)


@pytest.mark.parametrize("model", ["PatchTST", "CRU"])
def test_service_equals_make_forward_eval(tmp_path, model):
    """A "bfloat16" ForecastService (PatchTST on #2's and #1's one-pass
    routes, the CRU) answers as make_forward's eval of the same weights on
    the same collated batch (rtol 1e-5, atol 1e-6: a dispatch may batch the
    requests otherwise)."""
    from imm_tsf_torch.serving import ForecastService, _build_chunk, gather_results, \
        restore_modules
    from imm_tsf_torch.training.checkpoint import load_weights

    from test_torch_export import LIVE_TOL, _port_experiment
    from torch_port_parity import assert_answers_match, mixed_requests

    exp = str(tmp_path / "exp")
    kw = (dict(e_layers=1, use_pallas=True, use_fused_ffn=True) if model == "PatchTST"
          else dict(cru_lsd=8, cru_hidden_units=16))
    cfg = _port_experiment(exp, model=model, compute_dtype="bfloat16", **kw)
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
        f32 = trainer.make_forward(cfg.replace(compute_dtype="float32"), model_, fusion)(
            batch).numpy()
    assert np.abs(pred - f32).max() >= 1e-4
    want = gather_results(cfg, built, out, pred)
    assert_answers_match(insts, got, want, cfg.input_dim, **LIVE_TOL)


def test_exported_artifact_equals_the_live_service(tmp_path):
    """A "bfloat16" PatchTST on #2's route exported on the CPU: meta.json
    records the compute dtype, the program calls #1's and #2's ops with
    `one_pass` (so the artifact launches the one-pass forms on the card),
    and its answers equal the live service's (rtol 1e-5, atol 1e-6: tests/test_torch_export.py)."""
    from imm_tsf_torch.export import ExportedForecaster, export_experiment
    from imm_tsf_torch.serving import ForecastService

    from test_torch_export import LIVE_TOL, _port_experiment
    from torch_port_parity import assert_answers_match, mixed_requests

    exp, art = str(tmp_path / "exp"), str(tmp_path / "art")
    cfg = _port_experiment(exp, model="PatchTST", e_layers=1, use_pallas=True,
                           use_fused_ffn=True, compute_dtype="bfloat16")
    meta = export_experiment(exp, art, batch_sizes=(4,), device="cpu")
    assert meta["compute_dtype"] == "bfloat16"
    assert meta["ops"]["4"] == {"fused_encoder_ffn:one_pass": 1,
                               "recency_weighted_average:one_pass": 1}
    insts = mixed_requests(cfg, 8)
    fc = ExportedForecaster(art, device="cpu")
    got = [a for i in range(0, 8, 4) for a in fc.forecast(insts[i:i + 4])]
    svc = ForecastService(exp, max_batch=4, max_wait_ms=20.0, device="cpu")
    try:
        live = [f.result(timeout=300) for f in [svc.submit(i) for i in insts]]
    finally:
        svc.close()
    assert_answers_match(insts, got, live, cfg.input_dim, **LIVE_TOL)


def test_main_all_sweeps_under_bfloat16(synth_root, tmp_path):
    """`main_all --compute_dtype bfloat16`: each combination trains under the
    mode (the provenance says so) into a result file of its own kind, beside
    the float32 one; a continuous-time model takes it too."""
    import json

    from imm_tsf_torch import main_all

    argv = ["--datasets", "EPA-Air", "--models", "DLinear", "--enable_text", "0",
            "--batch_size", "16", "--epoch", "1", "--data_root", synth_root,
            "--results_dir", str(tmp_path / "res"), "--device", "cpu"]
    main_all.main(argv + ["--compute_dtype", "bfloat16"])
    main_all.main(argv)
    files = {f.name: json.loads(f.read_text()) for f in (tmp_path / "res").glob("*.json")}
    assert len(files) == 2
    (bf16_name,) = [n for n in files if "_compute_dtype=bfloat16" in n]
    assert files[bf16_name]["provenance"]["compute_dtype"] == "bfloat16"
    (f32_name,) = [n for n in files if n != bf16_name]
    assert files[f32_name]["provenance"]["compute_dtype"] == "float32"
    assert files[bf16_name]["metrics"]["mse"] != files[f32_name]["metrics"]["mse"]
    main_all.main(argv[:3] + ["CRU"] + argv[4:] + ["--compute_dtype", "bfloat16"])
    assert len(list((tmp_path / "res").glob("*CRU*_compute_dtype=bfloat16*.json"))) == 1
