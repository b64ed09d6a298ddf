"""dropout_impl="flax" trained, the port against the JAX package, on the
CPU: PatchTST (d_model 16, d_ff 32, 2 heads, 1 layer) + TTF_RecAvg +
MMF_GR_Add at dropout 0.1 under rng_impl="threefry2x32", from the JAX
init (`params_from_jax`):

- `trainable` streaming against the JAX `trainable`: per-step losses
  within 1e-5 relative, the same best epoch, test metrics within 1e-4 (as
  tests/test_torch_patchtst_training.py holds the run at dropout 0): the
  masks are the JAX package's, so the runs part only by float32 rounding;
- the epoch loop (resident, the step keys read from the salt tape) equals
  streaming bit for bit, and so does a run stopped after one epoch and
  resumed with `load` (the key chain in the train state);
- a sweep of two seeds (rng_impl pinned to threefry2x32 by the sweep)
  equals the serial runs of its seeds bit for bit;
- over a data mesh of two gloo ranks (spawned, one thread each; cases of
  tests/torch_dp_cases.py), each rank drawing its rows of the global
  batch's masks, against the JAX trainable over its ("data",) mesh of 2
  (the conftest's virtual devices), at the first test's tolerances;
- the unfused FFN route: kernel #2's flag set, no #2 call in flax mode;
- `main_all --dropout_impl flax`: refused under "rbg" before any work
  without a replica grid; with one, the result file tagged
  `_dropout=flax`, its provenance recording rng_impl threefry2x32.
"""

import json

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
from imm_tsf_torch.parallel import multiproc
from imm_tsf_torch.training.trainer import trainable
from imm_tsf_torch.training.vmap_sweep import train_seed_sweep
import torch_dp_cases as dp_cases
from torch_port_parity import np_tree
from torch_port_parity import jitted_jax_init  # noqa: F401 -- autouse: JAX's init jitted

torch.set_num_threads(1)

SLICE_KW = dict(
    dataset="EPA-Air", model="PatchTST", history=7, pred_window=7, stride=7,
    time_unit="days", d_model=16, d_ff=32, n_heads=2, e_layers=1, enable_text=True,
    use_text_embeddings=True, TTF_module="TTF_RecAvg", MMF_module="MMF_GR_Add",
    llm_model_fusion="GPT2", llm_layers_fusion=6, d_txt=16, batch_size=8, epoch=3,
    patience=3, dropout=0.1, seed=3, lr=1e-3, w_decay=0.01, device_loop=False,
    host_prefetch=0, grad_clip=True, dropout_impl="flax", rng_impl="threefry2x32",
    use_pallas=True, use_fused_ffn=True)


def _losses(res) -> list:
    return [x for h in res["history"] for x in h["step_losses"]]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """(data_root, JAX init params, per-step losses, best-epoch metrics) of
    the JAX trainable."""
    root = str(tmp_path_factory.mktemp("flax"))
    make_synthetic_dataset(f"{root}/EPA-Air", n_entities=4, n_features=8, n_days=100,
                           obs_per_day=1.2, notes_per_day=0.7, d_txt=16, seed=0)
    cfg = JConfig(data_root=root, **SLICE_KW)
    data = j_parse_datasets(cfg, verbose=False)
    jcfg = data["cfg"]
    rng = jax.random.key(jcfg.seed, impl=jcfg.rng_impl)
    rng, init_rng = jax.random.split(rng)
    params, _ = jtrainer.init_state(jcfg, j_get_model(jcfg), JFusionModel(jcfg),
                                    next(iter(data["train_dataloader"])), init_rng)
    losses: list = []
    res = _recorded(cfg, losses)
    return root, np_tree(params), losses, res


def _recorded(cfg, losses: list) -> dict:
    """The JAX trainable of cfg, each step's loss appended to `losses`."""
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
        return jtrainer.trainable(cfg)
    finally:
        jtrainer.build_steps = build_steps


@pytest.fixture(scope="module")
def streamed(jax_run):
    root, params, _, _ = jax_run
    calls = tffn.launches, tffn.train_launches
    res = trainable(TConfig(data_root=root, **SLICE_KW), device="cpu",
                    initial_state=params_from_jax(params))
    assert (tffn.launches, tffn.train_launches) == calls  # the FFN ran unfused
    return res


def test_trainable_matches_jax_trainable(jax_run, streamed):
    _, _, want_losses, want = jax_run
    got_losses = _losses(streamed)
    assert len(got_losses) == len(want_losses) > 3
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    assert streamed["best_iter"] == want["best_iter"]
    for k in ("loss", "mse", "mae", "rmse"):
        np.testing.assert_allclose(streamed[k], want[k], rtol=1e-4, err_msg=k)


def _assert_same_run(got, want):
    assert _losses(got) == _losses(want)
    assert [h["val"] for h in got["history"]] == [h["val"] for h in want["history"]]
    assert got["best_iter"] == want["best_iter"]
    for k in ("loss", "mse", "mae", "rmse", "mape"):
        assert got[k] == want[k], k


def test_epoch_loop_equals_streaming(jax_run, streamed):
    root, params, _, _ = jax_run
    timings: dict = {}
    loop = trainable(TConfig(data_root=root, **dict(SLICE_KW, device_loop=True)),
                     device="cpu", initial_state=params_from_jax(params), timings=timings)
    assert timings["epoch_loop"]["mode"] == "resident"
    _assert_same_run(loop, streamed)


@pytest.mark.parametrize("device_loop", [False, True], ids=["streaming", "loop"])
def test_resumed_run_equals_uninterrupted(jax_run, streamed, tmp_path, device_loop):
    root, params, _, _ = jax_run
    kw = dict(SLICE_KW, device_loop=device_loop)
    d = str(tmp_path / "exp")
    trainable(TConfig(data_root=root, **dict(kw, epoch=1)), device="cpu", checkpoint_dir=d,
              initial_state=params_from_jax(params))
    resumed = trainable(TConfig(data_root=root, **dict(kw, load="x")), device="cpu",
                        checkpoint_dir=d, initial_state=params_from_jax(params))
    _assert_same_run(resumed, streamed)


def test_sweep_replicas_equal_their_serial_runs(jax_run):
    root = jax_run[0]
    kw = dict(SLICE_KW, epoch=2, device_loop=True)
    sweep = train_seed_sweep(TConfig(data_root=root, **dict(kw, rng_impl="rbg")), seeds=[3, 4],
                             device="cpu")
    for res, seed in zip(sweep, (3, 4)):
        serial = trainable(TConfig(data_root=root, **dict(kw, seed=seed, data_seed=3)),
                           device="cpu")
        assert res["seed"] == seed
        _assert_same_run(res, serial)


def test_main_all_flax_refused_without_a_grid_and_tagged_with_one(jax_run, tmp_path):
    """`main_all --dropout_impl flax`: without a replica grid every
    combination trains under "rbg", refused before any work; a grid pins
    threefry2x32, and the result file is tagged and records both."""
    from imm_tsf_torch import main_all

    argv = ["--datasets", "EPA-Air", "--models", "DLinear", "--enable_text", "0",
            "--batch_size", "16", "--epoch", "1", "--data_root", jax_run[0], "--device", "cpu",
            "--results_dir", str(tmp_path), "--dropout_impl", "flax"]
    with pytest.raises(NotImplementedError, match="Queue 1, item 19"):
        main_all.main(argv)
    assert not list(tmp_path.glob("*.json"))
    main_all.main(argv + ["--seeds", "2"])
    (path,) = tmp_path.glob("*.json")
    assert path.name.endswith("_seeds=2_dropout=flax.json")
    prov = json.loads(path.read_text())["provenance"]
    assert (prov["dropout_impl"], prov["rng_impl"]) == ("flax", "threefry2x32")


def test_data_mesh_of_two_ranks_matches_jax_mesh(jax_run):
    root, params, _, _ = jax_run
    kw = dict(SLICE_KW, data_root=root, epoch=2, mesh_shape=(2,))
    run = [("flax", "train", dict(cfg_kw=kw, initial_state=params_from_jax(params)))]
    world = multiproc.World(dp_cases.run, 2, (run,), device="cpu", threads=1,
                            timeout=600).start()
    try:
        losses: list = []
        want = _recorded(JConfig(**kw), losses)  # while the ranks train
        got = [r["flax"] for r in world.join()]
    finally:
        world._stop()
    assert got[0] == got[1]
    assert len(got[0]["step_losses"]) == len(losses) > 3
    np.testing.assert_allclose(got[0]["step_losses"], losses, rtol=1e-5)
    assert got[0]["best_iter"] == want["best_iter"]
    for k in ("loss", "mse", "mae", "rmse"):
        np.testing.assert_allclose(got[0][k], want[k], rtol=1e-4, err_msg=k)
