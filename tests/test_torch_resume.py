"""Full-state checkpoints and `--load` resume in the port, mirroring
tests/test_checkpoint_resume.py: a run stopped after epoch k and resumed
equals the uninterrupted run bit for bit (per-step losses, metrics,
best_iter, final weights, a history over every epoch once). DLinear,
Informer with hash dropout 0.1, whose state carries the salt generator,
ProbSparse's sample generator and the distilling BatchNorms' running
statistics, and the LatentODE, whose train-mode z0 noise comes from the
state's z0 generator. Also: no state to resume trains from scratch, a state that
does not fit the model raises, only the latest two states are kept, the
shuffle stream is found through the loader stages, and `main --load`."""

import os

import numpy as np
import pytest
import torch

from imm_tsf_torch import main as tmain
from imm_tsf_torch.config import Config
from imm_tsf_torch.data.loader import BatchIterator
from imm_tsf_torch.training import checkpoint
from imm_tsf_torch.training.trainer import _EmbedNotesLoader, _find_shuffler, trainable

torch.set_num_threads(1)


def _cfg(synth_root, **over):
    cfg = Config(dataset="EPA-Air", data_root=synth_root, model="DLinear", history=7,
                 pred_window=7, stride=7, time_unit="days", batch_size=16, enable_text=False,
                 epoch=4, patience=100)
    return cfg.replace(**over)


INFORMER = dict(model="Informer", d_model=16, d_ff=32, n_heads=2, e_layers=2, d_layers=1,
                factor=3, distil=True, dropout=0.1, epoch=3)


# the train-mode z0 draw comes from the trainer's z0 generator, which the state carries
LATENT_ODE = dict(model="LatentODE", ode_rec_dims=8, ode_units=8, ode_gru_units=8,
                  ode_latents=4, ode_substeps=1, epoch=2)


def _losses(res):
    return [x for h in res["history"] for x in h["step_losses"]]


def _assert_same_run(got, want):
    assert got["best_iter"] == want["best_iter"]
    for k in ("loss", "mse", "mae", "rmse", "mape"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=0, err_msg=k)
    assert _losses(got) == _losses(want)
    assert [h["val"] for h in got["history"]] == [h["val"] for h in want["history"]]
    for mod in ("model", "fusion"):
        a, b = got[mod], want[mod]
        if a is None:
            assert b is None
            continue
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for name in sa:
            assert torch.equal(sa[name], sb[name]), name


@pytest.mark.parametrize("over, stop_at", [({}, 2), (INFORMER, 1), (LATENT_ODE, 1)],
                         ids=["DLinear", "Informer_dropout", "LatentODE_z0"])
def test_resume_equals_uninterrupted(synth_root, tmp_path, over, stop_at):
    full = trainable(_cfg(synth_root, **over), checkpoint_dir=str(tmp_path / "full"),
                     device="cpu")
    trainable(_cfg(synth_root, **dict(over, epoch=stop_at)),
              checkpoint_dir=str(tmp_path / "res"), device="cpu")
    resumed = trainable(_cfg(synth_root, **over, load="resume"),
                        checkpoint_dir=str(tmp_path / "res"), device="cpu")
    _assert_same_run(resumed, full)
    n = _cfg(synth_root, **over).epoch
    assert [h["epoch"] for h in resumed["history"]] == list(range(n))
    if over is LATENT_ODE:  # the z0 noise's generator is part of the state
        *_, meta, _ = checkpoint.load_train_state(str(tmp_path / "res"))
        assert "z0_rng_state" in meta
        return
    if over:  # the distilling BatchNorms' statistics moved, and came back with the state
        stats = {k: v for k, v in resumed["model"].state_dict().items() if "running" in k}
        assert stats and any(float(v.abs().max()) not in (0.0, 1.0) for v in stats.values())


def test_no_state_trains_from_scratch(synth_root, tmp_path):
    plain = trainable(_cfg(synth_root, epoch=2), checkpoint_dir=str(tmp_path / "a"),
                      device="cpu")
    loaded = trainable(_cfg(synth_root, epoch=2, load="x"), checkpoint_dir=str(tmp_path / "b"),
                       device="cpu")
    _assert_same_run(loaded, plain)


def test_resume_skips_completed_run(synth_root, tmp_path):
    first = trainable(_cfg(synth_root, epoch=2), checkpoint_dir=str(tmp_path / "d"),
                      device="cpu")
    again = trainable(_cfg(synth_root, epoch=2, load="x"), checkpoint_dir=str(tmp_path / "d"),
                      device="cpu")
    assert again["best_iter"] == first["best_iter"]
    np.testing.assert_allclose(again["mse"], first["mse"], rtol=0, atol=0)
    assert [h["epoch"] for h in again["history"]] == [0, 1]


def test_mismatched_state_raises(synth_root, tmp_path):
    d = str(tmp_path / "d")
    trainable(_cfg(synth_root, epoch=1), checkpoint_dir=d, device="cpu")
    with pytest.raises(RuntimeError, match="does not match"):
        trainable(_cfg(synth_root, **dict(INFORMER, epoch=2), load="x"), checkpoint_dir=d,
                  device="cpu")


def test_latest_two_states_kept_and_best_weights_apart(synth_root, tmp_path):
    d = str(tmp_path / "d")
    res = trainable(_cfg(synth_root), checkpoint_dir=d, device="cpu")
    assert sorted(f for f in os.listdir(d) if f.startswith("train_state_")) == [
        "train_state_2.pt", "train_state_3.pt"]
    assert checkpoint.load_weights(os.path.join(d, "best"))["step"] == res["best_iter"]
    *_, meta, step = checkpoint.load_train_state(d)
    assert step == 3 and meta["epoch"] == 3 and len(meta["history"]) == 4
    assert meta["data_rng_state"]["bit_generator"] == "PCG64"
    with pytest.raises(FileNotFoundError):
        checkpoint.load_train_state(str(tmp_path / "empty"))


def test_find_shuffler_unwraps_loader_stages():
    base = BatchIterator([], [], 4, lambda b: {}, shuffle=True, seed=0)
    wrapped = _EmbedNotesLoader(base, None, None, 16)
    assert _find_shuffler(wrapped) is base
    assert _find_shuffler(base) is base
    assert _find_shuffler(object()) is None


def test_main_load_names_and_resumes_the_experiment(synth_root, tmp_path, capsys):
    args = ["--dataset", "EPA-Air", "--data_root", synth_root, "--model", "DLinear",
            "--history", "7", "--pred_window", "7", "--stride", "7", "--batch_size", "16",
            "--patience", "100", "--save", str(tmp_path), "--load", "42", "--device", "cpu"]
    first = tmain.main(args + ["--epoch", "1"])
    exp = tmp_path / "experiment_42"
    assert sorted(os.listdir(exp)) == ["best", "config.json", "train_state_0.pt"]
    second = tmain.main(args + ["--epoch", "2"])
    assert [h["epoch"] for h in second["history"]] == [0, 1]
    assert second["history"][0] == first["history"][0]
    assert sorted(f for f in os.listdir(exp) if f.startswith("train_state_")) == [
        "train_state_0.pt", "train_state_1.pt"]


def test_state_saved_before_the_z0_stream_resumes(synth_root, tmp_path):
    """A train state written before the trainer had a z0 generator (no
    `z0_rng_state` in its meta) still resumes, the z0 stream at its seed;
    DLinear draws nothing from it, so the run equals the uninterrupted one."""
    full = trainable(_cfg(synth_root, epoch=2), checkpoint_dir=str(tmp_path / "full"),
                     device="cpu")
    d = tmp_path / "res"
    trainable(_cfg(synth_root, epoch=1), checkpoint_dir=str(d), device="cpu")
    path = d / "train_state_0.pt"
    state = torch.load(path, weights_only=True)
    del state["meta"]["z0_rng_state"]
    torch.save(state, path)
    _assert_same_run(trainable(_cfg(synth_root, epoch=2, load="x"), checkpoint_dir=str(d),
                               device="cpu"), full)


@pytest.mark.parametrize("stream", ["salt", "sample"])
def test_state_without_a_seeded_stream_raises(synth_root, tmp_path, stream):
    """Only the z0 stream may be missing from a state: without the salt or
    ProbSparse sample stream the run could not resume bit for bit, so it
    fails instead of restarting that stream from the seed."""
    d = tmp_path / "res"
    trainable(_cfg(synth_root, epoch=1), checkpoint_dir=str(d), device="cpu")
    path = d / "train_state_0.pt"
    state = torch.load(path, weights_only=True)
    del state["meta"][f"{stream}_rng_state"]
    torch.save(state, path)
    with pytest.raises(KeyError, match=f"{stream}_rng_state"):
        trainable(_cfg(synth_root, epoch=2, load="x"), checkpoint_dir=str(d), device="cpu")
