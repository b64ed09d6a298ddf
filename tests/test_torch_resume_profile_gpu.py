"""Two of the port's trainer flags against the JAX package's rules, on
the CPU.

- `profile_dir` on a run resumed under `--load` traces the epoch the JAX
  trainer traces (imm_tsf_tpu/training/trainer.py:731-734): the start
  epoch + 1 when more than one epoch is left, else the start epoch.
- `--gpu N` pins a single-device run to cuda:N, or warns and stays on
  cuda:0 when fewer cards are visible (imm_tsf_tpu/training/trainer.py:
  530-539, predict.py:68-77); an explicit index and a mesh leave the
  device alone. The card count is monkeypatched, so no card is needed.
"""

import logging
import os
import shutil

import pytest
import torch

from imm_tsf_torch import device as device_mod
from imm_tsf_torch.config import Config
from imm_tsf_torch.data.synthetic import make_synthetic_dataset
from imm_tsf_torch.training import trainer
from imm_tsf_torch.training.trainer import trainable, traced_epoch

torch.set_num_threads(1)

KW = dict(dataset="EPA-Air", model="DLinear", history=7, pred_window=7, stride=7,
          time_unit="days", batch_size=8, epoch=2, patience=10, seed=3, lr=1e-3,
          host_prefetch=0)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(data root, the experiment dir of a DLinear run trained 2 epochs)."""
    root = str(tmp_path_factory.mktemp("data"))
    make_synthetic_dataset(f"{root}/EPA-Air", n_entities=4, n_features=3, n_days=100,
                           seed=0)
    exp = str(tmp_path_factory.mktemp("exp"))
    trainable(Config(data_root=root, **KW), device="cpu", checkpoint_dir=exp)
    return root, exp


@pytest.mark.parametrize("epochs,traced", [(3, 2), (5, 3)])
def test_a_resumed_run_traces_the_jax_trainers_epoch(trained, tmp_path, epochs, traced):
    root, exp = trained
    resumed = str(tmp_path / "exp")
    shutil.copytree(exp, resumed)
    out = str(tmp_path / "trace")
    res = trainable(Config(data_root=root, **dict(KW, epoch=epochs, load="exp",
                                                    profile_dir=out)),
                    device="cpu", checkpoint_dir=resumed)
    assert [h["epoch"] for h in res["history"]] == list(range(epochs))
    assert sorted(os.listdir(out)) == [f"trace_epoch{traced}.json"]


@pytest.mark.parametrize("start,epochs,want", [(0, 1, 0), (0, 3, 1), (2, 3, 2), (2, 5, 3)])
def test_traced_epoch_is_the_jax_rule(start, epochs, want):
    assert traced_epoch(Config(epoch=epochs, profile_dir="p"), start) == want
    assert traced_epoch(Config(epoch=epochs), start) is None


@pytest.fixture
def cards(monkeypatch):
    """A process that sees `n` cards: set cards.n; set_device calls recorded."""

    class Cards:
        n = 1
        set_to: list = []

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: Cards.n)
    monkeypatch.setattr(torch.cuda, "set_device", Cards.set_to.append)
    # resolve_device switches these for a cuda device: restored after
    for flag in ((torch.backends.cuda.matmul, "allow_tf32"), (torch.backends.cudnn, "allow_tf32"),
                 (torch.backends.cudnn, "deterministic")):
        monkeypatch.setattr(*flag, getattr(*flag))
    return Cards


@pytest.mark.parametrize("n,want", [(1, torch.device("cuda", 0)), (2, torch.device("cuda", 1))])
def test_gpu_pins_the_card_or_warns(cards, caplog, n, want):
    cards.n = n
    with caplog.at_level(logging.WARNING, logger="imm_tsf_torch"):
        got = device_mod.resolve_run_device("cuda", gpu=1)
    assert got == want
    warned = "--gpu 1 requested but only 1 device(s) visible" in caplog.text
    assert warned == (n == 1)
    assert cards.set_to == ([] if n == 1 else [1])


@pytest.mark.parametrize("device,gpu,mesh,want", [
    ("cuda:0", 1, (), torch.device("cuda", 0)),  # an explicit index wins
    (None, 1, (2,), torch.device("cuda")),  # a mesh run is not pinned
    (None, 0, (), torch.device("cuda")),
    ("cpu", 1, (), torch.device("cpu"))])
def test_gpu_leaves_an_explicit_index_a_mesh_and_the_cpu(cards, device, gpu, mesh, want):
    cards.n = 2
    assert device_mod.resolve_run_device(device, gpu=gpu, mesh_shape=mesh) == want
    assert cards.set_to == []


class _Stop(Exception):
    pass


def test_trainable_resolves_its_device_with_the_configs_gpu(monkeypatch):
    seen = []

    def spy(device, gpu=0, mesh_shape=()):
        seen.append((device, gpu, mesh_shape))
        raise _Stop  # before the data is read

    monkeypatch.setattr(trainer, "resolve_run_device", spy)
    with pytest.raises(_Stop):
        trainable(Config(gpu=1), device="cuda")
    assert seen == [("cuda", 1, ())]
