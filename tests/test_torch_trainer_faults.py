"""The port's trainer and service on the flags and faults the JAX package
handles, on the CPU.

- A batch that runs out of device memory before the optimizer step is
  skipped with a warning, as the JAX streaming loop skips it
  (imm_tsf_tpu/training/trainer.py:802-821); one that runs out in the
  optimizer step is raised, since the parameters or Adam state may be
  partly updated (the JAX loop raises for consumed state).
- `profile_dir` writes a trace of the epoch the JAX trainer traces
  (:729-744): the second of two or more, else the only one.
- `debug_nans` trains under autograd's anomaly mode, which raises at the
  backward that first gives a NaN (the JAX package's NaN trapping,
  :726-727); without it a NaN gradient only shows as a NaN loss a step
  later.
- `compute_dtype` bfloat16 and amp_bf16 are refused by the port's
  make_forward, in serving as in training; float32 and highest are
  served (every product of the port is full float32).
- `llm_tp` above 1 (the JAX package's tensor-parallel LLM mesh) is
  refused where the raw-text stage would load the LLM.

The out-of-memory errors are raised on purpose, on a chosen step, by a
wrapped loss function or optimizer step: torch.cuda.OutOfMemoryError is
the error the card raises."""

import json
import logging
import os

import numpy as np
import pytest
import torch

from chip_smoke import CRU_CFG, make_experiment
from imm_tsf_torch.config import Config
from imm_tsf_torch.data.synthetic import make_synthetic_dataset
from imm_tsf_torch.serving import ForecastService
from imm_tsf_torch.training import trainer
from imm_tsf_torch.training.trainer import make_forward, make_loader_wrappers, trainable

torch.set_num_threads(1)

KW = dict(
    dataset="EPA-Air", model="CRU", history=7, pred_window=7, stride=7, time_unit="days",
    cru_lsd=8, cru_hidden_units=16, enable_text=True, use_text_embeddings=True,
    TTF_module="TTF_RecAvg", MMF_module="MMF_GR_Add", llm_model_fusion="GPT2",
    llm_layers_fusion=6, d_txt=16, batch_size=8, epoch=2, patience=3, dropout=0.0, seed=3,
    lr=1e-3, w_decay=0.01)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("faults"))
    make_synthetic_dataset(f"{root}/EPA-Air", n_entities=4, n_features=8, n_days=100,
                           obs_per_day=1.2, notes_per_day=0.7, d_txt=16, seed=0)
    return root


def _raise_on_call(fn, call: int, counter: list):
    """fn, but the call-th call (from 0) raises torch.cuda.OutOfMemoryError."""

    def wrapped(*args, **kwargs):
        counter.append(None)
        if len(counter) - 1 == call:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (raised by the test)")
        return fn(*args, **kwargs)

    return wrapped


def test_out_of_memory_before_the_optimizer_step_skips_the_batch(root, monkeypatch, caplog):
    make_loss_fn, clip_and_step = trainer.make_loss_fn, trainer.clip_and_step
    forwards, steps = [], []
    monkeypatch.setattr(trainer, "make_loss_fn",
                        lambda forward: _raise_on_call(make_loss_fn(forward), 1, forwards))

    def counted_step(optimizer, params, clip_norm=1.0):
        clip_and_step(optimizer, params, clip_norm)
        steps.append(max(int(optimizer.state[p]["step"]) for p in params))

    monkeypatch.setattr(trainer, "clip_and_step", counted_step)
    with caplog.at_level(logging.WARNING, logger="imm_tsf_torch"):
        res = trainable(Config(data_root=root, **KW), device="cpu")
    losses = [h["step_losses"] for h in res["history"]]
    n_batches = len(forwards) // 2  # every batch of both epochs came to the loss
    assert len(losses) == 2 and len(losses[0]) == n_batches - 1 and len(losses[1]) == n_batches
    # the skipped batch took no optimizer step: Adam counted only the others
    assert steps == list(range(1, 2 * n_batches))
    assert any("[OOM] epoch 0 step 1: skipping batch" in r.getMessage() for r in caplog.records)
    assert np.isfinite([res["mse"], *losses[0], *losses[1]]).all()


def test_out_of_memory_in_the_optimizer_step_is_raised(root, monkeypatch):
    calls = []
    monkeypatch.setattr(trainer, "clip_and_step",
                        _raise_on_call(trainer.clip_and_step, 2, calls))
    with pytest.raises(RuntimeError, match="epoch 0 step 2 in the optimizer step") as info:
        trainable(Config(data_root=root, **KW), device="cpu")
    assert isinstance(info.value.__cause__, torch.cuda.OutOfMemoryError)


@pytest.mark.parametrize("epochs,traced", [(2, 1), (1, 0)])
def test_profile_dir_writes_a_trace_of_the_jax_trainers_epoch(root, tmp_path, epochs, traced):
    out = str(tmp_path / "trace")
    trainable(Config(data_root=root, **dict(KW, epoch=epochs, profile_dir=out)), device="cpu")
    assert sorted(os.listdir(out)) == [f"trace_epoch{traced}.json"]
    with open(os.path.join(out, f"trace_epoch{traced}.json")) as f:
        events = json.load(f)["traceEvents"]
    # the traced epoch ran the model's forward and backward
    names = {e.get("name", "") for e in events}
    assert any("backward" in n.lower() for n in names) and any("matmul" in n for n in names)


def _nan_gradient_forward(make_forward):
    """The forecast plus 0 * sqrt(p - p) for a parameter p of the model:
    the values are the forecast's, the gradients NaN."""

    def make(cfg, model, fusion):
        forward, p = make_forward(cfg, model, fusion), next(model.parameters())
        return lambda batch: forward(batch) + 0.0 * torch.sqrt((p - p.detach()).sum())

    return make


@pytest.mark.parametrize("debug_nans", [True, False])
def test_debug_nans_raises_at_the_backward_that_gives_a_nan(root, monkeypatch, debug_nans):
    monkeypatch.setattr(trainer, "make_forward", _nan_gradient_forward(trainer.make_forward))
    cfg = Config(data_root=root, **dict(KW, debug_nans=debug_nans))
    if debug_nans:  # anomaly mode names the backward function, at the first step
        with pytest.raises(RuntimeError, match="SqrtBackward0.* returned nan"):
            trainable(cfg, device="cpu")
    else:  # the NaN gradient reaches the parameters; the next loss is NaN
        with pytest.raises(FloatingPointError, match="NaN loss at epoch 0 step 1"):
            trainable(cfg, device="cpu")
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("dtype", ["bfloat16", "amp_bf16", "highest"])
def test_service_refuses_bfloat16_compute(tmp_path, dtype):
    kw = dict(CRU_CFG, cru_lsd=8, cru_hidden_units=16, d_txt=16, compute_dtype=dtype)
    exp = str(tmp_path / "exp")
    cfg = make_experiment(exp, kw, 0)
    if dtype == "highest":  # full float32 products: what the port always runs
        svc = ForecastService(exp, max_batch=4, device="cpu")
        svc.close()
        return
    with pytest.raises(NotImplementedError, match=r"float32 only.*Queue 1, item 18"):
        ForecastService(exp, max_batch=4, device="cpu")
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        make_forward(cfg, None, None)


def test_raw_text_stage_refuses_a_tensor_parallel_llm():
    cfg = Config(**dict(CRU_CFG, use_text_embeddings=False, llm_tp=2))
    with pytest.raises(NotImplementedError, match=r"llm_tp=2.*Queue 1, item 16"):
        make_loader_wrappers(cfg, "cpu")
