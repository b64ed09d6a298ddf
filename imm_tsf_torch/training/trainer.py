"""Training harness: the reference's trainable() protocol (after
imm_tsf_tpu/training/trainer.py:163-314, 349-500, 502-906).

It trains every backbone (TimeLLM with GPT-2, BERT or Llama in both
prompt modes), each with either fusion pair, on
precomputed note embeddings or on raw-text notes (embedded by the frozen
LLM, any alias, in a loader stage, wrap_data_loaders), on the kernels'
routes and the plain ones:
CRU's default and fused scans (kernels #4-#7), PatchTST's and Informer's
fused FFN (kernel #2, its training form and hand backward) or the unfused
one, GPT-2's fused attention (kernel #3 with its hand backward, in
TimeLLM's steps and in the raw-text embedding stage) or the plain one,
and kernel #1's recency average with its backward. Informer's distilling
BatchNorms update their running statistics in the training steps (the
JAX trainer's `stats`), which the checkpoint keeps. TimeLLM's frozen
LLM is stored in bfloat16 under `frozen_param_dtype="bfloat16"`.
`check_trainable` refuses what is not ported.

Parity with reference main.py:945-1176:
  - Adam(lr, weight_decay) after clipping the gradients to a global norm
    of 1.0 (:1024, :1092-1101; training/optim.py);
  - epoch loop, validation after each epoch, test ONLY when the val MSE
    improves by more than early_stop_delta, early stop after `patience`
    epochs without it (:1131-1170); returns the best epoch's test metrics;
  - the loss is checked for NaN at every step.

The epoch modes are the JAX package's (:636-701). By default
(`device_loop`) every window of the three splits stays in device memory
and each step gathers its batch there (training/device_loop.py); on cuda
each step is a CUDA graph replay (training/graphs.py) and an epoch's
losses are read once. A batch-dependent collate (the LatentODE's union
time axis) takes the epoch-staged mode: each epoch collated on the host
and stacked. `--device_loop false`, `log_every` and a split past
`device_loop_max_mb` take the streaming loop (:794-829): one host batch
at a time, collated ahead on a worker thread (`host_prefetch`), moved to
the device, one gradient step. A batch that runs out of device memory
before the optimizer step is skipped with a warning, as the reference
skips it (:802-821), in the streaming loop and in eager resident steps;
in a captured loop it raises the JAX package's message, which points at
`--device_loop false` (:755-771). `profile_dir` traces one epoch with
torch.profiler (the epoch the JAX trainer picks, :729-744) and
`debug_nans` runs the training under autograd's anomaly mode (the JAX
package's NaN trapping, :726-727), with eager steps. Best weights go to
`<checkpoint_dir>/best/weights.pt` beside `config.json`
(training/checkpoint.save_experiment), which `python -m
imm_tsf_torch.serve --load <checkpoint_dir>` serves. The full training
state goes to `<checkpoint_dir>/train_state_<epoch>.pt` after every epoch
(the latest two kept), and `cfg.load` resumes from it (:571-612,
:860-880): weights, BatchNorm statistics, Adam's moments and step, the
counters and history, the train loader's shuffle state and the port's
random streams (the hash-dropout salts, ProbSparse's samples, the
LatentODE's and NeuralFlow's z0 noise), so a resumed run equals the
uninterrupted one bit for bit.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import numpy as np
import torch

from ..config import Config
from ..device import resolve_run_device
from ..layers.fast_dropout import Dropout
from ..layers.prob_attention import ProbAttention
from .evaluation import evaluation, finalize_metrics, masked_mse_loss
from .optim import cast_frozen, clip_and_step, make_optimizer, trainable_parameters

logger = logging.getLogger("imm_tsf_torch")


def make_forward(cfg: Config, model, fusion):
    """forward(batch) -> pred_y [B, Lp, C]: the backbone (given the batch's
    TimeLLM `prompt_ids` when it carries them), then `pred_y.float()`, then
    the fusion stack when the run has text.
    `batch` holds tensors on the modules' device; the modules' train or
    eval mode is the caller's (eval under `torch.inference_mode()` to
    serve).

    compute_dtype: "float32" and "highest" run every product in full
    float32 (the port keeps TF32 off, device.py), which is what "highest"
    asks for; "bfloat16" and "amp_bf16" are refused, where the JAX
    package's make_forward would cast or refuse (:163-193)."""
    if cfg.compute_dtype in ("bfloat16", "amp_bf16"):
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: the port computes in float32 only; "
            "bfloat16 compute is not ported yet (ROADMAP.md, Queue 1, item 18)")

    def forward(batch: dict):
        extra = {"prompt_ids": batch["prompt_ids"]} if "prompt_ids" in batch else {}
        pred_y = model(batch["tp_to_predict"], batch["observed_data"],
                       batch["observed_tp"], batch["observed_mask"], **extra).float()
        if fusion is not None:
            pred_y = fusion(batch["notes_embeddings"], batch["tau"],
                            batch["tp_to_predict"], pred_y, batch["notes_mask"])
        return pred_y

    return forward


def make_loss_fn(forward):
    """The masked-MSE training loss (reference lib/evaluation.py:107):
    loss_fn(batch) -> 0-d tensor."""

    def loss_fn(batch: dict):
        return masked_mse_loss(forward(batch), batch["data_to_predict"],
                               batch["mask_predicted_data"])

    return loss_fn


class StepTimer:
    """Device ms of each gradient step's forward, backward and optimizer,
    from CUDA events recorded between them; read once the step's loss has
    reached the host."""

    PHASES = ("forward", "backward", "optimizer")

    def __init__(self):
        self._events: list = []
        self.ms: dict = {k: [] for k in self.PHASES}

    def mark(self) -> None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self._events.append(event)

    def discard(self) -> None:
        """Drop the marks of a step that did not finish."""
        self._events = []

    def collect(self) -> None:
        ev, self._events = self._events, []
        for name, a, b in zip(self.PHASES, ev[:-1], ev[1:]):
            self.ms[name].append(a.elapsed_time(b))


def make_grad_step(loss_fn, optimizer, params, clip_norm: float = 1.0,
                   timer: StepTimer | None = None):
    """grad_step(batch) -> loss (0-d, on the device): forward, backward,
    clip, Adam step. `timer` marks the phases with CUDA events.
    `grad_step.stepping` is True from the clip and optimizer step of the
    latest call on: an error raised before it left the parameters and
    Adam state untouched."""
    mark = timer.mark if timer is not None else (lambda: None)

    def grad_step(batch: dict):
        grad_step.stepping = False
        optimizer.zero_grad(set_to_none=True)
        mark()
        loss = loss_fn(batch)
        mark()
        loss.backward()
        mark()
        grad_step.stepping = True
        clip_and_step(optimizer, params, clip_norm)
        mark()
        return loss.detach()

    grad_step.stepping = False
    return grad_step


def to_device(batch: dict, device: torch.device) -> dict:
    """The batch's arrays as tensors on `device` (other entries dropped)."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def check_trainable(cfg: Config) -> None:
    """Refuse a configuration whose training path is not ported: nothing
    drops to a plain version unsaid."""
    refusals = [
        (cfg.dropout_impl != "hash",
         f"dropout_impl={cfg.dropout_impl!r}: only the hash dropout is ported "
         "(ROADMAP.md, Queue 1, item 19)"),
        (bool(cfg.mesh_shape),
         "mesh_shape: multi-GPU training comes with the system layers "
         "(ROADMAP.md, Queue 1, item 16)"),
    ]
    for refused, why in refusals:
        if refused:
            raise NotImplementedError(why)


def _find_shuffler(loader):
    """The BatchIterator under the loader stages (`.base` of each wrapper)
    that holds the shuffle stream, or None (imm_tsf_tpu/training/
    trainer.py:41-48)."""
    for _ in range(8):
        if loader is None or hasattr(loader, "_rng"):
            break
        loader = getattr(loader, "base", None)
    return loader if hasattr(loader, "_rng") else None


def load_run_state(model, fusion, optimizer, model_state: dict, fusion_state: dict | None,
                   opt_state: dict) -> None:
    """A saved run's weights and Adam state into its modules (on their
    device) and optimizer; raises RuntimeError, ValueError or KeyError
    when they do not fit."""
    if (fusion_state is None) != (fusion is None):
        raise ValueError("the fusion stack is present in only one of them")
    model.load_state_dict(model_state)
    if fusion is not None:
        fusion.load_state_dict(fusion_state)
    optimizer.load_state_dict(opt_state)


def _restore(checkpoint_dir: str, model, fusion, optimizer, generators, shuffler):
    """Load the latest train state into the modules (on their device), the
    optimizer, the generators ({name: torch.Generator}) and the shuffler;
    returns its meta, or None when there is none to resume (the JAX
    trainer trains from scratch then). A state that does not fit the
    modules raises the JAX trainer's RuntimeError."""
    from .checkpoint import load_train_state

    try:
        model_state, fusion_state, opt_state, meta, step = load_train_state(checkpoint_dir)
    except (FileNotFoundError, KeyError) as e:
        logger.info("No resumable checkpoint at %s (%s); training from scratch",
                    checkpoint_dir, e)
        return None
    try:
        load_run_state(model, fusion, optimizer, model_state, fusion_state, opt_state)
    except (RuntimeError, ValueError, KeyError) as e:
        raise RuntimeError(
            f"Checkpoint at {checkpoint_dir} does not match the current model/fusion "
            "configuration (param tree mismatch) — resume with the same "
            "--model/--enable_text/fusion settings the experiment was trained with, or "
            "drop --load") from e
    set_generator_states(generators, meta)
    restore_shuffle(shuffler, meta)
    logger.info("Resumed full train state (epoch %d) from %s", step, checkpoint_dir)
    return meta


def set_generator_states(generators: dict, states: dict) -> None:
    """Each generator's saved state, `states[f"{name}_rng_state"]` (a
    state saved before the z0 stream keeps that stream's seed)."""
    for name, gen in generators.items():
        if name == "z0" and "z0_rng_state" not in states:
            continue
        gen.set_state(states[f"{name}_rng_state"])


def generator_states(generators: dict) -> dict:
    return {f"{k}_rng_state": g.get_state() for k, g in generators.items()}


def restore_shuffle(shuffler, meta: dict) -> None:
    if meta["data_rng_state"] is not None and shuffler is not None:
        shuffler._rng.bit_generator.state = meta["data_rng_state"]


def shuffle_state(shuffler):
    return shuffler._rng.bit_generator.state if shuffler is not None else None


def run_evaluation(forward, loader, device, modules) -> dict:
    """Streaming evaluation with the modules in eval mode; back to train
    mode after."""

    def forecast(batch):
        dev = to_device(batch, device)
        return forward(dev), dev["data_to_predict"], dev["mask_predicted_data"]

    for m in modules:
        m.eval()
    try:
        with torch.inference_mode():
            return evaluation(forecast, loader)
    finally:
        for m in modules:
            m.train()


def build_run(cfg: Config, sample: dict, device: torch.device,
              initial_state: tuple | None = None):
    """One run's modules, random streams and optimizer, as trainable()
    builds them: the model and fusion stack under torch.manual_seed(cfg.seed)
    (Flax takes the notes' width from the sample batch; so does the fusion
    model here), loaded from `initial_state` when given, on `device` in
    train mode; the generators {"salt": the hash dropout's salts (host),
    "sample": ProbSparse attention's train-mode key samples, "z0": the
    LatentODE's and NeuralFlow's train-mode z0 noise (both on the device)},
    each seeded cfg.seed and wired into its modules; Adam over the trainable
    parameters at cfg.lr (`capturable` on cuda).
    -> (model, fusion or None, generators, params, optimizer)"""
    from ..models import get_model

    torch.manual_seed(cfg.seed)
    model = get_model(cfg)
    fusion = None
    if cfg.enable_text:
        from ..fusion.fusion_model import FusionModel
        from ..llm.loader import get_d_model

        # raw-text notes come out of the embedding LLM at its width
        d_notes = (int(sample["notes_embeddings"].shape[-1]) if "notes_embeddings" in sample
                   else get_d_model(cfg.llm_model_fusion))
        fusion = FusionModel(cfg, d_notes=d_notes)
    if initial_state is not None:
        model.load_state_dict(initial_state[0])
        if fusion is not None:
            fusion.load_state_dict(initial_state[1])
    cast_frozen(model, cfg.frozen_param_dtype)
    generators = {"salt": torch.Generator().manual_seed(cfg.seed),
                  "sample": torch.Generator(device=device).manual_seed(cfg.seed),
                  "z0": torch.Generator(device=device).manual_seed(cfg.seed)}
    for mod in (model, fusion):
        if mod is None:
            continue
        mod.to(device).train()
        for m in mod.modules():
            if isinstance(m, Dropout):
                m.generator = generators["salt"]
            elif isinstance(m, ProbAttention):
                m.generator = generators["sample"]
            elif hasattr(m, "z0_generator"):
                m.z0_generator = generators["z0"]
    params = trainable_parameters(model, fusion)
    optimizer = make_optimizer(params, cfg.lr, cfg.w_decay, capturable=device.type == "cuda")
    return model, fusion, generators, params, optimizer


def traced_epoch(cfg: Config, start_epoch: int) -> int | None:
    """The epoch `profile_dir` traces, the JAX trainer's (:729-734): the
    first after the start epoch (the start epoch compiles there, and
    captures here), or the start epoch when it is the only one left; None
    without profile_dir."""
    if cfg.profile_dir is None:
        return None
    return start_epoch + 1 if cfg.epoch - start_epoch > 1 else start_epoch


def trainable(cfg: Config, data_obj: dict | None = None, log_every: int = 0,
              checkpoint_dir: str | None = None, timings: dict | None = None,
              device=None, initial_state: tuple | None = None) -> dict:
    """Train one (dataset, model, fusion) combination on `device` (cuda
    unless the caller asks for the CPU); returns the best epoch's test
    metrics {loss, mse, mae, rmse, mape} with best_iter, history (per
    epoch: train loss, per-step losses, val metrics, seconds, windows/s)
    and the trained `model` and `fusion` modules.

    initial_state: (model_state_dict, fusion_state_dict or None) to start
    from, e.g. the JAX package's init through convert.params_from_jax;
    otherwise torch's init under torch.manual_seed(cfg.seed).
    checkpoint_dir, if given, gets the best weights and a train state after
    every epoch; with cfg.load set, the run resumes from the latest train
    state there at the epoch after it (from scratch when there is none).
    timings, if given, gets wall seconds by phase (parse, setup: the
    epoch loop's stores, train per epoch, val, test, save: each checkpoint
    written), "epoch_loop" (its mode and graphs.StepLoop.stats(): capture
    seconds and graph nodes, replays, eager calls) and, on cuda,
    "step_ms": on the epoch loop each step's device ms under "step" (CUDA
    events around each replay or eager step, warm-up calls aside),
    streaming each step's forward, backward and optimizer device ms."""
    from ..data.loader import parse_datasets

    # --gpu pins the card before anything is placed on it (JAX :530-539)
    device = resolve_run_device(device, cfg.gpu, cfg.mesh_shape)
    check_trainable(cfg)

    def _mark(key, dt):
        if timings is not None:
            timings.setdefault(key, []).append(dt)

    if data_obj is None:
        t0 = time.time()
        data_obj = parse_datasets(cfg, verbose=False)
        _mark("parse", time.time() - t0)
    cfg = data_obj["cfg"]

    # the loader stages (raw-text note embedding, TimeLLM's exact prompts) go
    # on a copy of data_obj, as the JAX trainer installs them (:542)
    data_obj = wrap_data_loaders(cfg, data_obj, device)

    # the JAX trainer draws one sample batch for its init (trainer.py:556),
    # which advances the shuffle stream: draw it too, so the batch order
    # stays the JAX package's for the same seed
    sample = next(iter(data_obj["train_dataloader"]))
    model, fusion, generators, params, optimizer = build_run(cfg, sample, device,
                                                             initial_state)
    modules = [m for m in (model, fusion) if m is not None]
    samples, z0 = generators["sample"], generators["z0"]
    forward = make_forward(cfg, model, fusion)

    best_val_mse, best_iter, test_res, no_improve, history = np.inf, -1, None, 0, []
    start_epoch = 0
    shuffler = _find_shuffler(data_obj["train_dataloader"])
    # --load: resume after the sample batch above, which advanced the
    # shuffle stream in the saved run too; Adam's state after the
    # parameters went to the device
    meta = (_restore(checkpoint_dir, model, fusion, optimizer, generators, shuffler)
            if cfg.load is not None and checkpoint_dir is not None else None)
    if meta is not None:
        start_epoch = int(meta["epoch"]) + 1
        best_val_mse, best_iter = float(meta["best_val_mse"]), int(meta["best_iter"])
        no_improve, test_res, history = (int(meta["no_improve"]), meta["test_res"],
                                         list(meta["history"]))
    train_loader = data_obj["train_dataloader"]
    if cfg.host_prefetch > 0:  # collate ahead on a worker thread (JAX :630-634)
        from ..data.loader import PrefetchIterator

        train_loader = PrefetchIterator(train_loader, depth=cfg.host_prefetch)
    t0 = time.time()
    epochs = (_epoch_loop(cfg, data_obj, model, forward, optimizer, params, [samples, z0],
                          device, timings is not None)
              if cfg.device_loop and not log_every else None)
    _mark("setup", time.time() - t0)
    timer = None
    if epochs is None:
        timer = StepTimer() if timings is not None and device.type == "cuda" else None
        grad_step = make_grad_step(make_loss_fn(forward), optimizer, params, 1.0, timer)

    def _eval(which: str) -> dict:
        t0 = time.time()
        if epochs is not None:
            res = epochs.evaluate(which, modules)
        else:
            res = run_evaluation(forward, data_obj[f"{which}_dataloader"], device, modules)
        _mark(which, time.time() - t0)
        return res

    profile_epoch = traced_epoch(cfg, start_epoch)
    # debug_nans: anomaly mode raises where a backward first gives a NaN
    anomaly = (torch.autograd.set_detect_anomaly(True) if cfg.debug_nans
               else contextlib.nullcontext())
    with anomaly:
        for itr in range(start_epoch, cfg.epoch):
            st = time.time()
            with (_trace(cfg.profile_dir, itr, device) if itr == profile_epoch
                  else contextlib.nullcontext()):
                if epochs is not None:
                    step_losses = epochs.train(itr, train_loader)
                else:
                    step_losses = _train_epoch(cfg, itr, train_loader, grad_step, timer, device,
                                               log_every)
                _mark("train", time.time() - st)
                val_res = _eval("val")
            if best_val_mse - val_res["mse"] > cfg.early_stop_delta:
                best_val_mse, best_iter, no_improve = val_res["mse"], itr, 0
                if data_obj["test_dataloader"] is not None:
                    test_res = _eval("test")
                else:  # no test split: the best epoch's val metrics
                    test_res = dict(val_res)
                if checkpoint_dir is not None:
                    from .checkpoint import save_experiment

                    t0 = time.time()
                    save_experiment(checkpoint_dir, cfg.replace(platform="auto"),
                                    model.state_dict(),
                                    fusion.state_dict() if fusion is not None else None, itr)
                    _mark("save", time.time() - t0)
            else:
                no_improve += 1

            epoch_secs = time.time() - st
            n_windows = len(data_obj["train_dataloader"]) * cfg.batch_size
            history.append(dict(epoch=itr,
                                train_loss=step_losses[-1] if step_losses else np.nan,
                                step_losses=step_losses, val=val_res, secs=epoch_secs,
                                windows_per_sec=n_windows / max(epoch_secs, 1e-9)))
            if checkpoint_dir is not None:
                from .checkpoint import save_train_state

                meta = dict(epoch=itr, best_val_mse=float(best_val_mse), best_iter=best_iter,
                            no_improve=no_improve, test_res=test_res, history=history,
                            data_rng_state=shuffle_state(shuffler),
                            **generator_states(generators))
                t0 = time.time()
                save_train_state(checkpoint_dir, model.state_dict(),
                                 fusion.state_dict() if fusion is not None else None,
                                 optimizer.state_dict(), meta, itr)
                _mark("save", time.time() - t0)
            logger.info("- Epoch %03d | train loss %.5f | val mse %.5f mae %.5f | %.2fs"
                        " | %.0f windows/s", itr, history[-1]["train_loss"], val_res["mse"],
                        val_res["mae"], epoch_secs, history[-1]["windows_per_sec"])
            if best_iter == itr:
                logger.info("Test - best epoch %d, mse %.5f, mae %.5f",
                            best_iter, test_res["mse"], test_res["mae"])
            if no_improve >= cfg.patience:
                logger.info("Exp has been early stopped!")
                break

    if timer is not None:
        timings["step_ms"] = timer.ms
    if epochs is not None and timings is not None:
        timings["epoch_loop"] = epochs.stats()
        if device.type == "cuda":
            timings["step_ms"] = {"step": epochs.step_ms}
    assert test_res is not None, "No test results available."
    return dict(test_res, best_iter=best_iter, history=history, model=model, fusion=fusion)


def _skip_batch(itr: int, step: int, error, grad_step, device) -> None:
    """A batch that ran out of device memory before the optimizer step is
    skipped with a warning (reference main.py:1107-1110); at or after it,
    the error is raised, since the parameters or Adam state may be partly
    updated."""
    if grad_step.stepping:
        raise RuntimeError(
            f"out of memory at epoch {itr} step {step} in the optimizer step: the "
            "parameters or Adam state may be partly updated, so the batch cannot "
            "be skipped; reduce batch_size or model size") from error
    logger.warning("[OOM] epoch %d step %d: skipping batch", itr, step)
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _train_epoch(cfg, itr, loader, grad_step, timer, device, log_every) -> list[float]:
    """One streaming epoch of gradient steps; returns the steps' losses
    (an out-of-memory batch: `_skip_batch`)."""
    step_losses = []
    for step, batch in enumerate(loader):
        try:
            loss = float(grad_step(to_device(batch, device)))
        except torch.cuda.OutOfMemoryError as e:
            if timer is not None:
                timer.discard()
            _skip_batch(itr, step, e, grad_step, device)
            continue
        if timer is not None:
            timer.collect()
        if np.isnan(loss):
            raise FloatingPointError(
                f"NaN loss at epoch {itr} step {step} "
                f"(model={cfg.model}, dataset={cfg.dataset})")
        step_losses.append(loss)
        if log_every and step % log_every == 0:
            logger.info("epoch %d step %d loss %.5f", itr, step, loss)
    return step_losses


def _is_oom(error) -> bool:
    return (isinstance(error, torch.cuda.OutOfMemoryError)
            or "out of memory" in str(error).lower())


def resident_stores(cfg, data_obj, device) -> dict | None:
    """Every split as a device_loop.Resident on `device`, or None when one
    split does not build (a batch-dependent collate, a split past
    `device_loop_max_mb`, a loader that is not a BatchIterator under its
    stages)."""
    from . import device_loop as DL

    cap = cfg.device_loop_max_mb << 20
    splits = [w for w in ("train", "val", "test") if data_obj[f"{w}_dataloader"] is not None]
    built: dict = {}
    for w in splits:  # short-circuit: one split that fails decides
        bit = _find_shuffler(data_obj[f"{w}_dataloader"])
        r = DL.try_build_resident(data_obj[f"{w}_dataloader"], cap) if bit else None
        if r is None:
            return None
        built[w] = (r, bit)
    return {w: DL.Resident(w, r, bit, device) for w, (r, bit) in built.items()}


def _epoch_loop(cfg, data_obj, model, forward, optimizer, params, generators, device,
                timed: bool):
    """The run's device-side epoch loop, or None when it streams: resident
    train, val and test stores, else staged val and test stores (the train
    split staged each epoch), else None (JAX :646-701)."""
    from . import device_loop as DL

    bit_train = _find_shuffler(data_obj["train_dataloader"])
    stores = resident_stores(cfg, data_obj, device)
    if stores is not None:
        return _EpochLoop(cfg, "resident", stores, bit_train, model, forward, optimizer,
                          params, generators, device, timed)
    # the eval splits stage once (no shuffle: the train stream is untouched)
    evals = [w for w in ("val", "test") if data_obj[f"{w}_dataloader"] is not None]
    staged = {w: DL.stage_epoch(data_obj[f"{w}_dataloader"]) for w in evals}
    if any(v is None for v in staged.values()):
        return None
    return _EpochLoop(cfg, "staged", staged, bit_train, model, forward, optimizer, params,
                      generators, device, timed)


class _EpochLoop:
    """The device-resident or epoch-staged epoch loop of one run (JAX
    :636-701, 746-791), on a graphs.StepLoop: captured steps on cuda,
    eager ones on the CPU or where graphs.eager_reason names why.
    `stores`: the Resident splits, or the eval splits' staged arrays."""

    def __init__(self, cfg, mode: str, stores: dict, bit_train, model, forward, optimizer,
                 params, generators, device, timed: bool):
        from . import device_loop as DL
        from .graphs import StepLoop, eager_reason

        self.cfg, self.mode, self.bit_train, self.device = cfg, mode, bit_train, device
        self.events: list = []  # (start, end) CUDA events of the epoch's timed steps
        self.step_ms: list = []
        eager = eager_reason(cfg, model)
        self.loop = StepLoop(device, generators, eager=eager,
                             timer=self.events if timed and device.type == "cuda" else None)
        self.grad_step = make_grad_step(make_loss_fn(forward), optimizer, params, 1.0)
        how = ("captured CUDA graph steps" if self.loop.capture
               else f"eager steps ({eager or 'no CUDA graphs on ' + device.type})")
        if mode == "resident":
            self.res = stores
            self.run_train, self.run_eval = DL.make_epoch_runners(forward, self.grad_step,
                                                                  self.loop)
            logger.info("device-resident epoch loop, %s: %d train windows in device memory",
                        how, stores["train"].n_rows - 1)
        else:
            self.run_train, stage_eval, self.run_eval = DL.make_staged_runners(
                forward, self.grad_step, self.loop, device)
            for w, stacked in stores.items():
                stage_eval(w, stacked)
            logger.info("epoch-staged device loop (batch-dependent collate), %s", how)

    def stats(self) -> dict:
        return dict(self.loop.stats(), mode=self.mode)

    def collect_step_ms(self) -> None:
        """The device ms of the epoch's timed steps, once its losses were read."""
        for start, end in self.events:
            self.step_ms.append(start.elapsed_time(end))
        self.events.clear()

    def train(self, itr: int, train_loader) -> list[float]:
        """One epoch; its losses read once. A NaN loss raises at its step
        (JAX :786-791); an out-of-memory raises the JAX package's message in
        a captured loop (:755-771), and skips the batch in eager steps."""
        from . import device_loop as DL

        on_oom = lambda step, e: _skip_batch(itr, step, e, self.grad_step, self.device)
        try:
            if self.mode == "resident":
                res = self.res["train"]
                perm = DL.epoch_perm(self.bit_train, res.row_of, res.n_rows)
                losses, skipped = self.run_train(res, perm, on_oom)
            else:
                stacked = DL.stage_epoch(train_loader)
                if stacked is None:
                    raise RuntimeError("epoch staging failed mid-run")
                losses, skipped = self.run_train(stacked, on_oom)
            values = losses.tolist()
        except Exception as e:
            if self.loop.capture and _is_oom(e):
                raise RuntimeError(
                    "OOM inside the device-resident epoch loop (whole-epoch allocation). "
                    "Rerun with --device_loop false for per-batch streaming with OOM "
                    "batch-skip, or reduce batch_size / device_loop_max_mb") from e
            raise
        self.collect_step_ms()
        step = next((i for i, v in enumerate(values) if i not in skipped and np.isnan(v)), None)
        if step is not None:
            raise FloatingPointError(f"NaN loss at epoch {itr} step {step} "
                                     f"(model={self.cfg.model}, dataset={self.cfg.dataset})")
        return [v for i, v in enumerate(values) if i not in skipped]

    def evaluate(self, which: str, modules) -> dict:
        """The split's metrics: each batch's sums from the loop, reduced on
        the host in float64 (the modules in eval mode meanwhile)."""
        from . import device_loop as DL

        for m in modules:
            m.eval()
        try:
            sums = self.run_eval(self.res[which] if self.mode == "resident" else which)
            return finalize_metrics(DL.reduce_eval_sums(sums))
        finally:
            for m in modules:
                m.train()


@contextlib.contextmanager
def _trace(profile_dir: str, itr: int, device):
    """torch.profiler over the block (host and, on cuda, device activity),
    written as a Chrome trace to <profile_dir>/trace_epoch<itr>.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_epoch{itr}.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace (train+val epoch %d) -> %s", itr, path)


class _EmbedNotesLoader:
    """Wraps a loader to add note embeddings for raw-text fusion: each
    batch's `notes_text` goes through the frozen LLM (llm.loader.
    embed_notes) and comes back as `notes_embeddings` [B, N, d] with a
    matching `notes_mask`.

    Embeddings are cached by note string: the LLM is frozen and one
    note's pooled embedding does not depend on its batch neighbours, so
    the cache is exact and a string is embedded once per loader."""

    def __init__(self, base, llm, tokenizer, max_length: int):
        self.base = base
        self.llm, self.tokenizer, self.max_length = llm, tokenizer, max_length
        self._cache: dict = {}  # note string -> pooled embedding [d]
        self._d: int | None = None
        self.llm_calls = 0  # batches that reached the LLM

    def __len__(self):
        return len(self.base)

    def rebuild_around(self, base):
        """This stage around another base loader (device_loop._unwrap),
        sharing the embedding cache: a note's pooled embedding does not
        depend on its batch, so hits across splits are exact."""
        stage = _EmbedNotesLoader(base, self.llm, self.tokenizer, self.max_length)
        stage._cache, stage._d = self._cache, self._d
        return stage

    def _embed_cached(self, notes_text):
        from ..llm.loader import embed_notes

        cache = self._cache
        missing = sorted({s for seq in notes_text for s in seq if s not in cache})
        if missing or self._d is None:
            self.llm_calls += 1
            emb_new, _ = embed_notes([missing] if missing else [[]], self.llm,
                                     self.tokenizer, max_length=self.max_length)
            for s, v in zip(missing, emb_new[0]):
                cache[s] = v
            self._d = int(emb_new.shape[-1])
        B = len(notes_text)
        N_max = max((len(s) for s in notes_text), default=1) or 1
        emb = np.zeros((B, N_max, self._d), np.float32)
        note_mask = np.zeros((B, N_max), bool)
        for i, seq in enumerate(notes_text):
            for j, s in enumerate(seq):
                emb[i, j] = cache[s]
                note_mask[i, j] = True
        return emb, note_mask

    def __iter__(self):
        for batch in self.base:
            emb, note_mask = self._embed_cached(batch["notes_text"])
            N = batch["tau"].shape[1]
            if emb.shape[1] < N:  # pad the note axis to the batch's tau width
                pad = N - emb.shape[1]
                emb = np.pad(emb, ((0, 0), (0, pad), (0, 0)))
                note_mask = np.pad(note_mask, ((0, 0), (0, pad)))
            batch = dict(batch)
            batch["notes_embeddings"] = emb[:, :N]
            batch["notes_mask"] = note_mask[:, :N].astype(np.float32)
            yield batch


def make_loader_wrappers(cfg: Config, device=None) -> list:
    """Host-side loader stages a run needs, as loader -> loader callables
    (outermost last): raw-text note embedding through the frozen LLM on
    `device` (cuda unless the caller asks for the CPU) and TimeLLM's exact
    prompts. Shared by trainable() and the service. Apply once."""
    wrappers = []
    if cfg.enable_text and not cfg.use_text_embeddings:
        from ..llm.loader import load_llm, resolve_llm_mesh

        # the JAX package shards the LLM over llm_tp > 1 devices: refused here
        resolve_llm_mesh(cfg.llm_model_fusion, cfg.llm_tp)
        llm, tokenizer = load_llm(cfg.llm_model_fusion, cfg.llm_layers_fusion,
                                  device=device,
                                  use_fused_attn=cfg.use_pallas and cfg.use_fused_attn)
        wrappers.append(lambda ld: _EmbedNotesLoader(ld, llm, tokenizer, cfg.max_length))
    if cfg.model == "TimeLLM" and cfg.timellm_exact_prompt:
        # the reference's prompt: statistics to text to ids on the host, a batch at a time
        from ..llm.loader import load_tokenizer
        from ..models.timellm import LLM_ALIAS

        prompt_tok = load_tokenizer(LLM_ALIAS[cfg.llm_model_timellm])
        wrappers.append(lambda ld: _TimeLLMPromptLoader(ld, cfg, prompt_tok))
    return wrappers


def wrap_data_loaders(cfg: Config, data_obj: dict, device=None) -> dict:
    """make_loader_wrappers(cfg, device) installed on the three split
    loaders of a shallow copy of data_obj: the caller's stays unwrapped,
    so a second trainable() on it does not stack the stages (each stacked
    _EmbedNotesLoader would embed every note again into an empty cache)."""
    data_obj = dict(data_obj)
    for wrap in make_loader_wrappers(cfg, device):
        for split in ("train_dataloader", "val_dataloader", "test_dataloader"):
            if data_obj[split] is not None:
                data_obj[split] = wrap(data_obj[split])
    return data_obj


class _TimeLLMPromptLoader:
    """Adds TimeLLM's exact prompt ids to each batch (cfg.timellm_exact_prompt;
    models/timellm.build_timellm_prompt_ids), cfg.timellm_prompt_len long."""

    def __init__(self, base, cfg: Config, tokenizer):
        self.base, self.cfg, self.tokenizer = base, cfg, tokenizer

    def __len__(self):
        return len(self.base)

    def rebuild_around(self, base):
        """This stage around another base loader (device_loop._unwrap)."""
        return _TimeLLMPromptLoader(base, self.cfg, self.tokenizer)

    def __iter__(self):
        from ..models.timellm import build_timellm_prompt_ids

        for batch in self.base:
            batch = dict(batch)
            batch["prompt_ids"] = build_timellm_prompt_ids(
                self.cfg, batch, self.tokenizer, pad_to=self.cfg.timellm_prompt_len)
            yield batch
