"""Stacked-replica sweeps: the (seeds x lrs) grid of one experiment trained
in one process on one card (after imm_tsf_tpu/training/vmap_sweep.py).

The JAX package stacks the replicas' parameters, Adam state and keys on a
leading axis and vmaps one step over them, so XLA fuses S replicas into
batched products ("the sweep, not the step, is the real workload").
`torch.func.vmap` cannot do that here: it does not batch the ctypes
kernels (#1 and #2; #4-#7 on CRU), the host-drawn salts of the hash
dropout (layers/fast_dropout.SaltTape), ProbSparse attention's device
generator, or Adam at a learning rate of each replica's own. So the port
keeps S module sets with S optimizers (trainer.build_run, each built
right after torch.manual_seed of its seed) and shares the data:

- resident mode (every split builds, training/device_loop.py): ONE set of
  Resident stores and row tables, and one graphs.StepLoop a replica with
  its own stream, graph memory pools, `pos` and salt tape. Per batch the
  host replays the S replicas' captured steps back to back, each on its
  own stream (graphs.interleave), so their kernels can overlap on the SMs.
  The epoch's row table is loaded before any replica's first step, and
  the next epoch's only once every replica's stream has finished. One
  graph of all S steps on one stream would save S - 1 replay calls a
  batch but run the replicas' kernels one after another;
- streaming mode (`--device_loop false`, or a split that does not build:
  the LatentODE's union axis, since the JAX sweep has no staged mode):
  each batch is collated and copied to the device once, and the S replicas
  step eagerly one after another.

The contract is the JAX module's (tests/test_torch_sweep.py):
  - grid order rep = [(s, l) for l in (lrs or [cfg.lr]) for s in seeds]
    (:70), seeds from cfg.seed, cfg.vmap_seeds of them, by default;
  - one data order: data_seed defaults to cfg.seed (:73-74), and one
    sample batch is drawn for the init (:102), as trainable() draws it;
  - replica (s, l) reproduces trainable(cfg.replace(seed=s, lr=l,
    data_seed=base)) of the port: its init, its salt, sample and z0
    generators, its Adam at lr l, its best epoch, patience and test
    metrics. Test runs for every replica when any improved; with no test
    split the best epoch's val metrics are reported. The run stops when
    every replica has exhausted its patience; a replica that stopped still
    steps, but its results are locked (:252-254, :377-406, :440-460);
  - a replica whose loss turns NaN in an epoch is frozen from then on and
    marked `diverged`; the rest go on, and FloatingPointError is raised
    only when every replica has diverged (:352-375);
  - with a checkpoint_dir, `config.json`, a train state of all replicas
    after every epoch (training/checkpoint.py: lists of per-replica states,
    the per-replica generator states in place of the JAX key data) and
    `best/` with each replica's best-epoch weights and `replicas.json`
    (:327-333, :413-439); cfg.load resumes bit for bit, and a grid that
    does not match the checkpoint raises the JAX message (:290-298).

Out-of-memory steps are not skipped here (the JAX sweep has no such
path): they raise.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time

import numpy as np
import torch

from ..config import Config
from ..device import resolve_run_device
from . import device_loop as DL
from .graphs import interleave
from .trainer import (_EpochLoop, _find_shuffler, _trace, build_run, check_trainable,
                      generator_states, load_run_state, make_forward, make_grad_step,
                      make_loss_fn, resident_stores, restore_shuffle, run_evaluation,
                      set_generator_states, shuffle_state, to_device, traced_epoch,
                      wrap_data_loaders)

logger = logging.getLogger("imm_tsf_torch")


class _Replica:
    """One replica of the grid, built from its config (seed s, lr l): its
    modules, random streams, optimizer and gradient step; `epochs`, its
    _EpochLoop over the shared Resident stores in resident mode."""

    def __init__(self, cfg: Config, sample: dict, device, initial_state, stores, bit_train,
                 timed: bool):
        (self.model, self.fusion, self.generators, params,
         self.optimizer) = build_run(cfg, sample, device, initial_state)
        self.modules = [m for m in (self.model, self.fusion) if m is not None]
        self.forward = make_forward(cfg, self.model, self.fusion)
        self.epochs = None
        if stores is not None:
            self.epochs = _EpochLoop(cfg, "resident", stores, bit_train, self.model,
                                     self.forward, self.optimizer, params,
                                     [self.generators["sample"], self.generators["z0"]],
                                     device, timed)
            self.grad_step = self.epochs.grad_step
        else:
            self.grad_step = make_grad_step(make_loss_fn(self.forward), self.optimizer,
                                            params, 1.0)

    def states(self) -> tuple:
        return (self.model.state_dict(),
                self.fusion.state_dict() if self.fusion is not None else None)

    def host_states(self) -> tuple:
        """A copy of the weights on the host (a best epoch's)."""
        return tuple(None if sd is None else {k: v.detach().to("cpu", copy=True)
                                              for k, v in sd.items()}
                     for sd in self.states())


def _resume(checkpoint_dir: str, replicas: list, grid: dict, shuffler) -> dict | None:
    """The latest sweep train state into every replica and the shuffler;
    its meta, or None when there is none (the sweep trains from scratch)."""
    from .checkpoint import load_train_state

    try:
        model_states, fusion_states, opt_states, meta, step = load_train_state(checkpoint_dir)
    except (FileNotFoundError, KeyError) as e:
        logger.info("No resumable sweep checkpoint at %s (%s); training from scratch",
                    checkpoint_dir, e)
        return None
    try:
        if {k: meta.get(k) for k in grid} != grid:
            raise ValueError(f"the checkpoint's grid is {[meta.get(k) for k in grid]}")
        if not (isinstance(model_states, list) and len(model_states) == len(replicas)
                and len(fusion_states) == len(opt_states) == len(replicas)):
            raise ValueError("the checkpoint holds another number of replicas")
        for r, m, f, o in zip(replicas, model_states, fusion_states, opt_states):
            load_run_state(r.model, r.fusion, r.optimizer, m, f, o)
    except (RuntimeError, ValueError, KeyError, TypeError) as e:
        raise RuntimeError(
            f"Sweep checkpoint at {checkpoint_dir} does not match the current replica grid / "
            f"model configuration (stacked param tree mismatch; this run has {len(replicas)} "
            "replicas = seeds x lrs) — resume with the same --model/--vmap_seeds/--lrs/fusion "
            "settings the sweep was trained with, or drop --load") from e
    for r, states in zip(replicas, meta["rng_states"]):
        set_generator_states(r.generators, states)
    restore_shuffle(shuffler, meta)
    logger.info("Resumed stacked sweep state (epoch %d) from %s", step, checkpoint_dir)
    return meta


def train_seed_sweep(cfg: Config, seeds=None, lrs=None, data_obj: dict | None = None,
                     checkpoint_dir: str | None = None, timings: dict | None = None,
                     device=None, initial_states: list | None = None) -> list[dict]:
    """Train the (seeds x lrs) replica grid of cfg on `device` (cuda unless
    the caller asks for the CPU); returns one result a replica, in grid
    order, with trainable()'s keys (the best epoch's test metrics,
    best_iter, history, model, fusion) and `seed`, `lr` when lrs are
    given, `diverged` for a replica that turned NaN.

    initial_states: one (model_state_dict, fusion_state_dict or None) a
    replica, as trainable()'s initial_state. timings, if given, gets wall
    seconds by phase (parse, setup, train, val, test, save), "epoch_loop"
    ({"mode": "resident" or "streaming", "replicas": each replica's
    graphs.StepLoop.stats()}), on cuda "step_ms" ({"step": each
    replica's device ms a step on the resident loop}) and "peak_bytes"
    (torch.cuda.max_memory_allocated over the run)."""
    from ..data.loader import PrefetchIterator, parse_datasets

    seeds = list(seeds if seeds is not None else range(cfg.seed, cfg.seed + cfg.vmap_seeds))
    lrs = list(lrs) if lrs else None
    rep = [(s, l) for l in (lrs or [cfg.lr]) for s in seeds]
    S = len(rep)
    if S < 1:
        raise ValueError("train_seed_sweep: the replica grid is empty")
    if initial_states is not None and len(initial_states) != S:
        raise ValueError(f"train_seed_sweep: {len(initial_states)} initial states for "
                         f"{S} replicas")
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
    if cfg.data_seed is None:
        cfg = cfg.replace(data_seed=cfg.seed)
    data_obj = wrap_data_loaders(cfg, data_obj, device)
    sample = next(iter(data_obj["train_dataloader"]))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    t0 = time.time()
    shuffler = _find_shuffler(data_obj["train_dataloader"])
    stores = resident_stores(cfg, data_obj, device) if cfg.device_loop else None
    timed = timings is not None
    replicas = [_Replica(cfg.replace(seed=s, lr=l), sample, device,
                         initial_states[i] if initial_states is not None else None,
                         stores, shuffler, timed)
                for i, (s, l) in enumerate(rep)]
    _mark("setup", time.time() - t0)
    mode = "resident" if stores is not None else "streaming"
    logger.info("stacked sweep: %d replicas (seeds %s x lrs %s), %s epochs", S, seeds,
                lrs or [cfg.lr], mode)
    train_loader = data_obj["train_dataloader"]
    if stores is None and cfg.host_prefetch > 0:
        train_loader = PrefetchIterator(train_loader, depth=cfg.host_prefetch)

    def train_epoch(active: list) -> dict:
        """One epoch of the active replicas' steps -> {replica: losses}."""
        if stores is not None:
            res = stores["train"]
            perm = DL.epoch_perm(shuffler, res.row_of, res.n_rows)
            res.load(perm)
            select = DL.gather(res.table)
            out = interleave([replicas[i].epochs.loop.train_steps(
                replicas[i].grad_step, res.key, res.store, select, len(perm)) for i in active])
            losses = {i: o[0].tolist() for i, o in zip(active, out)}
            for i in active:
                replicas[i].epochs.collect_step_ms()
            return losses
        losses = {i: [] for i in active}
        for batch in train_loader:
            dev = to_device(batch, device)
            for i in active:
                losses[i].append(replicas[i].grad_step(dev))
        return {i: torch.stack(v).tolist() if v else [] for i, v in losses.items()}

    def evaluate(which: str, idx: list) -> dict:
        t0 = time.time()
        out = {}
        for i in idx:
            r = replicas[i]
            if r.epochs is not None:
                out[i] = r.epochs.evaluate(which, r.modules)
            else:
                out[i] = run_evaluation(r.forward, data_obj[f"{which}_dataloader"], device,
                                        r.modules)
        _mark(which, time.time() - t0)
        return out

    grid = {"seeds": [s for s, _ in rep], "lrs": [l for _, l in rep] if lrs else None}
    best_val = np.full(S, np.inf)
    best_iter = np.full(S, -1)
    no_improve = np.zeros(S, int)
    failed = np.zeros(S, bool)  # replicas that diverged to NaN
    test_res: list = [None] * S
    history: list = [[] for _ in range(S)]
    start_epoch = 0
    val = None
    if cfg.load is not None and checkpoint_dir is not None:
        meta = _resume(checkpoint_dir, replicas, grid, shuffler)
        if meta is not None:
            start_epoch = int(meta["epoch"]) + 1
            best_val = np.asarray(meta["best_val"], np.float64)
            best_iter = np.asarray(meta["best_iter"], int)
            no_improve = np.asarray(meta["no_improve"], int)
            failed = np.asarray(meta["failed"], bool)
            test_res, history = list(meta["test_res"]), [list(h) for h in meta["history"]]

    # each replica's best-epoch weights on the host, kept to be saved: the
    # rolling train states keep only the latest two epochs
    best = None
    if checkpoint_dir is not None:
        from .checkpoint import load_weights, save_weights

        best = [r.host_states() for r in replicas]
        if cfg.load is not None:
            try:
                saved = load_weights(os.path.join(checkpoint_dir, "best"))
                best = list(zip(saved["model"], saved["fusion"]))
            except FileNotFoundError:
                pass
        os.makedirs(checkpoint_dir, exist_ok=True)
        with open(os.path.join(checkpoint_dir, "config.json"), "w") as f:
            f.write(cfg.replace(platform="auto").to_json())

    profile_epoch = traced_epoch(cfg, start_epoch)
    n_windows = len(data_obj["train_dataloader"]) * cfg.batch_size
    for itr in range(start_epoch, cfg.epoch):
        st = time.time()
        active = [i for i in range(S) if not failed[i]]
        with (_trace(cfg.profile_dir, itr, device) if itr == profile_epoch
              else contextlib.nullcontext()):
            losses = train_epoch(active)
            _mark("train", time.time() - st)
            # a NaN freezes its replica (its results so far stand); NaNs of a
            # replica whose results are already locked are ignored
            nan_now = np.array([i in losses and bool(np.isnan(losses[i]).any())
                                and no_improve[i] < cfg.patience for i in range(S)])
            if nan_now.any():
                logger.warning("NaN loss at epoch %d for (seed, lr) replicas %s (model=%s, "
                               "dataset=%s) — freezing them, continuing the rest", itr,
                               [rep[i] for i in np.nonzero(nan_now)[0]], cfg.model,
                               cfg.dataset)
                failed |= nan_now
                no_improve[nan_now] = cfg.patience
            if failed.all():
                raise FloatingPointError(f"all replicas diverged to NaN by epoch {itr} "
                                         f"(model={cfg.model}, dataset={cfg.dataset})")
            live = [i for i in range(S) if not failed[i]]
            val_now = evaluate("val", live)
        nan_metrics = dict.fromkeys(val_now[live[0]], float("nan"))
        val = [val_now.get(i, nan_metrics) for i in range(S)]
        improved = np.array([best_val[i] - val[i]["mse"] > cfg.early_stop_delta
                             and no_improve[i] < cfg.patience for i in range(S)])
        test_now = None
        if improved.any() and data_obj["test_dataloader"] is not None:
            test_now = evaluate("test", live)
        epoch_secs = time.time() - st
        for i in range(S):
            if no_improve[i] >= cfg.patience:  # stopped or diverged: locked
                continue
            if improved[i]:
                best_val[i], best_iter[i], no_improve[i] = val[i]["mse"], itr, 0
                # no test split: the best epoch's val metrics
                test_res[i] = test_now[i] if test_now is not None else dict(val[i])
                if best is not None:
                    best[i] = replicas[i].host_states()
            else:
                no_improve[i] += 1
            step_losses = losses.get(i, [])
            history[i].append(dict(epoch=itr,
                                   train_loss=step_losses[-1] if step_losses else np.nan,
                                   step_losses=step_losses, val=val[i], secs=epoch_secs,
                                   windows_per_sec=n_windows / max(epoch_secs, 1e-9)))
        if checkpoint_dir is not None:
            from .checkpoint import save_train_state

            t0 = time.time()
            meta = dict(epoch=itr, **grid, best_val=best_val.tolist(),
                        best_iter=best_iter.tolist(), no_improve=no_improve.tolist(),
                        test_res=test_res, failed=failed.tolist(), history=history,
                        rng_states=[generator_states(r.generators) for r in replicas],
                        data_rng_state=shuffle_state(shuffler))
            states = [r.states() for r in replicas]
            save_train_state(checkpoint_dir, [m for m, _ in states], [f for _, f in states],
                             [r.optimizer.state_dict() for r in replicas], meta, itr)
            if improved.any():
                best_dir = os.path.join(checkpoint_dir, "best")
                save_weights(best_dir, [m for m, _ in best], [f for _, f in best], itr)
                with open(os.path.join(best_dir, "replicas.json"), "w") as f:
                    json.dump(dict(grid, best_iter=best_iter.tolist()), f)
            _mark("save", time.time() - t0)
        logger.info("- Epoch %03d [x%d replicas] | losses %s | val mse %s | %.2fs | %.0f "
                    "windows/s", itr, S,
                    [round(losses[i][-1], 5) if losses.get(i) else None for i in range(S)],
                    [round(v["mse"], 5) for v in val], epoch_secs,
                    S * n_windows / max(epoch_secs, 1e-9))
        if (no_improve >= cfg.patience).all():
            break

    if val is None:
        # resumed at (or past) the epoch budget: the loop never ran; the
        # no-test fallback reads a fresh val evaluation
        live = [i for i in range(S) if not failed[i]]
        val_now = evaluate("val", live) if live else {}
        val = [val_now.get(i) for i in range(S)]
    if timings is not None:
        timings["epoch_loop"] = {"mode": mode, "replicas": [
            r.epochs.stats() if r.epochs is not None else None for r in replicas]}
        if device.type == "cuda":
            timings["step_ms"] = {"step": [r.epochs.step_ms if r.epochs is not None else []
                                           for r in replicas]}
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        logger.info("stacked sweep: peak device memory %.3f GB for %d replicas", peak / 1e9, S)
        if timings is not None:
            timings["peak_bytes"] = peak

    out = []
    for i, (s, l) in enumerate(rep):
        r = dict(test_res[i] if test_res[i] is not None else (val[i] or {}))
        r.update(best_iter=int(best_iter[i]), seed=s, history=history[i],
                 model=replicas[i].model, fusion=replicas[i].fusion)
        if lrs:
            r["lr"] = l
        if failed[i]:
            r["diverged"] = True
        out.append(r)
    return out
