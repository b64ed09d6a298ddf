"""Batch inference entry point (after the root predict.py): restore a trained
experiment and forecast a split.

    python -m imm_tsf_torch.predict --load <ExpID> [--split test] \\
        [--out predictions.npz] [--device cuda] [other main flags]

Restores `<save>/experiment_<ExpID>/`: its config.json (flags passed
explicitly override it; an experiment without one needs the training
flags again) and its best-epoch weights (`best/`; else the latest train
state), on `--device` (cuda unless `--device cpu`). The split runs on the
epoch loop's predict runner (training/device_loop.make_predict_runner,
captured eval steps on cuda) when it fits `device_loop_max_mb` on the
device, or streams batch by batch otherwise (`--device_loop false`, the
LatentODE's union axes), each batch a replay of its shape's CUDA graph
on cuda (training/graphs.ForwardGraphs, the JAX package's jitted
predict_step; the loader pads the last batch, so one shape a run but for
the LatentODE's union-axis buckets). Writes an .npz of pred / target / mask /
tp_to_predict with `--out`, and prints the split's metrics (the masked
two-stage definitions of training, reference lib/evaluation.py:192-283)
with n_windows and windows_per_sec as one JSON line (streaming, also the
runner's "graphs": ForwardGraphs.stats()).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def restore_config(cli_cfg, rest: list[str], exp_dir: str):
    """The experiment's config.json with the flags passed explicitly
    overriding it; without one, the flags and the presets (legacy)."""
    from .config import apply_presets, resolve_max_length, restore_experiment_config
    from .main import fixed_params, tunable_params

    cfg = restore_experiment_config(cli_cfg, rest, exp_dir)
    if cfg is not None:
        print(f"# restored training config from {exp_dir}/config.json", file=sys.stderr)
        return cfg, True
    cfg = apply_presets(cli_cfg, fixed_params, tunable_params)
    if cfg.enable_text:
        cfg = resolve_max_length(cfg)
    return cfg, False


def main(argv=None) -> dict:
    from .data.loader import parse_datasets
    from .device import resolve_run_device
    from .main import get_args_from_parser
    from .serving import restore_modules
    from .training import device_loop as DL
    from .training.checkpoint import load_train_state, load_weights
    from .training.evaluation import batch_error_sums, finalize_metrics
    from .training.graphs import ForwardGraphs, StepLoop, eager_reason
    from .training.trainer import _find_shuffler, make_forward, make_loader_wrappers

    argv = list(sys.argv[1:] if argv is None else argv)
    pre = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    pre.add_argument("--split", choices=["train", "val", "test"], default="test")
    pre.add_argument("--out", default=None, help="write predictions .npz here")
    pre_args, rest = pre.parse_known_args(argv)

    cli, device = get_args_from_parser(rest)
    if cli.load is None:
        pre.error("predict requires --load <ExpID> (a trained experiment)")
    exp_dir = f"{cli.save.rstrip('/')}/experiment_{cli.load}"
    cfg, _ = restore_config(cli, rest, exp_dir)
    device = resolve_run_device(device, cfg.gpu, cfg.mesh_shape)

    data_obj = parse_datasets(cfg, verbose=False)
    cfg = data_obj["cfg"]
    loader = data_obj[f"{pre_args.split}_dataloader"]
    if loader is None:
        raise SystemExit(f"split {pre_args.split!r} is empty for this dataset")
    # the loader stages, as trainable() installs them (raw-text notes,
    # TimeLLM's exact prompts)
    for wrap in make_loader_wrappers(cfg, device):
        loader = wrap(loader)

    try:
        state = load_weights(os.path.join(exp_dir, "best"), map_location=device)
        print(f"# restored best-epoch weights (epoch {state['step']}) from {exp_dir}/best",
              file=sys.stderr)
    except FileNotFoundError:
        model_state, fusion_state, _, _, step = load_train_state(exp_dir)
        state = {"model": model_state, "fusion": fusion_state, "step": step}
        print(f"# restored rolling train state (epoch {step}) from {exp_dir}", file=sys.stderr)
    model, fusion = restore_modules(cfg, state, device)
    forward = make_forward(cfg, model, fusion)

    bit = _find_shuffler(loader)
    built = (DL.try_build_resident(loader, cfg.device_loop_max_mb << 20)
             if cfg.device_loop and bit is not None else None)
    if built is not None:
        # every window resident on the device: the epoch loop's predict
        # runner (the first call warms up and captures, the second replays)
        res = DL.Resident(pre_args.split, built, bit, device)
        run_predict = DL.make_predict_runner(forward, StepLoop(device, eager=eager_reason(cfg)))
        tw = time.perf_counter()
        with torch.no_grad():
            pred, sums = run_predict(res)
        pred = pred.cpu().numpy()
        print(f"# warm-up and capture {time.perf_counter() - tw:.2f}s", file=sys.stderr)
        t0 = time.perf_counter()
        with torch.no_grad():
            pred2, sums = run_predict(res)
        pred2 = pred2.cpu().numpy()
        dt = time.perf_counter() - t0
        n = len(bit.indices)
        # finite over the real windows; pad rows are masked out of the metrics
        if not np.isfinite(pred2.reshape((-1,) + pred2.shape[2:])[:n]).all():
            raise FloatingPointError("non-finite prediction")
        arrays = built[0]
        preds = [pred.reshape((-1,) + pred.shape[2:])[:n]]
        targets = [arrays["data_to_predict"][:n]]
        masks = [arrays["mask_predicted_data"][:n]]
        tps = [arrays["tp_to_predict"][:n]]
        acc = DL.reduce_eval_sums(sums)
        n_windows = n
    else:
        preds, targets, masks, tps = [], [], [], []
        acc, n_windows = None, 0

        def predict_step(dev):
            pred = forward(dev)
            return pred, batch_error_sums(pred, dev["data_to_predict"],
                                          dev["mask_predicted_data"])

        step = ForwardGraphs(predict_step, device)
        with torch.inference_mode():
            first = next(iter(loader), None)  # warm-up: kernel libraries, caches, the capture
            if first is not None:
                step(first)[0].cpu()
            t0 = time.perf_counter()
            for batch in loader:
                n_real = batch.get("n_real", batch["observed_data"].shape[0])
                pred, sums = step(batch)
                preds.append(pred.cpu().numpy()[:n_real])
                targets.append(batch["data_to_predict"][:n_real])
                masks.append(batch["mask_predicted_data"][:n_real])
                tp = batch["tp_to_predict"]
                tps.append(tp[:n_real] if tp.ndim >= 2 else
                           np.broadcast_to(tp, (n_real,) + tp.shape))
                sums = {k: v.double().cpu().numpy() for k, v in sums.items()}
                if acc is None:
                    acc = sums
                else:
                    for k in acc:
                        acc[k] += sums[k]
                n_windows += n_real
            dt = time.perf_counter() - t0
        if acc is None:
            raise SystemExit(
                f"split {pre_args.split!r} yielded no batches: the split is empty for "
                "this dataset and window config (training's evaluation guards the same)")

    metrics = finalize_metrics(acc)
    out = {f"{pre_args.split}_{k}": float(v) for k, v in metrics.items()}
    out["n_windows"] = n_windows
    out["windows_per_sec"] = round(n_windows / dt, 1)
    out["path"] = "resident" if built is not None else "streaming"
    if built is None:
        out["graphs"] = step.stats()
    if pre_args.out:
        np.savez_compressed(pre_args.out, pred=np.concatenate(preds),
                            target=np.concatenate(targets), mask=np.concatenate(masks),
                            tp_to_predict=np.concatenate(tps))
        out["saved"] = pre_args.out
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
