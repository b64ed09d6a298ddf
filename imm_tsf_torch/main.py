"""Training entry point (after the JAX package's main.py:34-126).

One (dataset, model, fusion) training run on one card:

    python -m imm_tsf_torch.main --dataset EPA-Air --data_root <root> \\
        --model CRU --overwrite_args --enable_text --use_text_embeddings \\
        --TTF_module TTF_RecAvg --MMF_module MMF_GR_Add [--device cpu]

Every Config field is a flag `--<name> <value>` (bools also bare);
`--overwrite_args` applies the fixed / tunable / dataset / model preset
overlays in the reference order. `--device` (default cuda) picks where it
runs. Best weights and config.json go to <save>/experiment_<id>/, which
`python -m imm_tsf_torch.serve --load` serves, with the full training
state of the latest two epochs. `--load <id>` names the experiment
(<save>/experiment_<id>/) and resumes it from its latest state at the
next epoch, up to `--epoch` epochs in all; with no state there it trains
from scratch under that id. The final test metrics are printed as one
JSON line.

`--vmap_seeds N` (N > 1) and/or `--vmap_lrs l1 l2 ...` train the (seeds x
lrs) grid of replicas of the experiment in one process on one card
(training/vmap_sweep.py), seeds from `--seed`; one JSON line a replica,
with its `seed` (and `lr` under `--vmap_lrs`). `--gpu N` picks the card
when `--device` names no index (device.resolve_run_device).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import random

from .config import Config, apply_presets, derive_npatch, resolve_max_length

# Optional- and tuple-typed flags cannot be inferred from a None or empty
# default (reference flag surface main.py:43-759)
_OPT_INT_FLAGS = {"npatch", "patch_stride", "llm_layers_fusion", "cru_lsd", "cru_hidden_units",
                  "data_seed"}
_OPT_FLOAT_FLAGS = {"unit_scale"}
_TUPLE_FLOAT_FLAGS = {"vmap_lrs"}
_TUPLE_INT_FLAGS = {"mesh_shape", "cru_trans_net_hidden_units"}
_TUPLE_STR_FLAGS = {"mesh_axis_names", "rec_ids"}

# the reference's in-file experiment dicts (main.py:1208-1243)
fixed_params: dict = {}
tunable_params: dict = {"batch_size": 32}


def get_args_from_parser(argv=None) -> tuple[Config, str]:
    """-> (Config from the flags, device)."""
    # allow_abbrev=False: a prefix (--batch for --batch_size) would defeat
    # the explicit-flag detection of restore_experiment_config
    parser = argparse.ArgumentParser("imm_tsf_torch.main", allow_abbrev=False)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    default = Config()
    for f in dataclasses.fields(Config):
        name, val = f"--{f.name}", getattr(default, f.name)
        if f.name in _TUPLE_INT_FLAGS:
            parser.add_argument(name, type=int, nargs="*", default=val)
        elif f.name in _TUPLE_FLOAT_FLAGS:
            parser.add_argument(name, type=float, nargs="*", default=val)
        elif f.name in _TUPLE_STR_FLAGS:
            parser.add_argument(name, type=str, nargs="*", default=val)
        elif isinstance(val, bool):
            # bare `--flag` means True; `--flag false` also accepted
            parser.add_argument(name, nargs="?", const=True,
                                type=lambda s: s.lower() in ("1", "true", "yes"), default=val)
        elif f.name in _OPT_INT_FLAGS or isinstance(val, int):
            parser.add_argument(name, type=int, default=val)
        elif f.name in _OPT_FLOAT_FLAGS or isinstance(val, float):
            parser.add_argument(name, type=float, default=val)
        else:
            parser.add_argument(name, type=str, default=val)
    ns = parser.parse_args(argv)
    kw = {f.name: getattr(ns, f.name) for f in dataclasses.fields(Config)}
    for name in _TUPLE_INT_FLAGS | _TUPLE_FLOAT_FLAGS | _TUPLE_STR_FLAGS:
        if isinstance(kw.get(name), list):
            kw[name] = tuple(kw[name])
    if kw["npatch"] is None:  # derived from the pre-preset values (main.py:748-750)
        kw["npatch"] = derive_npatch(kw["history"], kw["patch_size"], kw["stride"])
    return Config(**kw), ns.device


def main(argv=None, timings: dict | None = None) -> dict | list[dict]:
    """Train as the flags say; returns trainable()'s result, or with
    `--vmap_seeds` > 1 or `--vmap_lrs` the sweep's list of replica results
    (training/vmap_sweep.train_seed_sweep). `timings` is handed to either."""
    from .training.trainer import trainable

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    logger = logging.getLogger("imm_tsf_torch")
    cfg, device = get_args_from_parser(argv)
    cfg = apply_presets(cfg, fixed_params, tunable_params)
    if cfg.enable_text:
        cfg = resolve_max_length(cfg)  # main.py:968-969
    experiment_id = cfg.load or int(random.SystemRandom().random() * 100000)
    logger.info("ExpID %s | %s", experiment_id, cfg.to_json())
    checkpoint_dir = f"{cfg.save.rstrip('/')}/experiment_{experiment_id}"
    if cfg.vmap_seeds > 1 or cfg.vmap_lrs:
        # the (seeds x lrs) replica grid in one process (JAX main.py:102-114)
        from .training.vmap_sweep import train_seed_sweep

        results = train_seed_sweep(cfg, lrs=cfg.vmap_lrs or None, checkpoint_dir=checkpoint_dir,
                                   timings=timings, device=device)
        for r in results:
            printable = {k: v for k, v in r.items()
                         if k in ("loss", "mse", "mae", "rmse", "mape", "best_iter", "seed",
                                  "lr")}
            logger.info("Final test metrics: %s", json.dumps(printable))
            print(json.dumps(printable), flush=True)
        return results
    res = trainable(cfg, checkpoint_dir=checkpoint_dir, timings=timings, device=device)
    printable = {k: v for k, v in res.items()
                 if k in ("loss", "mse", "mae", "rmse", "mape", "best_iter")}
    logger.info("Final test metrics: %s", json.dumps(printable))
    print(json.dumps(printable), flush=True)
    return res


if __name__ == "__main__":
    main()
