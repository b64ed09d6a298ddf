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
with its `seed` (and `lr` under `--vmap_lrs`). With `--mesh_shape N` too,
the sweep runs on N ranks: each trains S/N of the replicas where N divides
the grid's S, else every replica's batches split over the ranks. `--gpu N` picks the card
when `--device` names no index (device.resolve_run_device).

`--mesh_shape N` (N > 1) trains the experiment over a data mesh of N
ranks (parallel/mesh.py), the JAX package's ("data",) mesh, and gives the
single-process run's answer on the global batch: N worker processes
(torch.multiprocessing, spawn) on a localhost TCP store, rank r on
cuda:(gpu + r) over NCCL, or on the CPU over gloo with `--device cpu`.
`--share_card` puts every rank on one card, over gloo. Under torchrun (RANK and WORLD_SIZE
set) this process is one rank and starts none. Only rank 0 logs and
prints; the ranks share rank 0's ExpID. `--mesh_shape 1` trains in this
process through the same collectives, over one rank.

    python -m imm_tsf_torch.main --device cpu --mesh_shape 2 --dataset EPA-Air ...

The run logs to the console and to its log file (utils/logging.log_path_for:
logs/<dataset>_<model>_... .log), opened in `--logmode` ("a" appends, "w"
truncates), which starts with the ExpID and argv, the resolved config and
the provenance line (utils/provenance.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import random
import sys

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


def _parser() -> argparse.ArgumentParser:
    # allow_abbrev=False: a prefix (--batch for --batch_size) would defeat
    # the explicit-flag detection of restore_experiment_config
    parser = argparse.ArgumentParser("imm_tsf_torch.main", allow_abbrev=False)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--share_card", nargs="?", const=True, default=False,
                        type=lambda s: s.lower() in ("1", "true", "yes"),
                        help="every rank of --mesh_shape on one card (gloo)")
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
    return parser


def get_args_from_parser(argv=None) -> tuple[Config, str]:
    """-> (Config from the flags, device)."""
    ns = _parser().parse_args(argv)
    kw = {f.name: getattr(ns, f.name) for f in dataclasses.fields(Config)}
    for name in _TUPLE_INT_FLAGS | _TUPLE_FLOAT_FLAGS | _TUPLE_STR_FLAGS:
        if isinstance(kw.get(name), list):
            kw[name] = tuple(kw[name])
    if kw["npatch"] is None:  # derived from the pre-preset values (main.py:748-750)
        kw["npatch"] = derive_npatch(kw["history"], kw["patch_size"], kw["stride"])
    return Config(**kw), ns.device


_PRINTED = ("loss", "mse", "mae", "rmse", "mape", "best_iter")


def main(argv=None, timings: dict | None = None) -> dict | list[dict]:
    """Train as the flags say; returns trainable()'s result, or with
    `--vmap_seeds` > 1 or `--vmap_lrs` the sweep's list of replica results
    (training/vmap_sweep.train_seed_sweep). `timings` is handed to either.
    With `--mesh_shape N` (N > 1) outside torchrun it starts the N ranks
    and returns rank 0's result without the modules (its metrics, best_iter
    and history) and rank 0's timings in `timings`."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg, device = get_args_from_parser(argv)
    ns = _parser().parse_known_args(argv)[0]
    if cfg.mesh_shape:
        from .parallel.mesh import check_mesh_shape

        world = check_mesh_shape(cfg.mesh_shape)
        if world > 1 and "RANK" not in os.environ:
            return _launch_ranks(argv, cfg, device, ns, world, timings)
        if "RANK" in os.environ:  # one rank of torchrun's
            from .parallel.mesh import init_distributed, rank_device

            import torch

            rank, local = int(os.environ["RANK"]), int(os.environ.get("LOCAL_RANK", 0))
            dev = rank_device(device, local, cfg.gpu, ns.share_card, world)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            init_distributed(int(os.environ["WORLD_SIZE"]), rank, None,
                             "gloo" if ns.share_card else None, dev)
            return _run(argv, cfg, dev, _shared_id(cfg), timings)
    return _run(argv, cfg, device, cfg.load or _new_id(), timings)


def _new_id() -> int:
    return int(random.SystemRandom().random() * 100000)


def _shared_id(cfg):
    """Rank 0's ExpID, on every rank (torchrun)."""
    import torch.distributed as dist

    box = [cfg.load or _new_id()]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _launch_ranks(argv, cfg, device, ns, world: int, timings):
    """The N ranks of `--mesh_shape N` as worker processes (parallel/
    multiproc.World), under one ExpID; rank 0's result."""
    import torch

    from .parallel.multiproc import launch

    # CPU ranks divide this process's threads between them
    threads = max(1, torch.get_num_threads() // world) if device == "cpu" else None
    out = launch(_rank_main, world, (argv, cfg.load or _new_id(), timings is not None),
                 device=device, gpu=cfg.gpu, share_card=ns.share_card, threads=threads)
    res, rank0_timings = out[0]
    if timings is not None:
        timings.update(rank0_timings)
    return res


def _rank_main(dev, argv, experiment_id, timed: bool):
    """One rank of `--mesh_shape N` (a World's fn): rank 0's result, without
    the modules, and its timings; None from the other ranks."""
    import torch.distributed as dist

    cfg = get_args_from_parser(argv)[0]
    timings: dict | None = {} if timed else None
    res = _run(argv, cfg, dev, experiment_id, timings)
    if dist.get_rank() != 0:
        return None
    strip = lambda r: {k: v for k, v in r.items() if k not in ("model", "fusion")}
    return (list(map(strip, res)) if isinstance(res, list) else strip(res)), timings or {}


def _run(argv, cfg, device, experiment_id, timings):
    from .training.trainer import trainable
    from .utils.logging import get_logger, log_path_for
    from .utils.provenance import provenance

    cfg = apply_presets(cfg, fixed_params, tunable_params)
    if cfg.enable_text:
        cfg = resolve_max_length(cfg)  # main.py:968-969
    rank0 = _rank() == 0
    # the run's log file in cfg.logmode, with the JAX main.py:95-100 lines;
    # under a data mesh rank 0's alone
    if rank0:
        logger = get_logger(log_path_for(cfg), mode=cfg.logmode)
    else:
        logger = logging.getLogger("imm_tsf_torch")
        logger.setLevel(logging.WARNING)
    logger.info("ExpID %s | %s", experiment_id, " ".join(argv))
    logger.info(cfg.to_json())
    logger.info("Provenance: %s", json.dumps(provenance(cfg)))
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
            if rank0:
                print(json.dumps(printable), flush=True)
        return results
    res = trainable(cfg, checkpoint_dir=checkpoint_dir, timings=timings, device=device)
    printable = {k: v for k, v in res.items() if k in _PRINTED}
    logger.info("Final test metrics: %s", json.dumps(printable))
    if rank0:
        print(json.dumps(printable), flush=True)
    return res


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


if __name__ == "__main__":
    main()
