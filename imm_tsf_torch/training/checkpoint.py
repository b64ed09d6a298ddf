"""The port's own checkpoints on disk.

An experiment directory holds the resolved `config.json`,
`best/weights.pt`: {"step": int, "model": state_dict, "fusion":
state_dict or None}, and the full training state of the latest two
epochs, `train_state_<epoch>.pt` (save_train_state), from which
`--load <id>` resumes a run (after imm_tsf_tpu/training/checkpoint.py:
57-98, which keeps two with orbax's max_to_keep=2). Orbax checkpoints of
the JAX package are not read; `convert.params_from_jax` carries their
weights across.
"""

from __future__ import annotations

import os
import re

import torch

from ..config import Config

WEIGHTS_FILE = "weights.pt"
TRAIN_STATES_KEPT = 2
_TRAIN_STATE = re.compile(r"train_state_(\d+)\.pt")


def save_weights(directory: str, model_state: dict, fusion_state: dict | None,
                 step: int = 0) -> None:
    os.makedirs(directory, exist_ok=True)
    torch.save({"step": int(step), "model": model_state, "fusion": fusion_state},
               os.path.join(directory, WEIGHTS_FILE))


def load_weights(directory: str, map_location="cpu") -> dict:
    """{"step", "model", "fusion"} saved by save_weights."""
    path = os.path.join(directory, WEIGHTS_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"No weights in {directory}")
    return torch.load(path, map_location=map_location, weights_only=True)


def save_experiment(exp_dir: str, cfg: Config, model_state: dict,
                    fusion_state: dict | None, step: int = 0) -> None:
    """Write `config.json` and `best/weights.pt`: what ForecastService and
    `python -m imm_tsf_torch.serve --load <exp_dir>` restore."""
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    save_weights(os.path.join(exp_dir, "best"), model_state, fusion_state, step)


def _train_state_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_TRAIN_STATE.fullmatch, os.listdir(directory))
                  if m)


def save_train_state(directory: str, model_state: dict, fusion_state: dict | None,
                     optimizer_state: dict, meta: dict, step: int) -> None:
    """Write the full training state of epoch `step` as
    `<directory>/train_state_<step>.pt` and delete all but the latest
    TRAIN_STATES_KEPT. `meta` holds plain Python values and tensors only
    (the counters, the history, the shuffle state and the states of the
    trainer's generators: the hash-dropout salts, ProbSparse's samples and
    the latent models' z0 noise), so load_train_state reads it back with
    weights_only=True."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"train_state_{int(step)}.pt")
    # through a temporary file: a run killed mid-write leaves the older states whole
    torch.save({"step": int(step), "model": model_state, "fusion": fusion_state,
                "optimizer": optimizer_state, "meta": meta}, path + ".tmp")
    os.replace(path + ".tmp", path)
    for old in _train_state_steps(directory)[:-TRAIN_STATES_KEPT]:
        os.remove(os.path.join(directory, f"train_state_{old}.pt"))


def load_train_state(directory: str) -> tuple[dict, dict | None, dict, dict, int]:
    """The latest state save_train_state wrote: (model_state, fusion_state,
    optimizer_state, meta, step), tensors on the CPU. Raises
    FileNotFoundError when the directory holds none."""
    steps = _train_state_steps(directory)
    if not steps:
        raise FileNotFoundError(f"No train state in {directory}")
    state = torch.load(os.path.join(directory, f"train_state_{steps[-1]}.pt"),
                       map_location="cpu", weights_only=True)
    return state["model"], state["fusion"], state["optimizer"], state["meta"], state["step"]
