"""The port's own weights on disk.

An experiment directory holds the resolved `config.json` and
`best/weights.pt`: {"step": int, "model": state_dict, "fusion":
state_dict or None}. Orbax checkpoints of the JAX package are not read;
`convert.params_from_jax` carries their weights across.
"""

from __future__ import annotations

import os

import torch

from ..config import Config

WEIGHTS_FILE = "weights.pt"


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
