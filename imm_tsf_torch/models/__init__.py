"""Forecasting model registry (after imm_tsf_tpu/models/__init__.py).

Every model takes the reference's single interface:

    model(tp_to_predict, observed_data, observed_tp, observed_mask) -> [B, Lp, C]

PatchTST and CRU are ported so far; the other backbones are queued in
ROADMAP.md.
"""

from __future__ import annotations

from ..config import MODELS, Config


def get_model(cfg: Config):
    name = cfg.model
    if name == "PatchTST":
        from .patchtst import PatchTST

        return PatchTST(cfg)
    if name == "CRU":
        from .cru import CRU

        return CRU(cfg)
    if name in MODELS:
        raise NotImplementedError(
            f"model {name!r} is not ported to imm_tsf_torch yet "
            "(see ROADMAP.md, Queue 1)")
    raise ValueError(f"Unknown model: {name}")
