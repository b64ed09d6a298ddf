"""Forecasting model registry (after imm_tsf_tpu/models/__init__.py).

Every model takes the reference's single interface:

    model(tp_to_predict, observed_data, observed_tp, observed_mask) -> [B, Lp, C]

PatchTST, CRU, DLinear, Informer and TimeLLM (with GPT-2) are ported
so far; the other backbones are queued in ROADMAP.md, Queue 1.
"""

from __future__ import annotations

from ..config import MODELS, Config

# the ROADMAP.md Queue 1 item of each backbone still to port (TimesNet and
# TimeMixer: item 7)
_QUEUED = {"tPatchGNN": 8, "LatentODE": 8, "NeuralFlow": 8, "TTM": 11}


def get_model(cfg: Config):
    name = cfg.model
    if name == "DLinear":
        from .dlinear import DLinear

        return DLinear(cfg)
    if name == "Informer":
        from .informer import Informer

        return Informer(cfg)
    if name == "PatchTST":
        from .patchtst import PatchTST

        return PatchTST(cfg)
    if name == "CRU":
        from .cru import CRU

        return CRU(cfg)
    if name == "TimeLLM":
        from .timellm import TimeLLM

        return TimeLLM(cfg)
    if name in MODELS:
        raise NotImplementedError(
            f"model {name!r} is not ported to imm_tsf_torch yet "
            f"(ROADMAP.md, Queue 1, item {_QUEUED.get(name, 7)})")
    raise ValueError(f"Unknown model: {name}")
