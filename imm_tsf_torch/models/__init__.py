"""Forecasting model registry (after imm_tsf_tpu/models/__init__.py).

Every model takes the reference's single interface:

    model(tp_to_predict, observed_data, observed_tp, observed_mask) -> [B, Lp, C]

Eight of the eleven are ported: PatchTST, CRU, DLinear, Informer,
TimesNet, TimeMixer, TimeLLM (with GPT-2) and TTM, the whole MTS and LMTS
families. The IMTS backbones are queued in ROADMAP.md, Queue 1, item 8.
"""

from __future__ import annotations

from ..config import MODELS, Config

# the ROADMAP.md Queue 1 item of each backbone still to port
_QUEUED = {"tPatchGNN": 8, "LatentODE": 8, "NeuralFlow": 8}


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
    if name == "TimesNet":
        from .timesnet import TimesNet

        return TimesNet(cfg)
    if name == "TimeMixer":
        from .timemixer import TimeMixer

        return TimeMixer(cfg)
    if name == "TTM":
        from .ttm import TTM

        return TTM(cfg)
    if name in _QUEUED:
        raise NotImplementedError(
            f"model {name!r} is not ported to imm_tsf_torch yet "
            f"(ROADMAP.md, Queue 1, item {_QUEUED[name]})")
    raise ValueError(f"Unknown model: {name}")
