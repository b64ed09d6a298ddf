"""Forecasting model registry (after imm_tsf_tpu/models/__init__.py).

Every model takes the reference's single interface:

    model(tp_to_predict, observed_data, observed_tp, observed_mask) -> [B, Lp, C]

All eleven are ported: the MTS family (Informer, DLinear, PatchTST,
TimesNet, TimeMixer), the LMTS family (TimeLLM with GPT-2, TTM) and the
IMTS family (CRU, LatentODE, NeuralFlow, tPatchGNN).
"""

from __future__ import annotations

from ..config import Config


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
    if name == "LatentODE":
        from .latent_ode import LatentODE

        return LatentODE(cfg)
    if name == "NeuralFlow":
        from .neural_flow import NeuralFlow

        return NeuralFlow(cfg)
    if name == "tPatchGNN":
        from .tpatchgnn import TPatchGNN

        return TPatchGNN(cfg)
    raise ValueError(f"Unknown model: {name}")
