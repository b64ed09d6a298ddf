"""Composite fusion: TTF -> MMF (after imm_tsf_tpu/fusion/fusion_model.py;
reference fusions/FusionModel.py:24-113).

forward(notes_emb, tau, t_hat, Y_ts, notes_mask) -> Y_fused. Only the
TTF_RecAvg / MMF_GR_Add pair is ported so far.
"""

from __future__ import annotations

from torch import nn

from ..config import MMF_MODULES, TTF_MODULES, Config
from ..llm.loader import get_d_model
from .mmf import MMF_GR_Add
from .ttf import TTF_RecAvg


def _check_ported(name: str, known: tuple, ported: str) -> None:
    if name == ported:
        return
    if name in known:
        raise NotImplementedError(
            f"fusion module {name!r} is not ported to imm_tsf_torch yet "
            "(see ROADMAP.md, Queue 1)")
    raise KeyError(f"Unknown fusion module: {name}")


class FusionModel(nn.Module):
    """d_notes: the notes' width (d_txt when None); the JAX package takes it
    from its init batch."""

    def __init__(self, cfg: Config, d_notes: int | None = None):
        super().__init__()
        _check_ported(cfg.TTF_module, TTF_MODULES, "TTF_RecAvg")
        _check_ported(cfg.MMF_module, MMF_MODULES, "MMF_GR_Add")
        d_model_llm = get_d_model(cfg.llm_model_fusion)
        d_txt = cfg.d_txt if cfg.d_txt is not None else d_model_llm
        self.ttf = TTF_RecAvg(d_txt=d_txt, d_model_llm=d_model_llm,
                              recency_sigma=cfg.recency_sigma,
                              dropout=cfg.dropout, use_pallas=cfg.use_pallas,
                              d_notes=d_notes)
        self.mmf = MMF_GR_Add(d_txt=d_txt, C=cfg.input_dim,
                              hidden_dim=cfg.input_dim, dropout=cfg.dropout)

    def forward(self, notes_emb, tau, t_hat, Y_ts, notes_mask=None):
        E_txt, M_txt = self.ttf(notes_emb, tau, t_hat, notes_mask)
        return self.mmf(Y_ts, E_txt, M_txt)
