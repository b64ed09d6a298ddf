"""Composite fusion: TTF -> MMF (after imm_tsf_tpu/fusion/fusion_model.py;
reference fusions/FusionModel.py:24-113).

forward(notes_emb, tau, t_hat, Y_ts, notes_mask) -> Y_fused, for every
pair of TTF (TTF_RecAvg, TTF_T2V_XAttn) and MMF (MMF_GR_Add,
MMF_XAttn_Add) module. The wiring is the JAX package's: recency_sigma
and use_pallas for TTF_RecAvg, n_heads_fusion for TTF_T2V_XAttn,
MMF_GR_Add's hidden_dim = C, MMF_XAttn_Add's d_attn = d_txt and kappa.
"""

from __future__ import annotations

from torch import nn

from ..config import Config
from ..llm.loader import get_d_model
from .mmf import MMF_GR_Add, MMF_XAttn_Add
from .ttf import TTF_RecAvg, TTF_T2V_XAttn


class FusionModel(nn.Module):
    """d_notes: the notes' width (d_txt when None); the JAX package takes it
    from its init batch."""

    def __init__(self, cfg: Config, d_notes: int | None = None):
        super().__init__()
        d_model_llm = get_d_model(cfg.llm_model_fusion)
        d_txt = cfg.d_txt if cfg.d_txt is not None else d_model_llm
        if cfg.TTF_module == "TTF_RecAvg":
            self.ttf = TTF_RecAvg(d_txt=d_txt, d_model_llm=d_model_llm,
                                  recency_sigma=cfg.recency_sigma, dropout=cfg.dropout,
                                  use_pallas=cfg.use_pallas, d_notes=d_notes)
        elif cfg.TTF_module == "TTF_T2V_XAttn":
            self.ttf = TTF_T2V_XAttn(d_txt=d_txt, d_model_llm=d_model_llm,
                                     n_heads_fusion=cfg.n_heads_fusion, dropout=cfg.dropout,
                                     d_notes=d_notes)
        else:
            raise KeyError(f"Unknown fusion module: {cfg.TTF_module}")
        if cfg.MMF_module == "MMF_GR_Add":
            self.mmf = MMF_GR_Add(d_txt=d_txt, C=cfg.input_dim, hidden_dim=cfg.input_dim,
                                  dropout=cfg.dropout)
        elif cfg.MMF_module == "MMF_XAttn_Add":
            self.mmf = MMF_XAttn_Add(d_txt=d_txt, C=cfg.input_dim, d_attn=d_txt,
                                     n_heads_fusion=cfg.n_heads_fusion, dropout=cfg.dropout,
                                     kappa=cfg.kappa)
        else:
            raise KeyError(f"Unknown fusion module: {cfg.MMF_module}")

    def forward(self, notes_emb, tau, t_hat, Y_ts, notes_mask=None):
        E_txt, M_txt = self.ttf(notes_emb, tau, t_hat, notes_mask)
        return self.mmf(Y_ts, E_txt, M_txt)
