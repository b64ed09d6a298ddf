"""TTF (text-time fusion): align past notes to forecast timestamps
(after imm_tsf_tpu/fusion/ttf.py; reference fusions/TTF_RecAvg.py:8-112).

Two variants, as the JAX package has them:
  TTF_RecAvg    — Gaussian recency-weighted averaging (fusions/TTF_RecAvg.py:8-112)
  TTF_T2V_XAttn — Time2Vec-keyed single-query cross-attention
                  (fusions/TTF_T2V_XAttn.py:7-184)

Both return (E_txt [B, T_f, d_txt], M_txt [B, 1] bool presence mask). The
note mask is derived from the embeddings as the reference does (nonzero
rows), so zero-padded notes are inert. Both take notes `d_notes` wide
(d_txt unless given) into d_txt through `input_proj`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.recavg import recavg_reference, recency_weighted_average
from ..layers.attention import MultiHeadAttention
from ..layers.fast_dropout import Dropout


def derive_note_mask(V: torch.Tensor) -> torch.Tensor:
    """[B, N, d] -> bool [B, N]; nonzero rows are real notes
    (reference TTF_RecAvg.py:69)."""
    return V.abs().sum(dim=2) > 0


def note_projection(d_notes: int | None, d_txt: int, d_model_llm: int) -> nn.Linear:
    """input_proj: notes d_notes wide (d_txt when None) -> d_txt. Its weight
    and bias are drawn from U(+-1/sqrt(d_model_llm)), the fan-in the JAX
    package gives this Dense whatever the notes' width (reference
    TTF_RecAvg.py:36-41, TTF_T2V_XAttn.py:60-66)."""
    d_notes = d_txt if d_notes is None else d_notes
    proj = nn.utils.skip_init(nn.Linear, d_notes, d_txt)
    bound = 1.0 / math.sqrt(d_model_llm)
    with torch.no_grad():
        proj.weight.uniform_(-bound, bound)
        proj.bias.uniform_(-bound, bound)
    return proj


class TTF_RecAvg(nn.Module):
    """Gaussian recency-weighted note average. With `use_pallas` the
    average runs through kernels/recavg.py (the CUDA kernel on the card),
    otherwise through its plain version."""

    def __init__(self, d_txt: int, d_model_llm: int, recency_sigma: float = 1.0,
                 dropout: float = 0.1, use_pallas: bool = False, d_notes: int | None = None):
        super().__init__()
        self.use_pallas = use_pallas
        self.input_proj = note_projection(d_notes, d_txt, d_model_llm)
        self.log_recency_sigma = nn.Parameter(
            torch.tensor(math.log(recency_sigma), dtype=torch.float32))
        self.layer_norm = nn.LayerNorm(d_txt, eps=1e-5)
        self.dropout = Dropout(dropout)
        self.proj = nn.Linear(d_txt, d_txt)

    def forward(self, notes_emb, tau, t_hat, notes_mask=None):
        note_mask = derive_note_mask(notes_emb)
        if notes_mask is not None:
            note_mask = note_mask & (notes_mask > 0)
        V = self.input_proj(notes_emb)
        B = V.shape[0]
        if t_hat.ndim == 1:
            t_hat = t_hat[None].expand(B, -1)
        sigma = self.log_recency_sigma.exp()  # 0-d, stays on the device
        average = recency_weighted_average if self.use_pallas else recavg_reference
        E_raw = average(tau, t_hat, V, note_mask.to(V.dtype), sigma)
        E = self.dropout(self.layer_norm(E_raw))
        return self.proj(E), note_mask.any(dim=1, keepdim=True)


class Time2Vec(nn.Module):
    """[linear(t); sin(W t + b)] (reference TTF_T2V_XAttn.py:7-24):
    [..., 1] -> [..., d_tau]."""

    def __init__(self, d_tau: int):
        super().__init__()
        self.linear = nn.Linear(1, 1)
        self.periodic = nn.Linear(1, d_tau - 1)

    def forward(self, x):
        return torch.cat([self.linear(x), torch.sin(self.periodic(x))], dim=-1)


class TTF_T2V_XAttn(nn.Module):
    """One learned query attends over the notes, keyed by the notes'
    projections and the Time2Vec features of their times. The query does
    not depend on t_hat, so the JAX package computes one attention a
    sample and broadcasts it over the T_f forecast times (its
    TTF_T2V_XAttn.py:143 note); so does the port."""

    def __init__(self, d_txt: int, d_model_llm: int, n_heads_fusion: int = 1,
                 dropout: float = 0.1, d_notes: int | None = None):
        super().__init__()
        self.d_txt = d_txt
        d_tau = d_txt // 2
        self.input_proj = note_projection(d_notes, d_txt, d_model_llm)
        self.time2vec = Time2Vec(d_tau)
        self.KV_proj = nn.Linear(d_txt + d_tau, d_txt)
        self.Q_param = nn.Parameter(torch.randn(1, 1, d_txt))
        self.attn = MultiHeadAttention(d_txt, n_heads_fusion, dropout)
        self.layer_norm = nn.LayerNorm(d_txt, eps=1e-5)
        self.dropout = Dropout(dropout)
        self.proj_out = nn.Linear(d_txt, d_txt)

    def forward(self, notes_emb, tau, t_hat, notes_mask=None):
        note_mask = derive_note_mask(notes_emb)
        if notes_mask is not None:
            note_mask = note_mask & (notes_mask > 0)
        V = self.input_proj(notes_emb)
        B, d = V.shape[0], self.d_txt
        T_f = t_hat.shape[-1]
        M_txt = note_mask.any(dim=1, keepdim=True)  # [B, 1]

        KV = self.KV_proj(torch.cat([V, self.time2vec(tau[..., None].to(V.dtype))], dim=-1))
        Q = self.Q_param.expand(B, 1, d)
        attn_out = self.attn(Q, KV, KV, key_padding_mask=~note_mask)  # [B, 1, d]
        # a sample without notes gets zeros (reference :169-173)
        E_attn = torch.where(M_txt[:, :, None], attn_out, 0.0).expand(B, T_f, d)
        E = self.dropout(self.layer_norm(E_attn + self.Q_param))
        return self.proj_out(E), M_txt
