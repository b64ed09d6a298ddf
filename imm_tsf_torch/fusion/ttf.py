"""TTF (text-time fusion): align past notes to forecast timestamps
(after imm_tsf_tpu/fusion/ttf.py; reference fusions/TTF_RecAvg.py:8-112).

Returns (E_txt [B, T_f, d_txt], M_txt [B, 1] bool presence mask). The
note mask is derived from the embeddings as the reference does (nonzero
rows), so zero-padded notes are inert. TTF_T2V_XAttn is not ported yet.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.recavg import recavg_reference, recency_weighted_average
from ..layers.fast_dropout import Dropout


def derive_note_mask(V: torch.Tensor) -> torch.Tensor:
    """[B, N, d] -> bool [B, N]; nonzero rows are real notes
    (reference TTF_RecAvg.py:69)."""
    return V.abs().sum(dim=2) > 0


class TTF_RecAvg(nn.Module):
    """Gaussian recency-weighted note average. With `use_pallas` the
    average runs through kernels/recavg.py (the CUDA kernel on the card),
    otherwise through its plain version."""

    def __init__(self, d_txt: int, d_model_llm: int, recency_sigma: float = 1.0,
                 dropout: float = 0.1, use_pallas: bool = False, d_notes: int | None = None):
        super().__init__()
        self.use_pallas = use_pallas
        # notes arrive d_notes wide (d_txt unless given), and input_proj maps
        # them to d_txt. Its weight and bias are drawn from U(+-1/sqrt(d_model_llm)),
        # the fan-in the JAX package gives this Dense whatever the notes' width
        # (reference TTF_RecAvg.py:36-41)
        d_notes = d_txt if d_notes is None else d_notes
        self.input_proj = nn.utils.skip_init(nn.Linear, d_notes, d_txt)
        bound = 1.0 / math.sqrt(d_model_llm)
        with torch.no_grad():
            self.input_proj.weight.uniform_(-bound, bound)
            self.input_proj.bias.uniform_(-bound, bound)
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
