"""Attention primitives (after imm_tsf_tpu/layers/attention.py).

All masking is "safe": a fully masked row yields zeros instead of NaN.
"""

from __future__ import annotations

import torch


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor | None,
                   dim: int = -1) -> torch.Tensor:
    """Softmax over `dim` where mask==True positions participate.

    Fully-masked rows return all-zeros (safe), not NaN."""
    if mask is None:
        return torch.softmax(scores, dim=dim)
    neg = torch.finfo(scores.dtype).min
    scores = torch.where(mask, scores, neg)
    m = scores.amax(dim=dim, keepdim=True)
    e = torch.exp(scores - m) * mask.to(scores.dtype)
    denom = e.sum(dim=dim, keepdim=True)
    return e / torch.where(denom == 0, 1.0, denom)
