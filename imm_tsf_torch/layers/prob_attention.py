"""ProbSparse attention (Informer), after imm_tsf_tpu/layers/prob_attention.py
(reference layers/SelfAttention_Family.py:80-178).

The sample counts U_part = min(factor*ceil(ln L_K), L_K) and
u = min(factor*ceil(ln L_Q), L_Q) depend only on the lengths: sampled
scores -> sparsity measure M -> top-u queries -> dense scores for those
queries -> scattered into the mean (or causal cumsum) context.

The key sample: in eval the JAX package draws it with
`jax.random.randint(PRNGKey(0), (L_Q, U_part), 0, L_K)`, and served
answers depend on it, so the port computes the same integers with its
NumPy threefry (layers/jax_prng.py), once per (L_Q, U_part, L_K, device).
In train mode JAX draws from its dropout stream, which no other framework
reproduces; the port draws from the module's `generator` (a torch
generator on the inputs' device, which the trainer sets; torch's default
generator when unset).

Only the set of the top-u queries matters (the scatter reads the set), so
torch.topk's order need not be lax.top_k's; a tie at the u-th place could
pick another query.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from . import jax_prng
from .attention import masked_softmax
from .fast_dropout import Dropout

_EVAL_SAMPLES: dict = {}  # (L_Q, U_part, L_K, device) -> int64 [L_Q, U_part]


def eval_sample(L_Q: int, U_part: int, L_K: int, device) -> torch.Tensor:
    """jax.random.randint(PRNGKey(0), (L_Q, U_part), 0, L_K), bit for bit,
    as an int64 tensor on `device`."""
    key = (L_Q, U_part, L_K, torch.device(device))
    if key not in _EVAL_SAMPLES:
        idx = jax_prng.randint(jax_prng.prng_key(0), (L_Q, U_part), 0, L_K)
        with torch.inference_mode(False):
            _EVAL_SAMPLES[key] = torch.from_numpy(idx.astype("int64")).to(device)
    return _EVAL_SAMPLES[key]


def train_sample(L_Q: int, U_part: int, L_K: int, device,
                 generator: torch.Generator | None) -> torch.Tensor:
    """A fresh uniform key sample [L_Q, U_part] in [0, L_K), drawn on `device`."""
    return torch.randint(0, L_K, (L_Q, U_part), device=device, generator=generator)


class ProbAttention(nn.Module):
    """ref_layout: the reference returns the context as [B, H, L, D]
    without transposing back (SelfAttention_Family.py:177), and
    AttentionLayer then views that H-major memory as [B, L, H*D] (:201),
    scrambling (head, position) pairs into the time axis. That upstream
    bug is the parity spec: ref_layout=True (the default) reproduces it by
    reshaping the untransposed tensor; False gives the per-position
    layout."""

    def __init__(self, mask_flag: bool = True, factor: int = 5, scale: float | None = None,
                 attention_dropout: float = 0.1, ref_layout: bool = True):
        super().__init__()
        self.mask_flag, self.factor, self.scale = mask_flag, factor, scale
        self.ref_layout = ref_layout
        self.dropout = Dropout(attention_dropout)
        self.generator: torch.Generator | None = None  # train-mode sample source

    def forward(self, queries, keys, values, attn_mask=None):
        # inputs [B, L, H, D] (AttentionLayer layout); attn_mask is unused,
        # as in the reference
        B, L_Q, H, D = queries.shape
        L_K = keys.shape[1]
        Q, K, V = (t.permute(0, 2, 1, 3) for t in (queries, keys, values))  # [B, H, L, D]

        U_part = min(self.factor * math.ceil(math.log(max(L_K, 2))), L_K)
        u = min(self.factor * math.ceil(math.log(max(L_Q, 2))), L_Q)
        if self.training:
            index_sample = train_sample(L_Q, U_part, L_K, Q.device, self.generator)
        else:
            index_sample = eval_sample(L_Q, U_part, L_K, Q.device)

        # sampled Q K^T for the sparsity measure (reference :90-103); the
        # sum is divided by L_K, not U_part, as the reference does
        K_sample = K[:, :, index_sample]  # [B, H, L_Q, U_part, D]
        Q_K_sample = torch.einsum("bhld,bhlud->bhlu", Q, K_sample)
        M = Q_K_sample.amax(dim=-1) - Q_K_sample.sum(dim=-1) / L_K  # [B, H, L_Q]
        M_top = M.topk(u, dim=-1).indices  # [B, H, u]

        Q_reduce = torch.gather(Q, 2, M_top[..., None].expand(-1, -1, -1, D))
        scale = self.scale or 1.0 / math.sqrt(D)
        scores_top = torch.einsum("bhud,bhkd->bhuk", Q_reduce, K) * scale

        if self.mask_flag:
            # causal: the selected query at position p attends keys <= p
            key_idx = torch.arange(L_K, device=Q.device)
            attn = masked_softmax(scores_top, key_idx <= M_top[..., None])
            context = torch.cumsum(V, dim=2)  # reference :125 (L_Q == L_V)
        else:
            attn = torch.softmax(scores_top, dim=-1)
            context = V.mean(dim=2, keepdim=True).expand(B, H, L_Q, D)

        update = torch.einsum("bhuk,bhkd->bhud", self.dropout(attn), V)
        # the u updated rows replace theirs in the context (reference :136-138)
        context = torch.scatter(context, 2, M_top[..., None].expand(-1, -1, -1, D), update)
        if self.ref_layout:
            # the [B, H, L, D] memory read as [B, L, H, D]: reshape, never transpose
            return context.reshape(B, L_Q, H, D)
        return context.permute(0, 2, 1, 3)
