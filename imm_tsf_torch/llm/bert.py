"""BERT as a frozen note encoder and TimeLLM backbone (after
imm_tsf_tpu/llm/bert.py; reference fusions/load_llm.py:10).

Post-LayerNorm bidirectional encoder (eps 1e-12) with learned positions,
token type 0 everywhere, and the exact (erf) GELU. Keys are masked with
the safe `layers.attention.masked_softmax`: a fully padded row attends to
nothing and gives zeros, not NaN. Submodules keep the flax names (`q`,
`k`, `v`, `attn_out`, `attn_ln`, `inter`, `out`, `out_ln`, `emb_ln`;
`layer_<i>` nests as `layers.<i>`), so `convert.bert_params_from_jax`
only renames and transposes; `convert_hf_bert` reads a Hugging Face
checkpoint, whose Linear weights are already [out, in].

Stored weights upcast at each use to the activations' dtype (as
llm/gpt2.py does), so TimeLLM's `frozen_param_dtype="bfloat16"` computes
in float32 on the rounded weights; a model cast to bfloat16 as a whole
(embed_notes' `compute_dtype`) computes in bfloat16, with the attention
scores and softmax in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..layers.attention import masked_softmax
from .gpt2 import layer_norm, linear


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_position_embeddings: int = 512
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


def attend(q, k, v, mask) -> torch.Tensor:
    """softmax(q kᵀ / √Dh) v over [B, H, T, Dh], the scores and the
    softmax in float32 (the JAX einsum's preferred_element_type), masked
    where `mask` (broadcast to [B, H, Tq, Tk]) is False; returns q's dtype."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.matmul(masked_softmax(scores, mask), v.float()).to(q.dtype)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        E, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.n_head = cfg.num_attention_heads
        self.q, self.k, self.v, self.attn_out = (nn.Linear(E, E) for _ in range(4))
        self.attn_ln = nn.LayerNorm(E, eps=eps)
        self.inter = nn.Linear(E, cfg.intermediate_size)
        self.out = nn.Linear(cfg.intermediate_size, E)
        self.out_ln = nn.LayerNorm(E, eps=eps)

    def forward(self, x, attn_mask=None):
        """x [B, T, E]; attn_mask [B, T], True (or > 0) = real token."""
        B, T, E = x.shape
        H = self.n_head
        split = lambda z: z.reshape(B, T, H, E // H).transpose(1, 2)
        q, k, v = (split(linear(lin, x)) for lin in (self.q, self.k, self.v))
        mask = attn_mask.bool()[:, None, None, :] if attn_mask is not None else None
        out = attend(q, k, v, mask).transpose(1, 2).reshape(B, T, E)
        x = layer_norm(self.attn_ln, x + linear(self.attn_out, out))
        h = F.gelu(linear(self.inter, x), approximate="none")
        return layer_norm(self.out_ln, x + linear(self.out, h))


class BertModel(nn.Module):
    """`n_layers` keeps the first n layers (the reference's encoder-layer
    truncation, fusions/load_llm.py:110-114); None keeps all."""

    def __init__(self, cfg: BertConfig, n_layers: int | None = None):
        super().__init__()
        self.cfg = cfg
        E = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, E)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, E)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, E)
        self.emb_ln = nn.LayerNorm(E, eps=cfg.layer_norm_eps)
        n = n_layers if n_layers is not None else cfg.num_hidden_layers
        self.layers = nn.ModuleList(BertLayer(cfg) for _ in range(n))

    def get_input_embeddings(self, input_ids) -> torch.Tensor:
        """The token embeddings of input_ids, in the table's dtype."""
        return self.word_embeddings(input_ids)

    def word_embedding_table(self) -> torch.Tensor:
        """The token table [vocab, hidden]."""
        return self.word_embeddings.weight

    def forward(self, input_ids=None, inputs_embeds=None, attn_mask=None):
        if inputs_embeds is None:
            inputs_embeds = self.word_embeddings(input_ids)
        T = inputs_embeds.shape[1]
        dev = inputs_embeds.device
        pos = self.position_embeddings(torch.arange(T, device=dev))[None]
        tok = self.token_type_embeddings(torch.zeros(T, dtype=torch.long, device=dev))[None]
        x = layer_norm(self.emb_ln, inputs_embeds + pos + tok)
        for layer in self.layers:
            x = layer(x, attn_mask=attn_mask)
        return x


_HF_BERT = {"attention.self.query": "q", "attention.self.key": "k",
            "attention.self.value": "v", "attention.output.dense": "attn_out",
            "attention.output.LayerNorm": "attn_ln", "intermediate.dense": "inter",
            "output.dense": "out", "output.LayerNorm": "out_ln"}


def convert_hf_bert(state_dict, n_layers: int | None = None) -> dict:
    """Hugging Face BertModel state dict (tensors or arrays, prefix
    stripped) -> this module's state dict. Both sides keep Linear weights
    [out, in], so only the names change; the pooler is not used."""
    t = lambda k: torch.as_tensor(state_dict[k], dtype=torch.float32)
    out = {f"{name}.weight": t(f"embeddings.{name}.weight")
           for name in ("word_embeddings", "position_embeddings", "token_type_embeddings")}
    out["emb_ln.weight"] = t("embeddings.LayerNorm.weight")
    out["emb_ln.bias"] = t("embeddings.LayerNorm.bias")
    i = 0
    while f"encoder.layer.{i}.attention.self.query.weight" in state_dict and (
            n_layers is None or i < n_layers):
        for hf, ours in _HF_BERT.items():
            for p in ("weight", "bias"):
                out[f"layers.{i}.{ours}.{p}"] = t(f"encoder.layer.{i}.{hf}.{p}")
        i += 1
    return out
