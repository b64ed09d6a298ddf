"""The Llama family as a frozen note encoder and TimeLLM backbone (after
imm_tsf_tpu/llm/llama.py): Llama-3.1-8B and DeepSeek-7B (reference
fusions/load_llm.py:11-12).

Pre-RMSNorm causal decoder with rotary positions (the "rotate_half"
convention: the head dim split into two halves), grouped-query attention,
a SwiGLU MLP and no biases. Submodules keep the flax names
(`embed_tokens`, `input_norm`, `q_proj` ... `down_proj`, `post_norm`,
`final_norm`; `layer_<i>` nests as `layers.<i>`, an RMSNorm's `scale` is
its `weight`), so `convert.llama_params_from_jax` only renames and
transposes; `convert_hf_llama` reads a Hugging Face checkpoint.

The JAX package annotates the projections with tensor-parallel partition
hints; only their initializer, normal(0.02), carries over here (the
loader's `_llama_init_`). At full depth Llama-3.1-8B without its LM head
(which no caller reads) is 7.50 B parameters, 30.0 GB in float32, so it
fits one 80 GB card.

Like the JAX `_rope`, the rotary angles are float32 with no Llama-3.1
`rope_scaling` ("llama3"): an inherited departure from upstream Hugging
Face (ROADMAP.md, Queue 3), kept so the port computes what the JAX
package computes.

Stored weights upcast at each use to the activations' dtype (as
llm/gpt2.py does), so TimeLLM's `frozen_param_dtype="bfloat16"` computes
in float32 on the rounded weights; a model cast to bfloat16 as a whole
(embed_notes' `compute_dtype`) computes in bfloat16, with the RMSNorm
statistics, the rotary product, the attention scores and the softmax in
float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .bert import attend
from .gpt2 import linear, upcast


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192


LLAMA_SIZES = {
    "Llama": LlamaConfig(),  # Llama-3.1-8B
    "DeepSeek": LlamaConfig(
        vocab_size=102400, hidden_size=4096, intermediate_size=11008,
        num_hidden_layers=30, num_attention_heads=32, num_key_value_heads=32,
        rope_theta=10000.0, rms_norm_eps=1e-6,
    ),  # deepseek-llm-7b-base (Llama architecture)
}


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, H, T, Dh] rotated by its positions [T]. The angles are the
    JAX package's float32 ones, 1 / θ^(arange(0, Dh, 2) / Dh) times the
    positions (angles taken in float64 and then rounded differ by up to
    7e-5 at positions near 1024); the product is in float32 at least."""
    Dh = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, Dh, 2, dtype=torch.float32, device=x.device) / Dh))
    angles = positions[:, None].float() * freqs[None]  # [T, Dh/2]
    emb = torch.cat([angles, angles], dim=-1)
    x1, x2 = x.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    return x * emb.cos() + rotated * emb.sin()


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        """(x / √(mean(x²) + eps)) in x's dtype, times the scale; the mean
        in float32."""
        var = x.float().pow(2).mean(-1, keepdim=True)
        return (x * (1.0 / torch.sqrt(var + self.eps))).to(x.dtype) * upcast(self.weight, x)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        E, I = cfg.hidden_size, cfg.intermediate_size
        H, KV = cfg.num_attention_heads, cfg.num_key_value_heads
        self.cfg = cfg
        Dh = E // H
        self.input_norm = RMSNorm(E, cfg.rms_norm_eps)
        self.q_proj = nn.Linear(E, H * Dh, bias=False)
        self.k_proj = nn.Linear(E, KV * Dh, bias=False)
        self.v_proj = nn.Linear(E, KV * Dh, bias=False)
        self.o_proj = nn.Linear(H * Dh, E, bias=False)
        self.post_norm = RMSNorm(E, cfg.rms_norm_eps)
        self.gate_proj = nn.Linear(E, I, bias=False)
        self.up_proj = nn.Linear(E, I, bias=False)
        self.down_proj = nn.Linear(I, E, bias=False)

    def forward(self, x, attn_mask=None):
        """x [B, T, E]; attn_mask [B, T], True (or > 0) = real token; the
        keys are masked causally and by attn_mask."""
        c = self.cfg
        H, KV = c.num_attention_heads, c.num_key_value_heads
        B, T, E = x.shape
        Dh = E // H
        h = self.input_norm(x)
        q = linear(self.q_proj, h).reshape(B, T, H, Dh).transpose(1, 2)
        k = linear(self.k_proj, h).reshape(B, T, KV, Dh).transpose(1, 2)
        v = linear(self.v_proj, h).reshape(B, T, KV, Dh).transpose(1, 2)
        pos = torch.arange(T, device=x.device)
        q, k = _rope(q, pos, c.rope_theta), _rope(k, pos, c.rope_theta)
        if KV != H:  # grouped-query: each kv head repeated in place (jnp.repeat)
            k = k.repeat_interleave(H // KV, dim=1)
            v = v.repeat_interleave(H // KV, dim=1)
        mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()[None, None]
        if attn_mask is not None:
            mask = mask & attn_mask.bool()[:, None, None, :]
        out = attend(q, k, v, mask).to(x.dtype).transpose(1, 2).reshape(B, T, H * Dh)
        x = x + linear(self.o_proj, out)
        h = self.post_norm(x)
        act = F.silu(linear(self.gate_proj, h)) * linear(self.up_proj, h)
        return x + linear(self.down_proj, act)


class LlamaModel(nn.Module):
    """`n_layers` keeps the first n blocks (the reference's encoder-layer
    truncation, fusions/load_llm.py:110-114); None keeps all."""

    def __init__(self, cfg: LlamaConfig, n_layers: int | None = None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        n = n_layers if n_layers is not None else cfg.num_hidden_layers
        self.layers = nn.ModuleList(LlamaBlock(cfg) for _ in range(n))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def get_input_embeddings(self, input_ids) -> torch.Tensor:
        """The token embeddings of input_ids, in the table's dtype."""
        return self.embed_tokens(input_ids)

    def word_embedding_table(self) -> torch.Tensor:
        """The token table [vocab, hidden]."""
        return self.embed_tokens.weight

    def forward(self, input_ids=None, inputs_embeds=None, attn_mask=None):
        x = self.embed_tokens(input_ids) if inputs_embeds is None else inputs_embeds
        for layer in self.layers:
            x = layer(x, attn_mask=attn_mask)
        return self.final_norm(x)


_HF_LLAMA = {"input_layernorm": "input_norm", "post_attention_layernorm": "post_norm",
             "self_attn.q_proj": "q_proj", "self_attn.k_proj": "k_proj",
             "self_attn.v_proj": "v_proj", "self_attn.o_proj": "o_proj",
             "mlp.gate_proj": "gate_proj", "mlp.up_proj": "up_proj",
             "mlp.down_proj": "down_proj"}


def convert_hf_llama(state_dict, n_layers: int | None = None) -> dict:
    """Hugging Face LlamaModel state dict (tensors or arrays, the "model."
    prefix stripped) -> this module's state dict. Both sides keep Linear
    weights [out, in], so only the names change."""
    t = lambda k: torch.as_tensor(state_dict[k], dtype=torch.float32)
    out = {"embed_tokens.weight": t("embed_tokens.weight"), "final_norm.weight": t("norm.weight")}
    i = 0
    while f"layers.{i}.self_attn.q_proj.weight" in state_dict and (
            n_layers is None or i < n_layers):
        for hf, ours in _HF_LLAMA.items():
            out[f"layers.{i}.{ours}.weight"] = t(f"layers.{i}.{hf}.weight")
        i += 1
    return out
