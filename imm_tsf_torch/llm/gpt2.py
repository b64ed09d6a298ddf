"""GPT-2 as the frozen note encoder (after imm_tsf_tpu/llm/gpt2.py).

Pre-LayerNorm causal transformer with learned positions and the tanh
GELU. Submodules keep the JAX package's names (`wte`, `wpe`, `h.<i>`
with `ln_1`, `c_attn`, `c_attn_proj`, `ln_2`, `c_fc`, `c_mlp_proj`, and
`ln_f`), so `convert.gpt2_params_from_jax` only renames `h_<i>` and
transposes kernels; `convert_hf_gpt2` reads a Hugging Face checkpoint.

It serves two callers: the raw-text note embedding (llm/loader.py) and
TimeLLM's frozen backbone (models/timellm.py), which reads the token
table through `get_input_embeddings` and `word_embedding_table` and
passes its gradient through the blocks to the reprogramming layer. With
`use_fused_attn` the attention goes through
kernels/attn.fused_causal_attention (the CUDA kernel for CUDA tensors,
its plain version for CPU ones; differentiable, with the plain hand
backward); otherwise through the einsum + masked_softmax path.

Weights may be stored narrower than the activations (TimeLLM's
`frozen_param_dtype="bfloat16"`): each use upcasts them to the
activations' dtype, so the arithmetic is float32 on bf16-rounded
weights, as JAX's type promotion computes it. A model cast to bfloat16
as a whole (embed_notes' `compute_dtype`) computes in bfloat16, with the
attention in float32 (kernel #3 takes float32).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attn import attention_reference, fused_causal_attention


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5


GPT2_SIZES = {
    "GPT2": GPT2Config(),
    "GPT2M": GPT2Config(n_embd=1024, n_layer=24, n_head=16),
    "GPT2L": GPT2Config(n_embd=1280, n_layer=36, n_head=20),
    "GPT2XL": GPT2Config(n_embd=1600, n_layer=48, n_head=25),
}


def upcast(w: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor | None:
    """w in the promoted dtype of w and x (a bf16 weight meets float32
    activations as float32)."""
    if w is None or w.dtype == x.dtype:
        return w
    return w.to(torch.promote_types(w.dtype, x.dtype))


def placed(t: torch.Tensor, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """t (detached) on `device`, a floating tensor in `dtype` when given:
    t itself where both already match, else a copy."""
    return t.detach().to(device, dtype if dtype is not None and t.is_floating_point()
                         else t.dtype)


def linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, upcast(lin.weight, x), upcast(lin.bias, x))


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, ln.normalized_shape, upcast(ln.weight, x), upcast(ln.bias, x),
                        ln.eps)


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config, use_fused_attn: bool = False):
        super().__init__()
        E, eps = cfg.n_embd, cfg.layer_norm_epsilon
        self.n_head = cfg.n_head
        self.use_fused_attn = use_fused_attn
        self.ln_1 = nn.LayerNorm(E, eps=eps)
        self.c_attn = nn.Linear(E, 3 * E)
        self.c_attn_proj = nn.Linear(E, E)
        self.ln_2 = nn.LayerNorm(E, eps=eps)
        self.c_fc = nn.Linear(E, 4 * E)
        self.c_mlp_proj = nn.Linear(4 * E, E)

    def forward(self, x, attn_mask=None):
        """x [B, T, E]; attn_mask [B, T], True (or > 0) = real token."""
        B, T, E = x.shape
        H = self.n_head
        q, k, v = linear(self.c_attn, layer_norm(self.ln_1, x)).split(E, dim=-1)
        q, k, v = (z.reshape(B, T, H, E // H).transpose(1, 2) for z in (q, k, v))
        pad = (attn_mask.to(torch.float32) if attn_mask is not None
               else x.new_ones((B, T), dtype=torch.float32))
        attend = fused_causal_attention if self.use_fused_attn else attention_reference
        out = attend(q.float(), k.float(), v.float(), pad).to(x.dtype)
        x = x + linear(self.c_attn_proj, out.transpose(1, 2).reshape(B, T, E))
        h = F.gelu(linear(self.c_fc, layer_norm(self.ln_2, x)), approximate="tanh")
        return x + linear(self.c_mlp_proj, h)


class GPT2Model(nn.Module):
    """`n_layers` keeps the first n blocks (the reference's encoder-layer
    truncation, fusions/load_llm.py:110-114); None keeps all."""

    def __init__(self, cfg: GPT2Config, n_layers: int | None = None,
                 use_fused_attn: bool = False):
        super().__init__()
        self.cfg = cfg
        n = n_layers if n_layers is not None else cfg.n_layer
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd)
        self.wpe = nn.Embedding(cfg.n_positions, cfg.n_embd)
        self.h = nn.ModuleList(GPT2Block(cfg, use_fused_attn) for _ in range(n))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon)

    def get_input_embeddings(self, input_ids) -> torch.Tensor:
        """The token embeddings of input_ids, in the table's dtype."""
        return self.wte(input_ids)

    def word_embedding_table(self) -> torch.Tensor:
        """The token table [vocab, n_embd]."""
        return self.wte.weight

    def forward(self, input_ids=None, inputs_embeds=None, attn_mask=None):
        if inputs_embeds is None:
            inputs_embeds = self.wte(input_ids)
        T = inputs_embeds.shape[1]
        x = inputs_embeds + self.wpe(torch.arange(T, device=inputs_embeds.device))[None]
        for block in self.h:
            x = block(x, attn_mask=attn_mask)
        return layer_norm(self.ln_f, x)


_HF_LINEARS = {"attn.c_attn": "c_attn", "attn.c_proj": "c_attn_proj",
               "mlp.c_fc": "c_fc", "mlp.c_proj": "c_mlp_proj"}


def convert_hf_gpt2(state_dict, n_layers: int | None = None) -> dict:
    """Hugging Face GPT2Model state dict (tensors or arrays) -> this
    module's state dict. HF's Conv1D keeps weights as [in, out];
    nn.Linear wants [out, in], so they are transposed."""
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    out = {k: t(state_dict[k]) for k in
           ("wte.weight", "wpe.weight", "ln_f.weight", "ln_f.bias")}
    i = 0
    while f"h.{i}.ln_1.weight" in state_dict and (n_layers is None or i < n_layers):
        for ln in ("ln_1", "ln_2"):
            for p in ("weight", "bias"):
                out[f"h.{i}.{ln}.{p}"] = t(state_dict[f"h.{i}.{ln}.{p}"])
        for hf, ours in _HF_LINEARS.items():
            out[f"h.{i}.{ours}.weight"] = t(state_dict[f"h.{i}.{hf}.weight"]).T.contiguous()
            out[f"h.{i}.{ours}.bias"] = t(state_dict[f"h.{i}.{hf}.bias"])
        i += 1
    return out
