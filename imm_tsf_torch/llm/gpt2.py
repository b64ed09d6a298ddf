"""GPT-2 as the frozen note encoder (after imm_tsf_tpu/llm/gpt2.py).

Pre-LayerNorm causal transformer with learned positions and the tanh
GELU. Submodules keep the JAX package's names (`wte`, `wpe`, `h.<i>`
with `ln_1`, `c_attn`, `c_attn_proj`, `ln_2`, `c_fc`, `c_mlp_proj`, and
`ln_f`), so `convert.gpt2_params_from_jax` only renames `h_<i>` and
transposes kernels; `convert_hf_gpt2` reads a Hugging Face checkpoint.

With `use_fused_attn` the attention goes through
kernels/attn.fused_causal_attention (the CUDA kernel for CUDA tensors,
its plain version for CPU ones); otherwise through the einsum +
masked_softmax path.
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
        q, k, v = self.c_attn(self.ln_1(x)).split(E, dim=-1)
        q, k, v = (z.reshape(B, T, H, E // H).transpose(1, 2) for z in (q, k, v))
        pad = (attn_mask.to(torch.float32) if attn_mask is not None
               else x.new_ones((B, T), dtype=torch.float32))
        attend = fused_causal_attention if self.use_fused_attn else attention_reference
        out = attend(q, k, v, pad)
        x = x + self.c_attn_proj(out.transpose(1, 2).reshape(B, T, E))
        h = F.gelu(self.c_fc(self.ln_2(x)), approximate="tanh")
        return x + self.c_mlp_proj(h)


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

    def forward(self, input_ids=None, inputs_embeds=None, attn_mask=None):
        if inputs_embeds is None:
            inputs_embeds = self.wte(input_ids)
        T = inputs_embeds.shape[1]
        x = inputs_embeds + self.wpe(torch.arange(T, device=inputs_embeds.device))[None]
        for block in self.h:
            x = block(x, attn_mask=attn_mask)
        return self.ln_f(x)


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
