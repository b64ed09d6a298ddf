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
specs: the output columns of q, k, v, gate and up (`(None, "model")`) and
the input rows of o and down (`("model", None)`) split over the "model"
axis. `LlamaShards` lays a model out so over the devices of one data group
of the loader's LLM mesh (llm/loader.shard_llm_params): shard s holds its
1/tp of each split projection (heads, KV heads and intermediate units) on
its device, and each block sums the shards' partial outputs after o and
after down on the group's first device, in shard order, so that two runs
agree bit for bit. The initializer, normal(0.02), is the loader's
`_llama_init_`. At full depth Llama-3.1-8B without its LM head (which no
caller reads) is 7.50 B parameters, 30.0 GB in float32, so it fits one
80 GB card.

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
from .gpt2 import placed, upcast


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


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """(x / √(mean(x²) + eps)) in x's dtype, times the scale; the mean in
    float32."""
    var = x.float().pow(2).mean(-1, keepdim=True)
    return (x * (1.0 / torch.sqrt(var + eps))).to(x.dtype) * upcast(weight, x)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


_SPLIT = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")  # output rows of [out, in]
_SPLIT_IN = ("o_proj", "down_proj")  # input columns


def check_tp(cfg: LlamaConfig, tp: int) -> None:
    """Refuse a tensor-parallel width that does not divide the heads, the
    KV heads and the intermediate units of `cfg`."""
    sizes = {"heads": cfg.num_attention_heads, "KV heads": cfg.num_key_value_heads,
             "intermediate units": cfg.intermediate_size}
    bad = {k: v for k, v in sizes.items() if v % tp}
    if bad:
        raise ValueError(f"llm_tp={tp} does not divide the model's "
                         + ", ".join(f"{v} {k}" for k, v in bad.items())
                         + " (a tensor-parallel width must divide its "
                         + ", ".join(f"{v} {k}" for k, v in sizes.items()) + ")")


def _row_product(a: torch.Tensor, w: torch.Tensor, partial: bool) -> torch.Tensor:
    """a @ wᵀ: a shard's term of a row-split product (`partial`) of bf16
    operands comes out in float32 (one cuBLAS GEMM with float32 output on
    CUDA), so the terms' sum is rounded to bf16 once, as the whole
    product's is; otherwise F.linear in the activations' dtype."""
    if partial and a.dtype == w.dtype == torch.bfloat16:
        from ..layers.bf16_products import _mm_f32

        return _mm_f32(a, w.t())
    return F.linear(a, upcast(w, a))


def _attention(c: LlamaConfig, h, attn_mask, w: dict, H: int, KV: int,
               partial: bool = False) -> torch.Tensor:
    """o_proj of the attention of heads H over KV heads (a shard's, or all)
    of the projections in `w`: [B, T, E], this shard's term of the sum."""
    B, T, _ = h.shape
    Dh = c.hidden_size // c.num_attention_heads
    proj = lambda name: F.linear(h, upcast(w[name], h))
    q = proj("q_proj").reshape(B, T, H, Dh).transpose(1, 2)
    k = proj("k_proj").reshape(B, T, KV, Dh).transpose(1, 2)
    v = proj("v_proj").reshape(B, T, KV, Dh).transpose(1, 2)
    pos = torch.arange(T, device=h.device)
    q, k = _rope(q, pos, c.rope_theta), _rope(k, pos, c.rope_theta)
    if KV != H:  # grouped-query: each kv head repeated in place (jnp.repeat)
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
    mask = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()[None, None]
    if attn_mask is not None:
        mask = mask & attn_mask.bool()[:, None, None, :]
    out = attend(q, k, v, mask).to(h.dtype).transpose(1, 2).reshape(B, T, H * Dh)
    return _row_product(out, w["o_proj"], partial)


def _mlp(h, w: dict, partial: bool = False) -> torch.Tensor:
    """down_proj of the SwiGLU of the intermediate units in `w`."""
    act = F.silu(F.linear(h, upcast(w["gate_proj"], h))) * F.linear(h, upcast(w["up_proj"], h))
    return _row_product(act, w["down_proj"], partial)


def _sum_shards(parts: list, x: torch.Tensor) -> torch.Tensor:
    """The shards' terms summed on x's device in shard order, in float32 at
    least, then in x's dtype; one term is returned as it is."""
    if len(parts) == 1:
        return parts[0].to(x.device)
    acc = torch.promote_types(x.dtype, torch.float32)
    out = parts[0].to(x.device, acc)
    for p in parts[1:]:
        out = out + p.to(x.device, acc)
    return out.to(x.dtype)


def block_forward(c: LlamaConfig, x, attn_mask, input_norm, post_norm, shards: list):
    """One Llama block over `shards` (dicts of the projections' weights, on
    their "device"; one shard holding them whole is the plain block): the
    norms run on x's device, each shard's attention and MLP on its own,
    their terms summed on x's device in shard order."""
    tp = len(shards)
    H, KV, partial = c.num_attention_heads // tp, c.num_key_value_heads // tp, tp > 1
    h = rms_norm(x, input_norm, c.rms_norm_eps)
    x = x + _sum_shards([_attention(c, h.to(s["device"]), None if attn_mask is None
                                    else attn_mask.to(s["device"]), s, H, KV, partial)
                         for s in shards], x)
    h = rms_norm(x, post_norm, c.rms_norm_eps)
    return x + _sum_shards([_mlp(h.to(s["device"]), s, partial) for s in shards], x)


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
        whole = {n: getattr(self, n).weight for n in _SPLIT + _SPLIT_IN}
        return block_forward(self.cfg, x, attn_mask, self.input_norm.weight,
                             self.post_norm.weight, [dict(whole, device=x.device)])


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


class LlamaShards:
    """A LlamaModel laid out over the devices of one data group, `devices`
    [d_0 .. d_tp-1] (the loader's LLM mesh): shard s holds, on d_s, rows s
    of the output-split projections (q, k, v: its H / tp heads and KV / tp
    KV heads; gate, up: its I / tp units) and columns s of o and down; the
    token table and the norms live on d_0, where each block's terms are
    summed. A weight that is already on its device in `dtype` is taken as a
    view, so a shard on the model's own device copies nothing; elsewhere,
    or in another dtype (embed_notes' compute_dtype), each shard holds its
    own 1/tp. Called as the model is, on ids on d_0."""

    def __init__(self, model: LlamaModel, devices, dtype: torch.dtype | None = None):
        c = self.cfg = model.cfg
        devices = [torch.device(d) for d in devices]
        tp = len(devices)
        check_tp(c, tp)

        def part(w, name, s):
            n = w.shape[1] if name in _SPLIT_IN else w.shape[0]
            cut = slice(s * n // tp, (s + 1) * n // tp)
            return w[:, cut] if name in _SPLIT_IN else w[cut]

        d0 = devices[0]
        self.embed = placed(model.embed_tokens.weight, d0, dtype)
        self.final_norm = placed(model.final_norm.weight, d0, dtype)
        self.layers = []
        for blk in model.layers:
            shards = [dict({n: placed(part(getattr(blk, n).weight, n, s), d, dtype)
                            for n in _SPLIT + _SPLIT_IN}, device=d)
                      for s, d in enumerate(devices)]
            self.layers.append((placed(blk.input_norm.weight, d0, dtype),
                                placed(blk.post_norm.weight, d0, dtype), shards))

    def word_embedding_table(self) -> torch.Tensor:
        return self.embed

    def __call__(self, input_ids=None, attn_mask=None):
        x = F.embedding(input_ids, self.embed)
        for input_norm, post_norm, shards in self.layers:
            x = block_forward(self.cfg, x, attn_mask, input_norm, post_norm, shards)
        return rms_norm(x, self.final_norm, self.cfg.rms_norm_eps)


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
