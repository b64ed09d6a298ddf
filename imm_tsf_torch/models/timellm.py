"""TimeLLM — frozen-LLM reprogramming forecaster, irregular-adapted (after
imm_tsf_tpu/models/timellm.py; reference models/TimeLLM.py:64-278).

Masked normalisation; the values and the timestamps through ONE shared
PatchEmbedding (two calls, two dropout draws); the patches reprogrammed by
cross-attention onto `ts_vocab_size` prototypes that `mapping_layer`
makes from the frozen token table; prompt ++ patches through the frozen
LLM (`frozen_llm`, no attention mask: the exact prompt's pads are
attended to, as in the reference); a flatten head over the first d_ff
output dims. The LLM is GPT-2 or BERT (768 wide) or Llama-3.1-8B (4096
wide, `mapping_layer` 128,256 x ts_vocab_size), llm_model_timellm "GPT2",
"BERT" or "LLAMA".

Two prompt modes (cfg.timellm_exact_prompt):
  - False (fast): the domain description's ids are tokenized once at build
    (`domain_prompt_ids`, a buffer) and embedded through the frozen table;
    the series statistics (min, max, median, trend, top lags) enter as
    N_STAT_TOKENS learned pseudo-tokens (`stat_prompt`).
  - True (exact): the statistics are rendered to text and tokenized on
    the host per batch (`build_timellm_prompt_ids`, in the trainer's
    `_TimeLLMPromptLoader`), and the model embeds the batch's
    `prompt_ids`.

The frozen LLM takes no gradient (requires_grad False, and the training
optimizer never sees it) but passes the gradient through to the
reprogramming layer; with `use_pallas and use_fused_attn` GPT-2's
attention runs kernel #3, forward and backward (BERT and Llama attend by
matmul and the safe masked softmax, as in the JAX package).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..layers.embed import PatchEmbedding
from ..layers.fast_dropout import Dropout
from .base import dense, masked_norm, pad_time

N_STAT_TOKENS = 4
N_PROMPT_TOKENS = 32  # static length of the domain-description prompt


# llm_model_timellm -> the loader's alias (reference models/TimeLLM.py:73-130)
LLM_ALIAS = {"GPT2": "GPT2", "BERT": "BERT", "LLAMA": "Llama"}


def _frozen_llm(cfg: Config):
    """(the frozen LLM truncated to llm_layers_timellm blocks, its width):
    GPT-2 or BERT (768 wide) or Llama-3.1-8B (4096), drawn as the JAX
    package draws it (llm/loader._flax_init_ / _llama_init_) from torch's
    global generator on the host."""
    if cfg.llm_model_timellm not in LLM_ALIAS:
        raise ValueError("Unknown llm_model for TimeLLM")
    from ..llm.loader import build_llm

    llm, _, init_ = build_llm(LLM_ALIAS[cfg.llm_model_timellm], cfg.llm_layers_timellm,
                              use_fused_attn=cfg.use_pallas and cfg.use_fused_attn)
    llm = llm.to_empty(device="cpu")
    init_(llm, None)
    return llm.requires_grad_(False), llm.word_embedding_table().shape[1]


def n_patches(cfg: Config) -> int:
    """Patches a series gives: padded to input_len (and to the patch length
    when shorter), replicate-padded by the stride, unfolded."""
    L = max(cfg.input_len, cfg.input_token_len)
    return (L + cfg.stride - cfg.input_token_len) // cfg.stride + 1


def _autocorrelation(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, L, N] -> [B, n]: the circular autocorrelation by float32 FFT,
    averaged over channels (timellm.py:99-101). For a real series it is
    symmetric, corr[k] = corr[n - k], in exact arithmetic, so which of a
    pair leads is set by the FFT's rounding."""
    F = torch.fft.rfft(x.transpose(1, 2).float(), dim=-1)
    return torch.fft.irfft(F * F.conj(), n=n, dim=-1).mean(dim=1)


def top_lags(corr: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest entries of each row, largest first and
    an exact tie in index order, as lax.top_k gives them."""
    return torch.sort(corr, dim=-1, descending=True, stable=True).indices[:, :k]


def _median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """jnp.median: the mean of the two middle values for an even length
    (torch.median would take the lower one)."""
    xs = x.sort(dim=dim).values
    n = x.shape[dim]
    lo, hi = xs.select(dim, (n - 1) // 2), xs.select(dim, n // 2)
    return (lo + hi) * 0.5


class ReprogrammingLayer(nn.Module):
    """Cross-attention from the series' patches to the text prototypes
    (reference :32-61); every Dense with a zero bias and torch's uniform
    kernel, as the JAX package draws them."""

    def __init__(self, d_model: int, n_heads: int, d_llm: int, dropout: float = 0.1):
        super().__init__()
        self.n_heads = n_heads
        d_keys = d_model // n_heads
        self.query_projection = dense(d_model, d_keys * n_heads)
        self.key_projection = dense(d_llm, d_keys * n_heads)
        self.value_projection = dense(d_llm, d_keys * n_heads)
        self.out_projection = dense(d_keys * n_heads, d_llm)
        self.dropout = Dropout(dropout)

    def forward(self, Q, K_src, V_src):
        Bm, Lq, _ = Q.shape
        H = self.n_heads
        q = self.query_projection(Q).reshape(Bm, Lq, H, -1)
        k = self.key_projection(K_src).reshape(K_src.shape[0], H, -1)
        v = self.value_projection(V_src).reshape(V_src.shape[0], H, -1)
        scores = torch.einsum("blhe,she->bhls", q, k) / math.sqrt(k.shape[-1])
        A = self.dropout(torch.softmax(scores, dim=-1))
        out = torch.einsum("bhls,she->blhe", A, v).reshape(Bm, Lq, -1)
        return self.out_projection(out)


class TimeLLM(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.frozen_llm, d_llm = _frozen_llm(cfg)
        self.d_llm = d_llm
        stride = cfg.stride  # the dataset's stride (reference :75)
        self.patch_embedding = PatchEmbedding(cfg.d_model, cfg.input_token_len, stride, stride,
                                              cfg.dropout)
        self.mapping_layer = dense(self.frozen_llm.cfg.vocab_size, cfg.ts_vocab_size)
        self.reprogramming_layer = ReprogrammingLayer(cfg.d_model, cfg.n_heads, d_llm,
                                                      cfg.dropout)
        self.output_projection = dense(cfg.d_ff * n_patches(cfg), cfg.pred_len)
        self.dropout = Dropout(cfg.dropout)
        if not cfg.timellm_exact_prompt:
            n_stats = 3 * cfg.input_dim + 1 + min(cfg.top_k, cfg.input_len)
            self.stat_prompt = dense(n_stats, N_STAT_TOKENS * d_llm)
            # the ids are a constant: a buffer, which no optimizer sees
            self.register_buffer("domain_prompt_ids", _domain_token_ids(cfg, N_PROMPT_TOKENS))

    def _stat_prompt(self, x, B: int) -> torch.Tensor:
        """The fast prompt: the domain tokens and the statistics' learned
        pseudo-tokens [B, N_PROMPT_TOKENS + N_STAT_TOKENS, d_llm]."""
        cfg = self.cfg
        mins, maxs, meds = x.amin(dim=1), x.amax(dim=1), _median(x, dim=1)
        trend = torch.diff(x, dim=1).sum(dim=1).mean(dim=1, keepdim=True)
        corr = _autocorrelation(x, cfg.input_len)
        lags = top_lags(corr, min(cfg.top_k, cfg.input_len))
        stats = torch.cat([mins.float(), maxs.float(), meds.float(), trend.float(),
                           lags.float()], dim=-1).to(x.dtype)  # [B, 3N + 1 + top_k]
        domain = self.frozen_llm.get_input_embeddings(
            self.domain_prompt_ids.long()[None].expand(B, N_PROMPT_TOKENS)).detach()
        stat_tokens = self.stat_prompt(stats).reshape(B, N_STAT_TOKENS, self.d_llm)
        return torch.cat([domain.to(stat_tokens.dtype), stat_tokens], dim=1)

    def forward(self, tp_to_predict, observed_data, observed_tp, observed_mask,
                prompt_ids=None):
        cfg = self.cfg
        seq_len, pred_len, N = cfg.input_len, cfg.pred_len, cfg.input_dim
        patch_len = cfg.input_token_len
        observed_data = pad_time(observed_data, seq_len)
        observed_mask = pad_time(observed_mask, seq_len)
        observed_tp = pad_time(observed_tp, seq_len)
        Lp = tp_to_predict.shape[1]
        B = observed_data.shape[0]
        llm, d_llm = self.frozen_llm, self.d_llm

        x, means, stdev = masked_norm(observed_data, observed_mask)
        if prompt_ids is not None:  # the exact prompt, tokenized on the host
            prompt_embeds = llm.get_input_embeddings(prompt_ids.long()).detach().to(x.dtype)
        elif cfg.timellm_exact_prompt:
            raise ValueError("timellm_exact_prompt: the batch carries no prompt_ids "
                             "(the trainer's _TimeLLMPromptLoader adds them)")
        else:
            prompt_embeds = self._stat_prompt(x, B)

        # the values and the timestamps through the one patch embedder (:239-253)
        x_ts = x.transpose(1, 2)  # [B, N, L]
        x_tp = observed_tp[:, None, :].expand(B, N, observed_tp.shape[1])
        if x_ts.shape[-1] < patch_len:
            padn = patch_len - x_ts.shape[-1]
            x_ts = nn.functional.pad(x_ts, (0, padn))
            x_tp = nn.functional.pad(x_tp, (0, padn))
        ts_out, n_vars = self.patch_embedding(x_ts)  # [B*N, Pn, d_model]
        tp_out, _ = self.patch_embedding(x_tp)
        rep_in = ts_out + tp_out
        Pn = rep_in.shape[1]

        # reprogramming (:32-61): the prototypes map the whole frozen table
        word_emb = llm.word_embedding_table().detach()
        src_emb = self.mapping_layer(word_emb.t().to(x.dtype)).t()  # [ts_vocab, d_llm]
        rep_out = self.reprogramming_layer(rep_in, src_emb, src_emb)  # [B*N, Pn, d_llm]

        # through the frozen LLM (:260-263)
        rep_out = rep_out.reshape(B, n_vars, Pn, d_llm).transpose(1, 2)
        llm_in = torch.cat([prompt_embeds, rep_out.reshape(B, Pn * n_vars, d_llm)], dim=1)
        llm_out = llm(inputs_embeds=llm_in)

        dec = llm_out[:, -Pn * n_vars:, : cfg.d_ff]
        dec = dec.reshape(B, Pn, n_vars, cfg.d_ff).permute(0, 2, 3, 1)  # [B, N, d_ff, Pn]
        out = self.output_projection(dec.reshape(B * n_vars, cfg.d_ff * Pn))  # FlattenHead
        out = self.dropout(out).reshape(B, n_vars, pred_len).transpose(1, 2)
        if cfg.use_norm:
            out = out * stdev + means
        return out[:, :Lp, :]


def build_timellm_prompts(cfg: Config, observed_data, observed_tp,
                          observed_mask) -> list[str]:
    """Host-side (NumPy) replica of the reference prompt text,
    models/TimeLLM.py:168-195: masked normalization, then per-sample
    min/max/median/trend/top-lags rendered with the EXACT reference
    f-string (torch .tolist() and numpy .tolist() print identical Python
    floats). Median uses torch's lower-median semantics for even lengths
    (torch.median != numpy median). A copy of the JAX package's function."""
    seq_len = cfg.input_len
    L = observed_data.shape[1]
    if L < seq_len:  # pad_time analog
        pad = seq_len - L
        observed_data = np.pad(observed_data, ((0, 0), (0, pad), (0, 0)))
        observed_mask = np.pad(observed_mask, ((0, 0), (0, pad), (0, 0)))
    x = (observed_data * observed_mask).astype(np.float32)
    sums = np.clip(observed_mask.sum(axis=1, keepdims=True), 1, None)
    means = x.sum(axis=1, keepdims=True) / sums
    x = x - means
    var = ((x * observed_mask) ** 2).sum(axis=1, keepdims=True) / sums
    x = (x / np.sqrt(var + 1e-5)).astype(np.float32)

    B, Lx, N = x.shape
    mins = x.min(axis=1)
    maxs = x.max(axis=1)
    meds = np.sort(x, axis=1)[:, (Lx - 1) // 2, :]  # torch lower median
    trend = np.diff(x, axis=1).sum(axis=1).mean(axis=1)
    F = np.fft.rfft(x.transpose(0, 2, 1), axis=-1)
    corr = np.fft.irfft(F * np.conj(F), n=Lx, axis=-1).mean(axis=1)
    top_k = cfg.top_k
    k = min(top_k, Lx)
    lags = np.argsort(-corr, axis=-1, kind="stable")[:, :k]
    if k < top_k:  # reference :177-179 pads with the last lag
        lags = np.concatenate(
            [lags, np.repeat(lags[:, -1:], top_k - k, axis=1)], axis=1)

    prompts = []
    for b in range(B):
        tr = "upward" if trend[b].item() > 0 else "downward"
        prompts.append(
            f"<|start_prompt|>"
            f"Dataset: {cfg.domain_des}. "
            f"Forecast next {cfg.pred_len} from past {cfg.input_len}. "
            f"Min {mins[b].astype(np.float32).tolist()}, "
            f"Max {maxs[b].astype(np.float32).tolist()}, "
            f"Median {meds[b].astype(np.float32).tolist()}, "
            f"Trend {tr}, "
            f"Top lags {lags[b].tolist()}."
            f"<|end_prompt|>"
        )
    return prompts


def build_timellm_prompt_ids(cfg: Config, batch: dict, tokenizer,
                             pad_to: int | None = None) -> np.ndarray:
    """prompts -> int32 [B, P] ids via the LLM tokenizer (reference pads
    to batch max, :233-235); pad_to fixes a static length (ids truncated /
    padded with the tokenizer's pad id, right side)."""
    prompts = build_timellm_prompts(
        cfg, np.asarray(batch["observed_data"]),
        np.asarray(batch["observed_tp"]), np.asarray(batch["observed_mask"]),
    )
    ids, _mask = tokenizer(prompts, max_length=pad_to or 512)
    ids = np.asarray(ids, np.int32)
    if pad_to is None:
        # trim to the batch max real length (reference padding=True)
        lengths = _mask.sum(axis=1) if _mask is not None else None
        if lengths is not None and lengths.max() > 0:
            ids = ids[:, : int(lengths.max())]
    return ids


def _domain_token_ids(cfg: Config, n_tokens: int) -> torch.Tensor:
    """Tokenize the constant domain description once at build (host); ids
    from default_rng(0) when no tokenizer loads, as the JAX package does."""
    try:
        from ..llm.loader import load_tokenizer

        tok = load_tokenizer(LLM_ALIAS.get(cfg.llm_model_timellm, "Llama"))
        ids, _ = tok([cfg.domain_des], max_length=n_tokens)
        return torch.from_numpy(np.asarray(ids[0], np.int32))
    except Exception:
        rng = np.random.default_rng(0)
        return torch.from_numpy(rng.integers(0, 1000, n_tokens).astype(np.int32))
