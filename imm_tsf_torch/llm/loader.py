"""The frozen LLM: alias tables, tokenizer, loading, batched note
embedding (after imm_tsf_tpu/llm/loader.py; reference
fusions/load_llm.py).

Weights and tokenizer load from a local directory
(IMM_TSF_LLM_DIR/<alias>, or an explicit path); nothing is downloaded.
Without one, the model is random-initialised from a seed with the
initializer families flax uses (so its scale matches the JAX package's
random GPT-2) and the tokenizer falls back to the hash tokenizer:
embedding geometry for tests and benchmarks, not language understanding.

`embed_notes` pushes ragged lists of notes through the model in
length-bucketed row batches and mean-pools each note's real tokens in
float32. Only the GPT-2 family is ported; BERT, Llama and DeepSeek, and
the tensor-parallel mesh, come with later slices (ROADMAP.md).
"""

from __future__ import annotations

import glob
import math
import os

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.base import variance_scaling_

ALIAS = {
    # reference fusions/load_llm.py:5-13
    "GPT2": "openai-community/gpt2",
    "GPT2M": "openai-community/gpt2-medium",
    "GPT2L": "openai-community/gpt2-large",
    "GPT2XL": "openai-community/gpt2-xl",
    "BERT": "google-bert/bert-base-uncased",
    "Llama": "meta-llama/Llama-3.1-8B",
    "DeepSeek": "deepseek-ai/deepseek-llm-7b-base",
}

D_MODEL = {"GPT2": 768, "GPT2M": 1024, "GPT2L": 1280, "GPT2XL": 1600,
           "BERT": 768, "Llama": 4096, "DeepSeek": 4096}

CONTEXT_WINDOW = {"GPT2": 1024, "GPT2M": 1024, "GPT2L": 1024, "GPT2XL": 1024,
                  "BERT": 512, "Llama": 131072, "DeepSeek": 4096}


def get_d_model(alias: str) -> int:
    if alias in D_MODEL:
        return D_MODEL[alias]
    raise KeyError(f"Unknown LLM alias: {alias}")


class HashTokenizer:
    """Deterministic offline fallback: words -> vocab ids. Not a real BPE;
    keeps the token-count and padding contract so pipelines run. Ids come
    from Python's hash() of each word, so they are stable within one
    process (and across processes only under one PYTHONHASHSEED), exactly
    as in the JAX package."""

    def __init__(self, vocab_size: int, pad_token_id: int = 0):
        self.vocab_size = vocab_size
        self.pad_token_id = pad_token_id

    def __call__(self, texts, max_length: int = 1024):
        n = len(texts)
        ids = np.zeros((n, max_length), np.int32)
        if self.pad_token_id:
            ids[:] = self.pad_token_id
        mask = np.zeros((n, max_length), np.int32)
        mod = self.vocab_size - 2
        for i, t in enumerate(texts):
            toks = [1 + (hash(w) % mod) for w in str(t).split()[:max_length]]
            k = len(toks)
            if k:
                ids[i, :k] = toks
                mask[i, :k] = 1
        return ids, mask


def _local_dir(alias: str, model_dir: str | None):
    if model_dir:
        return model_dir
    root = os.environ.get("IMM_TSF_LLM_DIR")
    if root:
        for name in (alias, ALIAS[alias].split("/")[-1]):
            cand = os.path.join(root, name)
            if os.path.isdir(cand):
                return cand
    return None


def load_tokenizer(alias: str, model_dir: str | None = None):
    d = _local_dir(alias, model_dir)
    if d is not None:
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(d)
            if tok.pad_token is None:  # pad=eos (load_llm.py:98-100)
                tok.pad_token = tok.eos_token or "[PAD]"
            # the bucketed path slices ids[:, :bucket]: right padding
            tok.padding_side = "right"

            def call(texts, max_length=1024):
                out = tok(list(texts), padding="max_length", truncation=True,
                          max_length=max_length, return_tensors="np")
                return (out["input_ids"].astype(np.int32),
                        out["attention_mask"].astype(np.int32))

            call.vocab_size = len(tok)
            return call
        except Exception:  # no transformers, or no tokenizer files: hash tokenizer
            pass
    vocab = {"BERT": 30522, "Llama": 128256, "DeepSeek": 102400}.get(alias, 50257)
    return HashTokenizer(vocab)


def _load_state_dict(model_dir: str) -> dict:
    """A torch or safetensors checkpoint from a local directory, on the
    CPU, with the common prefixes ("transformer.", "model.", "bert.")
    stripped."""
    sd = {}
    st_files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if st_files:
        from safetensors.torch import load_file

        for f in st_files:
            sd.update(load_file(f))
    else:
        for f in sorted(glob.glob(os.path.join(model_dir, "pytorch_model*.bin"))):
            sd.update(torch.load(f, map_location="cpu", weights_only=True))
    out = {}
    for k, v in sd.items():
        for pre in ("transformer.", "model.", "bert."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


def _flax_init_(model: nn.Module, gen: torch.Generator) -> None:
    """Random weights in flax's default families: Dense kernels lecun
    normal (normal truncated at 2 sigma, scaled to variance 1/fan_in),
    biases 0; Embed tables normal with variance 1/features; LayerNorm
    scale 1, bias 0."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                variance_scaling_(m.weight, 1.0, m.in_features, gen)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, math.sqrt(1.0 / m.embedding_dim), generator=gen)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


def load_llm(alias: str, llm_layers: int | None = None,
             model_dir: str | None = None, device=None,
             use_fused_attn: bool = False,
             generator: torch.Generator | None = None):
    """(model, tokenizer): the frozen LLM in eval mode on `device` (cuda
    unless the caller asks for the CPU; raises without CUDA), its
    parameters with requires_grad False (load_llm.py:117-118).
    use_fused_attn routes GPT-2's attention through the CUDA kernel.
    Without a local checkpoint the weights are drawn from `generator` (a
    CPU generator; seed 0 when None)."""
    device = resolve_device(device)
    if not alias.startswith("GPT2"):
        if alias in ALIAS:
            raise NotImplementedError(
                f"LLM {alias!r} is not ported to imm_tsf_torch yet (ROADMAP.md, Queue 1, item 12)")
        raise ValueError(f"Unknown LLM alias {alias}")
    from .gpt2 import GPT2_SIZES, GPT2Model, convert_hf_gpt2

    d = _local_dir(alias, model_dir)
    tokenizer = load_tokenizer(alias, model_dir)
    with torch.device("meta"):
        model = GPT2Model(GPT2_SIZES[alias], n_layers=llm_layers,
                          use_fused_attn=use_fused_attn)
    model = model.to_empty(device="cpu")
    if d is not None:
        model.load_state_dict(convert_hf_gpt2(_load_state_dict(d), llm_layers))
    else:
        _flax_init_(model, generator or torch.Generator().manual_seed(0))
    model = model.to(device).eval().requires_grad_(False)
    return model, tokenizer


# static sequence-length buckets for the embedding forwards: each note
# runs at the smallest bucket >= its token count
EMBED_BUCKETS = (32, 64, 128, 256, 512, 1024)


def _pooled_forward(model, ids: np.ndarray, tok_mask: np.ndarray) -> torch.Tensor:
    """[rows, T] ids and mask -> [rows, d] masked mean of the last hidden
    state, pooled in float32; stays on the model's device."""
    dev = model.wte.weight.device
    ids_t = torch.from_numpy(ids).to(dev, torch.long)
    m = torch.from_numpy(tok_mask).to(dev)
    with torch.inference_mode():
        h = model(input_ids=ids_t, attn_mask=m.bool()).float()
        mf = m[:, :, None].float()
        return (h * mf).sum(1) / mf.sum(1).clamp(min=1e-6)


def _pad_rows(bi, bm, tgt):
    pad = tgt - bi.shape[0]
    if pad > 0:
        bi = np.concatenate([bi, np.zeros((pad,) + bi.shape[1:], bi.dtype)])
        bm = np.concatenate([bm, np.zeros((pad,) + bm.shape[1:], bm.dtype)])
    return bi, bm


def embed_notes(notes_text, model, tokenizer, max_length: int = 1024,
                token_batch: int = 64, bucketed: bool = True,
                token_budget: int = 32768, stats_out: dict | None = None,
                mesh=None):
    """Ragged List[List[str]] -> (float32 [B, N_max, d], bool note mask
    [B, N_max]), as NumPy arrays on the host.

    Numerics of reference load_llm.py:130-201: pad with "", truncate at
    max_length, masked mean-pool. Bucketed (default): each note runs at
    the smallest EMBED_BUCKETS length that holds it, in row batches of
    about `token_budget` tokens (rounded up to a power of two, at least
    `token_batch`), remainders padded to a power of two; empty notes are
    skipped and keep a zero row. Pads are attention-masked, so bucketing
    is exact. Not bucketed: `token_batch` rows at max_length. Device
    calls are queued and the pooled rows fetched once at the end.

    stats_out, if given, gets real_tokens / processed_tokens / n_notes."""
    if mesh is not None:
        raise NotImplementedError(
            "tensor-parallel note embedding waits for the multi-GPU layers "
            "(ROADMAP.md, Queue 1, item 16)")
    B = len(notes_text)
    N_max = max((len(s) for s in notes_text), default=1) or 1
    flat, note_mask = [], np.zeros((B, N_max), bool)
    for i, seq in enumerate(notes_text):
        for j in range(N_max):
            if j < len(seq):
                flat.append(seq[j])
                note_mask[i, j] = True
            else:
                flat.append("")
    ids, tok_mask = tokenizer(flat, max_length=max_length)
    n_flat = len(flat)
    d = model.wte.embedding_dim
    emb = np.zeros((n_flat, d), np.float32)
    real_tokens = int(tok_mask.sum())
    processed = 0
    pending: list = []
    if not bucketed:
        for s in range(0, n_flat, token_batch):
            sel = np.arange(s, min(s + token_batch, n_flat))
            pending.append((sel, _pooled_forward(model, ids[sel], tok_mask[sel])))
            processed += sel.size * max_length
    else:
        lengths = tok_mask.sum(axis=1)
        buckets = [b for b in EMBED_BUCKETS if b < max_length] + [max_length]
        bucket_of = np.full(n_flat, max_length, np.int64)
        for b in reversed(buckets):
            bucket_of[lengths <= b] = b
        for b in buckets:
            idx = np.nonzero((bucket_of == b) & (lengths > 0))[0]
            if idx.size == 0:
                continue
            rows = max(token_batch, token_budget // b)
            rows = 1 << (rows - 1).bit_length()  # power of two
            for s in range(0, idx.size, rows):
                sel = idx[s : s + rows]
                bi, bm = ids[sel, :b], tok_mask[sel, :b]
                if sel.size < rows:  # the remainder, padded to a power of two
                    bi, bm = _pad_rows(bi, bm, 1 << (sel.size - 1).bit_length())
                pending.append((sel, _pooled_forward(model, bi, bm)))
                processed += bi.shape[0] * b
    for sel, out in pending:
        emb[sel] = out[: sel.size].cpu().numpy()
    if stats_out is not None:
        stats_out.update(real_tokens=real_tokens, processed_tokens=processed,
                         n_notes=int(note_mask.sum()))
    emb = emb.reshape(B, N_max, d) * note_mask[:, :, None]
    return emb, note_mask
