"""The frozen LLM: alias tables, tokenizer, loading, batched note
embedding (after imm_tsf_tpu/llm/loader.py; reference
fusions/load_llm.py).

Weights and tokenizer load from a local directory
(IMM_TSF_LLM_DIR/<alias>, or an explicit path); nothing is downloaded.
Without one, the model is random-initialised from a seed with the
initializer families flax uses (so its scale matches the JAX package's
random GPT-2) and the tokenizer falls back to the hash tokenizer:
embedding geometry for tests and benchmarks, not language understanding.

Every alias is ported: the GPT-2 family, BERT, Llama-3.1-8B and
DeepSeek-7B. A full-depth Llama (7.50 B parameters without the LM head,
30.0 GB in float32) fits one 80 GB card, so `llm_tp` 0 (auto) and 1
resolve to one device; the tensor-parallel mesh is the half of the
multi-GPU layers still to port (ROADMAP.md, Queue 1, item 16, the TP
half; the data-parallel half is parallel/).

`embed_notes` pushes ragged lists of notes through the model in
length-bucketed row batches and mean-pools each note's real tokens in
float32; with `compute_dtype=torch.bfloat16` the frozen weights and the
activations are bfloat16 (the weights cast once per model).
"""

from __future__ import annotations

import copy
import glob
import math
import os
import weakref

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


def get_context_window_size(alias: str) -> int:
    return CONTEXT_WINDOW[alias]


def resolve_llm_mesh(alias: str, llm_tp: int):
    """cfg.llm_tp on one card: 0 (auto) and 1 give None, one device for
    every alias (a full-depth Llama fits one 80 GB card); more than one
    is refused until the tensor-parallel half of the multi-GPU layers lands."""
    if llm_tp > 1:
        raise NotImplementedError(
            f"llm_tp={llm_tp}: the tensor-parallel LLM mesh is not ported "
            "(ROADMAP.md, Queue 1, item 16, the TP half)")
    return None


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


def _flax_init_(model: nn.Module, gen: torch.Generator | None) -> None:
    """Random weights in flax's default families (GPT-2, BERT): Dense
    kernels lecun normal (normal truncated at 2 sigma, scaled to variance
    1/fan_in), biases 0; Embed tables normal with variance 1/features;
    LayerNorm scale 1, bias 0."""
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


def _llama_init_(model: nn.Module, gen: torch.Generator | None) -> None:
    """Random weights as the JAX LlamaModel draws them: every projection
    normal(0.02), untruncated, no bias; the Embed table normal with
    variance 1/features; RMSNorm scale 1."""
    from .llama import RMSNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 0.02, generator=gen)
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, math.sqrt(1.0 / m.embedding_dim), generator=gen)
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)


def build_llm(alias: str, llm_layers: int | None = None, use_fused_attn: bool = False):
    """(the alias's model on the meta device, its Hugging Face converter,
    its random init): GPT-2 (use_fused_attn routes its attention through
    kernel #3), BERT, or the Llama family (Llama, DeepSeek)."""
    if alias.startswith("GPT2") and alias in ALIAS:
        from .gpt2 import GPT2_SIZES, GPT2Model, convert_hf_gpt2

        with torch.device("meta"):
            model = GPT2Model(GPT2_SIZES[alias], n_layers=llm_layers,
                              use_fused_attn=use_fused_attn)
        return model, convert_hf_gpt2, _flax_init_
    if alias == "BERT":
        from .bert import BertConfig, BertModel, convert_hf_bert

        with torch.device("meta"):
            model = BertModel(BertConfig(), n_layers=llm_layers)
        return model, convert_hf_bert, _flax_init_
    if alias in ("Llama", "DeepSeek"):
        from .llama import LLAMA_SIZES, LlamaModel, convert_hf_llama

        with torch.device("meta"):
            model = LlamaModel(LLAMA_SIZES[alias], n_layers=llm_layers)
        return model, convert_hf_llama, _llama_init_
    raise ValueError(f"Unknown LLM alias {alias}")


def load_llm(alias: str, llm_layers: int | None = None,
             model_dir: str | None = None, device=None,
             use_fused_attn: bool = False,
             generator: torch.Generator | None = None):
    """(model, tokenizer): the frozen LLM in eval mode on `device` (cuda
    unless the caller asks for the CPU; raises without CUDA), its
    parameters with requires_grad False (load_llm.py:117-118).
    use_fused_attn routes GPT-2's attention through the CUDA kernel (BERT
    and Llama attend by matmul and the safe masked softmax, as in the JAX
    package). Without a local checkpoint the weights are drawn where
    `generator` lives, from it, then moved to `device`; when it is None,
    from a generator seeded 0 on `device` itself, so a full-depth Llama
    (7.50 B floats) is drawn on the card and never on the host."""
    device = resolve_device(device)
    model, convert_hf, init_ = build_llm(alias, llm_layers, use_fused_attn)
    d = _local_dir(alias, model_dir)
    tokenizer = load_tokenizer(alias, model_dir)
    if d is not None:
        model = model.to_empty(device="cpu")
        model.load_state_dict(convert_hf(_load_state_dict(d), llm_layers))
    else:
        gen = generator if generator is not None else torch.Generator(device).manual_seed(0)
        model = model.to_empty(device=gen.device)
        init_(model, gen)
    model = model.to(device).eval().requires_grad_(False)
    return model, tokenizer


# static sequence-length buckets for the embedding forwards: each note
# runs at the smallest bucket >= its token count
EMBED_BUCKETS = (32, 64, 128, 256, 512, 1024)


def _pooled_forward(model, ids: np.ndarray, tok_mask: np.ndarray) -> torch.Tensor:
    """[rows, T] ids and mask -> [rows, d] masked mean of the last hidden
    state, pooled in float32; stays on the model's device."""
    dev = model.word_embedding_table().device
    ids_t = torch.from_numpy(ids).to(dev, torch.long)
    m = torch.from_numpy(tok_mask).to(dev)
    with torch.inference_mode():
        h = model(input_ids=ids_t, attn_mask=m.bool()).float()
        mf = m[:, :, None].float()
        return (h * mf).sum(1) / mf.sum(1).clamp(min=1e-6)


# a model's copy in another dtype, made once per (model, dtype) and kept
# while the model lives
_CAST: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _in_dtype(model: nn.Module, dtype: torch.dtype | None) -> nn.Module:
    """`model` itself when its weights are `dtype` (or dtype is None),
    else its cached copy in `dtype`."""
    if dtype is None or model.word_embedding_table().dtype == dtype:
        return model
    copies = _CAST.setdefault(model, {})
    if dtype not in copies:
        # the copy takes tensors cast straight from the model's (deepcopy's
        # memo), so no second float32 model is ever held (a full-depth
        # Llama is 30 GB)
        memo = {id(p): nn.Parameter(p.detach().to(dtype), requires_grad=p.requires_grad)
                for p in model.parameters() if p.is_floating_point()}
        memo.update((id(b), b.to(dtype)) for b in model.buffers() if b.is_floating_point())
        copies[dtype] = copy.deepcopy(model, memo)
    return copies[dtype]


def _pad_rows(bi, bm, tgt):
    pad = tgt - bi.shape[0]
    if pad > 0:
        bi = np.concatenate([bi, np.zeros((pad,) + bi.shape[1:], bi.dtype)])
        bm = np.concatenate([bm, np.zeros((pad,) + bm.shape[1:], bm.dtype)])
    return bi, bm


def embed_notes(notes_text, model, tokenizer, max_length: int = 1024,
                token_batch: int = 64, bucketed: bool = True,
                token_budget: int = 32768, stats_out: dict | None = None,
                mesh=None, compute_dtype: torch.dtype | None = None):
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

    compute_dtype (torch.bfloat16): run the frozen forward on a copy of
    the model in that dtype, made once per model (a model already in it
    runs as it is), with the activations in it too; the pooling stays
    float32 (the JAX package's `_get_pooled_fwd` / `_get_dev_params`).

    stats_out, if given, gets real_tokens / processed_tokens / n_notes."""
    if mesh is not None:
        raise NotImplementedError(
            "tensor-parallel note embedding, the TP half of the multi-GPU layers, is not "
            "ported (ROADMAP.md, Queue 1, item 16, the TP half)")
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
    model = _in_dtype(model, compute_dtype)
    d = model.word_embedding_table().shape[1]
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
