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
DeepSeek-7B. `llm_tp` picks the LLM's ("data", "model") mesh by the JAX
package's rules (`resolve_llm_mesh`), over the devices this process
drives: the cards from the run's card on (a rank of a data mesh: its own
card), or on the CPU `llm_tp` copies of it. `shard_llm_params` lays the
model out over the mesh: the Llama family's projections split over the
"model" axis (llm/llama.LlamaShards), GPT-2 and BERT whole on each data
group (the JAX package gives them no partition specs). A full-depth Llama
(7.50 B parameters without the LM head, 30.0 GB in float32) fits one
80 GB card, so on one card every `llm_tp` resolves to one device.

`embed_notes` pushes ragged lists of notes through the model in
length-bucketed row batches and mean-pools each note's real tokens in
float32; with `compute_dtype=torch.bfloat16` the frozen weights and the
activations are bfloat16 (the weights cast once per model, or per shard).
With a mesh each row batch is padded to a multiple of the data groups and
split between them, each group computing its contiguous share.
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
from ..parallel.mesh import LlmMesh

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


def llm_devices(device=None, llm_tp: int = 1) -> list:
    """The devices the frozen LLM's mesh may take in this process: on cuda
    the cards from `device`'s on (the current card when it names none), or
    the rank's own card alone under a data mesh of more than one rank
    (parallel/mesh.py: each rank drives one card); on the CPU, which has no
    count to clip to, `llm_tp` copies of it."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * max(1, llm_tp)
    first = dev.index if dev.index is not None else torch.cuda.current_device()
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return [torch.device("cuda", first)]
    return [torch.device("cuda", i) for i in range(first, torch.cuda.device_count())]


def make_llm_mesh(tp: int = 1, n_devices: int | None = None, devices=None) -> LlmMesh | None:
    """The ("data", "model") mesh of the frozen LLM (the JAX package's
    make_llm_mesh): tp-way tensor parallelism, the remaining devices on the
    data (row-batch) axis, over `devices` (the test hook: copies of the CPU
    or of one card stand in for several) or else the first `n_devices` of
    llm_devices(). tp is clipped to the device count and must divide it.
    Without explicit devices, tp <= 1 gives None (one device computes), as
    in the JAX package; with them, any grid of two devices or more."""
    explicit = devices is not None
    if not explicit:
        devices = llm_devices("cuda")
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(f"{n_devices} devices asked, {len(devices)} available")
            devices = devices[:n_devices]
    n = len(devices)
    tp = max(1, min(tp, n))
    if (tp <= 1 and not explicit) or n <= 1:
        return None
    if n % tp:
        raise ValueError(f"tp={tp} must divide device count {n}")
    return LlmMesh(devices, tp)


def resolve_llm_mesh(alias: str, llm_tp: int, device=None, devices=None) -> LlmMesh | None:
    """cfg.llm_tp as the JAX package reads it: 1 gives None (one device);
    0 (auto) every device on the "model" axis for Llama and DeepSeek when
    there are two or more, else None; above 1 the width, clipped to the
    device count (None where that leaves 1). The devices: `devices`, or
    llm_devices(device, llm_tp). A width the Llama family's heads, KV heads
    or intermediate units do not divide is refused."""
    if llm_tp == 1:
        return None
    if devices is None:
        devices = llm_devices(device, llm_tp)
    n = len(devices)
    if llm_tp == 0:
        tp = n if alias in ("Llama", "DeepSeek") and n > 1 else 1
    else:
        tp = max(1, min(llm_tp, n))
    if tp <= 1:
        return None
    if alias in ("Llama", "DeepSeek"):
        from .llama import LLAMA_SIZES, check_tp

        check_tp(LLAMA_SIZES[alias], tp)
    return make_llm_mesh(tp, devices=devices)


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
    state, pooled in float32; stays on the device of the model's token
    table (a data group's first device)."""
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


def _copy_to(model: nn.Module, device, dtype: torch.dtype | None) -> nn.Module:
    """A copy of `model` whose tensors are cast straight from the model's
    onto `device` in `dtype` (deepcopy's memo), so no second float32 model
    is ever held (a full-depth Llama is 30 GB)."""
    from .gpt2 import placed

    memo = {id(p): nn.Parameter(placed(p, device, dtype), requires_grad=p.requires_grad)
            for p in model.parameters()}
    memo.update((id(b), placed(b, device, dtype)) for b in model.buffers())
    return copy.deepcopy(model, memo)


def _in_dtype(model: nn.Module, dtype: torch.dtype | None) -> nn.Module:
    """`model` itself when its weights are `dtype` (or dtype is None),
    else its cached copy in `dtype`."""
    table = model.word_embedding_table()
    if dtype is None or table.dtype == dtype:
        return model
    copies = _CAST.setdefault(model, {})
    if dtype not in copies:
        copies[dtype] = _copy_to(model, table.device, dtype)
    return copies[dtype]


def _lay_out(model: nn.Module, mesh: LlmMesh, dtype: torch.dtype | None) -> list:
    """One model a data group of `mesh`: the Llama family split over the
    group's "model" devices (llama.LlamaShards); GPT-2 and BERT whole on
    the group's first device (the model itself where that is its device
    and dtype, else a copy)."""
    from .llama import LlamaModel, LlamaShards

    if isinstance(model, LlamaModel):
        return [LlamaShards(model, devices, dtype) for devices in mesh.grid]
    table = model.word_embedding_table()
    return [model if (g[0] == table.device and dtype in (None, table.dtype))
            else _copy_to(model, g[0], dtype) for g in mesh.grid]


def shard_llm_params(model: nn.Module, mesh: LlmMesh,
                     compute_dtype: torch.dtype | None = None) -> list:
    """`model` laid out over `mesh` (the JAX package's shard_llm_params:
    each model-axis device holds 1/tp of every split projection), in
    `compute_dtype` when given (each shard cast on its own): one callable
    a data group, called as the model is. Made once per (model, mesh,
    dtype) and kept in a bounded cache, as the JAX package's
    _get_dev_params keeps its device params."""
    key = (id(model), id(mesh), compute_dtype)
    hit = _SHARDS.get(key)
    if hit is None or hit[0] is not model or hit[1] is not mesh:
        while len(_SHARDS) >= _CACHE_LIMIT:
            _SHARDS.pop(next(iter(_SHARDS)))
        hit = _SHARDS[key] = (model, mesh, _lay_out(model, mesh, compute_dtype))
    return hit[2]


# shards per (model, mesh, dtype), first in first out; an entry holds its
# model and mesh, so the bound keeps a sweep over many LLMs from growing
_CACHE_LIMIT = 4
_SHARDS: dict = {}


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

    mesh: an LlmMesh (make_llm_mesh, resolve_llm_mesh), the JAX package's
    ("data", "model") mesh: the model laid out over it once
    (shard_llm_params), every row batch padded to a multiple of its dp data
    groups (JAX :382, :408, :417) and split between them in contiguous
    shares; the pooled rows come back in order.

    stats_out, if given, gets real_tokens / processed_tokens / n_notes."""
    if mesh is not None and not isinstance(mesh, LlmMesh):
        raise TypeError(f"mesh must be an LlmMesh (make_llm_mesh), not {type(mesh).__name__}")
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
    d = model.word_embedding_table().shape[1]
    if mesh is None:
        dp, one = 1, _in_dtype(model, compute_dtype)
        fwd = lambda bi, bm: [_pooled_forward(one, bi, bm)]
    else:
        dp, groups = mesh.shape["data"], shard_llm_params(model, mesh, compute_dtype)

        def fwd(bi, bm):
            r = bi.shape[0] // dp  # the callers pad the rows to a multiple of dp
            return [_pooled_forward(g, bi[k * r:(k + 1) * r], bm[k * r:(k + 1) * r])
                    for k, g in enumerate(groups)]

    emb = np.zeros((n_flat, d), np.float32)
    real_tokens = int(tok_mask.sum())
    processed = 0
    pending: list = []
    if not bucketed:
        for s in range(0, n_flat, token_batch):
            sel = np.arange(s, min(s + token_batch, n_flat))
            bi, bm = _pad_rows(ids[sel], tok_mask[sel], -(-sel.size // dp) * dp)
            pending.append((sel, fwd(bi, bm)))
            processed += bi.shape[0] * max_length
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
            rows = max(token_batch, token_budget // b, dp)
            rows = 1 << (rows - 1).bit_length()  # power of two
            rows = -(-rows // dp) * dp  # a multiple of the data groups
            for s in range(0, idx.size, rows):
                sel = idx[s : s + rows]
                bi, bm = ids[sel, :b], tok_mask[sel, :b]
                if sel.size < rows:  # the remainder, padded to a power of two
                    tgt = 1 << (sel.size - 1).bit_length()
                    bi, bm = _pad_rows(bi, bm, -(-max(tgt, dp) // dp) * dp)
                pending.append((sel, fwd(bi, bm)))
                processed += bi.shape[0] * b
    for sel, outs in pending:
        emb[sel] = np.concatenate([o.cpu().numpy() for o in outs])[: sel.size]
    if stats_out is not None:
        stats_out.update(real_tokens=real_tokens, processed_tokens=processed,
                         n_notes=int(note_mask.sum()))
    emb = emb.reshape(B, N_max, d) * note_mask[:, :, None]
    return emb, note_mask
