"""BERT and the Llama family through the port's loader, note embedding
and TimeLLM, against the JAX package, on the CPU.

The full-size configs are shrunk on both sides by patching the shared
`LLAMA_SIZES` dicts and the `BertConfig` name each package's loader and
TimeLLM call. TimeLLM keeps each LLM at the width the JAX TimeLLM fixes
(BERT 768, Llama 4096) with one layer, vocab 256 and intermediate 64;
both packages' tokenizers are the hash tokenizer over that vocab.

- `load_llm`'s seeded random init (BERT, Llama, DeepSeek) against the JAX
  `model.init` under two keys each: the same tensor names; biases exactly
  zero and norm scales exactly one on both sides; every other tensor's
  std within 10 % of the JAX one; BERT's lecun-normal kernels within
  their truncation at 2 sigma on both sides, Llama's normal(0.02)
  projections untruncated;
- `embed_notes` through a small BERT and a small GQA Llama carried by
  `*_params_from_jax`, bucketed and not, against the JAX `embed_notes`:
  2e-5, equal note masks and stats;
- `compute_dtype=torch.bfloat16`: the pooled output stays float32 and
  within 0.05 x its scale of the float32 one (tests/test_llm_stack.py:128)
  and of the JAX bfloat16 one; the bfloat16 copy is made once per model;
- TimeLLM with llm_model_timellm "BERT" and "LLAMA": the eval forward in
  both prompt modes, to 2e-5; `trainable` from the JAX init against the
  JAX `trainable` (BERT on the fast prompt, LLAMA on the exact one, one
  epoch of two steps): the losses to 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.llm import bert as jbert
from imm_tsf_tpu.llm import llama as jllama
from imm_tsf_tpu.llm import loader as jloader
from imm_tsf_tpu.models import get_model as j_get_model
from imm_tsf_tpu.models import timellm as jtimellm

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.convert import bert_params_from_jax, llama_params_from_jax, params_from_jax
from imm_tsf_torch.llm import bert, llama, loader
from imm_tsf_torch.models import get_model
from torch_port_parity import np_tree, trainable_matches_jax
from torch_port_parity import jitted_jax_init  # noqa: F401 -- autouse: JAX's init jitted

torch.set_num_threads(1)

ATOL = 2e-5
STD_BAND = 0.10
TRUNC_STD = 0.87962566103423978  # std of the unit normal truncated to [-2, 2]
VOCAB = 256
BERT_SMALL = dict(vocab_size=VOCAB, max_position_embeddings=64, hidden_size=64,
                  num_hidden_layers=2, num_attention_heads=4, intermediate_size=128)
LLAMA_SMALL = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2)
JAX_MODELS = {"BERT": lambda: jbert.BertModel(jbert.BertConfig(**BERT_SMALL)),
              "Llama": lambda: jllama.LlamaModel(jllama.LLAMA_SIZES["Llama"]),
              "DeepSeek": lambda: jllama.LlamaModel(jllama.LLAMA_SIZES["DeepSeek"])}
TO_PORT = {"BERT": bert_params_from_jax, "Llama": llama_params_from_jax,
           "DeepSeek": llama_params_from_jax}


def _shrink(monkeypatch, bert_kw, llama_kw):
    """Both packages' BERT and Llama family at the given sizes, and the
    hash tokenizer over VOCAB on both sides."""
    monkeypatch.setattr(jtimellm, "BertConfig", lambda: jbert.BertConfig(**bert_kw))
    port_config = bert.BertConfig
    monkeypatch.setattr(bert, "BertConfig", lambda: port_config(**bert_kw))
    for sizes in (jllama.LLAMA_SIZES, llama.LLAMA_SIZES):
        for alias in ("Llama", "DeepSeek"):
            monkeypatch.setitem(sizes, alias, dataclasses.replace(sizes[alias], **llama_kw))
    monkeypatch.setattr(jloader, "load_tokenizer", lambda alias, model_dir=None:
                        jloader.HashTokenizer(VOCAB))
    monkeypatch.setattr(loader, "load_tokenizer", lambda alias, model_dir=None:
                        loader.HashTokenizer(VOCAB))


# ------------------------------------------------------------ random init
def _family(key: str, alias: str):
    """(family, scale) of one port tensor, as the JAX modules draw it."""
    if key.endswith(".bias"):
        return "zero", 0.0
    if key.endswith("ln.weight") or key.endswith("norm.weight"):
        return "one", 1.0
    if "embed" in key:  # nn.Embed: N(0, 1 / features)
        return "normal", None
    return ("lecun", None) if alias == "BERT" else ("normal", 0.02)


@pytest.mark.parametrize("alias", ["BERT", "Llama", "DeepSeek"])
def test_load_llm_random_init_matches_jax_scales(alias, monkeypatch):
    _shrink(monkeypatch, BERT_SMALL, LLAMA_SMALL)
    jm = JAX_MODELS[alias]()
    init = jax.jit(lambda key: jm.init(key, jnp.zeros((1, 8), jnp.int32))["params"])
    want, got = {}, {}
    for seed in (0, 1):
        for k, v in TO_PORT[alias](np_tree(init(jax.random.PRNGKey(seed)))).items():
            want.setdefault(k, []).append(v.numpy())
        model, _ = loader.load_llm(alias, device="cpu",
                                   generator=torch.Generator().manual_seed(seed))
        assert not any(p.requires_grad for p in model.parameters())
        for k, v in model.state_dict().items():
            got.setdefault(k, []).append(v.numpy())
    assert sorted(got) == sorted(want)
    for k in sorted(want):
        w, g = np.stack(want[k]), np.stack(got[k])
        assert w.shape == g.shape, k
        family, scale = _family(k, alias)
        if family in ("zero", "one"):
            assert (w == scale).all() and (g == scale).all(), k
            continue
        assert abs(g.std() / w.std() - 1) <= STD_BAND, f"{k}: {g.std():.4g} vs {w.std():.4g}"
        if family == "lecun":  # truncated at 2 sigma of the untruncated normal
            bound = 2 * (1 / w.shape[-1]) ** 0.5 / TRUNC_STD  # fan_in: the port's [out, in]
            assert np.abs(w).max() <= bound and np.abs(g).max() <= bound, k
        elif scale is not None:  # normal(0.02), untruncated
            assert np.abs(g).max() > 2.5 * scale and np.abs(w).max() > 2.5 * scale, k


# ------------------------------------------------------------ note embedding
NOTES = [["a b c", " ".join(f"w{i}" for i in range(40)), ""],
         [" ".join(f"t{i}" for i in range(25)), "x"],
         [],
         [" ".join(f"u{i}" for i in range(70)), "y z", "q"]]


def _carried(alias: str):
    """(JAX model, its params, the port's model with them), small."""
    jm = (jbert.BertModel(jbert.BertConfig(**BERT_SMALL)) if alias == "BERT"
          else jllama.LlamaModel(jllama.LlamaConfig(**LLAMA_SMALL)))
    params = np_tree(jax.jit(jm.init)(jax.random.PRNGKey(2),
                                      jnp.zeros((1, 8), jnp.int32))["params"])
    tm = (bert.BertModel(bert.BertConfig(**BERT_SMALL)) if alias == "BERT"
          else llama.LlamaModel(llama.LlamaConfig(**LLAMA_SMALL)))
    tm.load_state_dict(TO_PORT[alias](params))
    return jm, params, tm.eval()


@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("alias", ["BERT", "Llama"])
def test_embed_notes_matches_jax(alias, bucketed):
    jm, params, tm = _carried(alias)
    tok = loader.HashTokenizer(VOCAB)
    kw = dict(max_length=64, token_batch=4, bucketed=bucketed)
    jstats, tstats = {}, {}
    want, wmask = jloader.embed_notes(NOTES, jm, params, jloader.HashTokenizer(VOCAB),
                                      stats_out=jstats, **kw)
    got, gmask = loader.embed_notes(NOTES, tm, tok, stats_out=tstats, **kw)
    assert got.dtype == np.float32 and got.shape == (4, 3, 64)
    np.testing.assert_array_equal(gmask, wmask)
    assert tstats == jstats
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("alias", ["BERT", "Llama"])
def test_embed_notes_bfloat16_close_and_pooled_in_float32(alias):
    jm, params, tm = _carried(alias)
    tok = loader.HashTokenizer(VOCAB)
    f32, _ = loader.embed_notes(NOTES, tm, tok, max_length=64)
    b16, mask = loader.embed_notes(NOTES, tm, tok, max_length=64, compute_dtype=torch.bfloat16)
    copy = loader._CAST[tm][torch.bfloat16]
    again, _ = loader.embed_notes(NOTES, tm, tok, max_length=64, compute_dtype=torch.bfloat16)
    assert loader._CAST[tm] == {torch.bfloat16: copy}  # cast once per model
    assert copy.word_embedding_table().dtype == torch.bfloat16
    assert tm.word_embedding_table().dtype == torch.float32
    np.testing.assert_array_equal(again, b16)
    jb16, _ = jloader.embed_notes(NOTES, jm, params, jloader.HashTokenizer(VOCAB), max_length=64,
                                  compute_dtype=jnp.bfloat16)
    assert b16.dtype == np.float32
    scale = np.abs(f32).max()
    np.testing.assert_allclose(b16, f32, atol=0.05 * scale, rtol=0)
    np.testing.assert_allclose(b16, np.asarray(jb16), atol=0.05 * scale, rtol=0)
    assert not np.array_equal(b16, f32) and not b16[~mask].any()


# ------------------------------------------------------------ TimeLLM
TL_BERT = dict(num_hidden_layers=1, vocab_size=VOCAB, intermediate_size=64)  # 768 wide, 12 heads
TL_LLAMA = dict(num_hidden_layers=1, vocab_size=VOCAB, intermediate_size=64)  # 4096, 32 / 8
HP = dict(model="TimeLLM", dataset="EPA-Air", input_dim=3, input_len=12, pred_len=6,
          history=12, stride=4, input_token_len=4, d_model=16, d_ff=32, n_heads=2,
          ts_vocab_size=64, top_k=1, llm_layers_timellm=1, dropout=0.0, timellm_prompt_len=48)
ARGS = ("tp_to_predict", "observed_data", "observed_tp", "observed_mask")


def _batch(seed=0, B=3, L=12, Lp=6, C=3):
    rng = np.random.default_rng(seed)
    mask = (rng.random((B, L, C)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    return dict(tp_to_predict=np.sort(1 + rng.random((B, Lp)), 1).astype(np.float32),
                observed_data=(rng.standard_normal((B, L, C)) * mask).astype(np.float32),
                observed_tp=np.sort(rng.random((B, L)), 1).astype(np.float32),
                observed_mask=mask)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("name, width", [("BERT", 768), ("LLAMA", 4096)])
def test_timellm_forward_matches_jax(name, width, exact, monkeypatch):
    _shrink(monkeypatch, TL_BERT, TL_LLAMA)
    kw = dict(HP, llm_model_timellm=name, timellm_exact_prompt=exact)
    cfg, b = JConfig(**kw), _batch()
    extra, textra = {}, {}
    if exact:
        ids = jtimellm.build_timellm_prompt_ids(cfg, b, jloader.HashTokenizer(VOCAB),
                                                pad_to=cfg.timellm_prompt_len)
        extra, textra = {"prompt_ids": jnp.asarray(ids)}, {"prompt_ids": torch.from_numpy(ids)}
    jm = j_get_model(cfg)
    variables = np_tree(jax.jit(lambda k: jm.init(k, *(jnp.asarray(b[a]) for a in ARGS),
                                                  **extra))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}))
    want = np.asarray(jax.jit(lambda v: jm.apply(v, *(jnp.asarray(b[a]) for a in ARGS),
                                                 **extra))(variables))
    tm = get_model(TConfig(**kw))
    assert tm.d_llm == width and tm.frozen_llm.word_embedding_table().shape == (VOCAB, width)
    assert tm.mapping_layer.weight.shape == (64, VOCAB)
    consts = {k: v for k, v in variables.items() if k != "params"}
    tm.load_state_dict(params_from_jax({"model": variables["params"]}, {"model": consts})[0])
    with torch.no_grad():
        got = tm.eval()(*(torch.from_numpy(b[a]) for a in ARGS), **textra).numpy()
    assert got.shape == (3, 6, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name, exact", [("BERT", False), ("LLAMA", True)])
def test_timellm_trainable_matches_jax(name, exact, tmp_path, monkeypatch):
    _shrink(monkeypatch, TL_BERT, TL_LLAMA)
    got = trainable_matches_jax(
        tmp_path, dict(model="TimeLLM", llm_model_timellm=name, timellm_exact_prompt=exact,
                       input_token_len=4, d_model=16, d_ff=32, n_heads=2, ts_vocab_size=64,
                       top_k=1, llm_layers_timellm=1, timellm_prompt_len=48, epoch=1),
        data_kw=dict(n_entities=3, n_days=60), min_steps=2)
    assert len(got["history"]) == 1 and len(got["history"][0]["step_losses"]) == 2
