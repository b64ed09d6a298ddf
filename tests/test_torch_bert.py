"""The port's BERT against the JAX package's, on the CPU.

A small BERT (64 wide, 4 heads, 2 layers, vocab 256) carries its flax
params into the port with `convert.bert_params_from_jax`:

- BertLayer and BertModel (all layers and truncated to one) under a key
  padding mask with one fully padded row (the safe softmax gives that
  row's attention zeros on both sides), to 2e-5;
- `convert_hf_bert` from a `transformers.BertModel` state dict (random
  init, LayerNorms moved off identity): the port's forward equals the
  Hugging Face model's last hidden state to 2e-5 on rows with a real
  token (a fully padded row attends uniformly there, to zeros here), and
  its state dict equals the JAX route's (JAX `convert_hf_bert`, then
  `bert_params_from_jax`) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imm_tsf_tpu.llm import bert as jbert

from imm_tsf_torch.convert import bert_params_from_jax
from imm_tsf_torch.llm import bert

torch.set_num_threads(1)

ATOL = 2e-5
SMALL = dict(vocab_size=256, max_position_embeddings=64, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ids_and_mask(B=3, T=20, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (B, T)).astype(np.int32)
    mask = np.ones((B, T), bool)
    mask[0, 13:] = False  # right-padded
    mask[2] = False  # every token padded
    return ids, mask


@pytest.fixture(scope="module")
def jax_model():
    m = jbert.BertModel(jbert.BertConfig(**SMALL))
    p = jax.jit(m.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return m, _np_tree(p)


def test_bert_layer_matches_jax():
    cfg = jbert.BertConfig(**SMALL)
    jl = jbert.BertLayer(cfg)
    x = np.random.default_rng(2).standard_normal((3, 20, 64)).astype(np.float32)
    _, mask = _ids_and_mask()
    p = _np_tree(jl.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want = np.asarray(jax.jit(lambda p, x, m: jl.apply({"params": p}, x, attn_mask=m))(
        p, jnp.asarray(x), jnp.asarray(mask)))
    tl = bert.BertLayer(bert.BertConfig(**SMALL))
    tl.load_state_dict(bert_params_from_jax(p))
    with torch.no_grad():
        got = tl(torch.from_numpy(x), attn_mask=torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_layers", [None, 1])
def test_bert_model_matches_jax(jax_model, n_layers):
    _, p = jax_model
    ids, mask = _ids_and_mask()
    jm = jbert.BertModel(jbert.BertConfig(**SMALL), n_layers=n_layers)
    jp = {k: v for k, v in p.items() if n_layers is None or k != "layer_1"}
    want = np.asarray(jax.jit(lambda p, i, m: jm.apply({"params": p}, i, attn_mask=m))(
        jp, jnp.asarray(ids), jnp.asarray(mask)))
    tm = bert.BertModel(bert.BertConfig(**SMALL), n_layers=n_layers).eval()
    tm.load_state_dict(bert_params_from_jax(jp))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), attn_mask=torch.from_numpy(mask)).numpy()
        embeds = tm(inputs_embeds=tm.get_input_embeddings(torch.from_numpy(ids).long()),
                    attn_mask=torch.from_numpy(mask)).numpy()
    assert len(tm.layers) == (1 if n_layers else 2)
    assert tm.word_embedding_table().shape == (256, 64)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(embeds, got)


def _hf_bert():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.BertConfig(**SMALL, hidden_act="gelu", layer_norm_eps=1e-12,
                                     hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                                     attn_implementation="eager")
    torch.manual_seed(3)
    hf = transformers.BertModel(hf_cfg).eval()
    with torch.no_grad():  # LayerNorms away from identity, so a swapped pair shows
        for name, p in hf.named_parameters():
            if "LayerNorm" in name:
                p.add_(0.1 * torch.randn(p.shape))
    return hf


def test_convert_hf_bert_matches_transformers_and_jax_route():
    hf = _hf_bert()
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    ids, mask = _ids_and_mask(seed=4)
    tm = bert.BertModel(bert.BertConfig(**SMALL)).eval()
    state = bert.convert_hf_bert(sd)
    tm.load_state_dict(state)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids).long(),
                  attention_mask=torch.from_numpy(mask).long()).last_hidden_state.numpy()
        got = tm(torch.from_numpy(ids).long(), attn_mask=torch.from_numpy(mask)).numpy()
    real = mask.any(axis=1)
    np.testing.assert_allclose(got[real], want[real], atol=ATOL, rtol=0)
    assert (got[~real] != 0).any()  # a padded row still passes the LayerNorms

    jax_route = bert_params_from_jax(jbert.convert_hf_bert({k: v.numpy() for k, v in sd.items()}))
    assert jax_route.keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(v, jax_route[k]), k
    one = bert.convert_hf_bert(sd, n_layers=1)
    assert sorted({k.split(".")[1] for k in one if k.startswith("layers.")}) == ["0"]
