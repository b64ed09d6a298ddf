"""The port's Llama family against the JAX package's, on the CPU.

- `_rope` at positions 0-1023, head dim 128, under both families' θ
  (Llama 500000, DeepSeek 10000), to 1e-6: both take the angles in
  float32 as positions x 1/θ^(arange/Dh). The JAX side runs op by op:
  compiled whole, XLA rewrites the constant-base power and moves 18 of
  the 64 frequencies by one ulp, which moves the angles near position
  1024 by up to 1.9e-4 (a property of the reference's compiler, as
  large as the float64 route's gap; the model tests' 12 positions never
  reach it);
- RMSNorm with a moved scale, to 2e-5;
- LlamaBlock with grouped-query attention (4 heads over 2 KV heads: a KV
  head repeats in place, never tiled) and with MHA (4 over 4), under the
  causal mask alone and with key padding, and LlamaModel (all blocks and
  truncated to one) with `final_norm`, params carried by
  `convert.llama_params_from_jax`, to 2e-5;
- `convert_hf_llama` from a `transformers.LlamaModel` state dict: the
  port's forward equals the Hugging Face model's last hidden state to
  2e-5, and the JAX route (`convert_hf_llama`, then
  `llama_params_from_jax`) gives the same state dict exactly;
- Llama-3.1-8B and DeepSeek-7B at full size, built on the meta device:
  every parameter's name and shape equals the JAX tree's (taken by
  `jax.eval_shape`) through `convert.port_keys`, and their counts are
  7.50 B and 6.49 B (the published 8.03 B and 6.91 B count the LM head,
  which neither package builds: note embedding and TimeLLM read the last
  hidden state).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imm_tsf_tpu.llm import llama as jllama

from imm_tsf_torch import convert
from imm_tsf_torch.convert import llama_params_from_jax
from imm_tsf_torch.llm import llama

torch.set_num_threads(1)

ATOL = 2e-5
FAMILIES = {  # small configs with each family's head layout, θ and eps
    "gqa": dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, rope_theta=500000.0,
                rms_norm_eps=1e-5),
    "mha": dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=4, rope_theta=10000.0,
                rms_norm_eps=1e-6),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mask(B=3, T=12):
    mask = np.ones((B, T), bool)
    mask[0, 7:] = False  # right-padded
    mask[2, 3:] = False
    return mask


@pytest.mark.parametrize("theta", [500000.0, 10000.0])
def test_rope_matches_jax_at_long_positions(theta):
    x = np.random.default_rng(0).standard_normal((1, 2, 1024, 128)).astype(np.float32)
    pos = np.arange(1024)
    want = np.asarray(jllama._rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = llama._rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_rms_norm_matches_jax():
    x = (3 * np.random.default_rng(1).standard_normal((2, 5, 64))).astype(np.float32)
    jn = jllama.RMSNorm(1e-6)
    p = _np_tree(jn.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    p["scale"] = (1 + 0.2 * np.random.default_rng(2).standard_normal(64)).astype(np.float32)
    want = np.asarray(jn.apply({"params": p}, jnp.asarray(x)))
    tn = llama.RMSNorm(64, 1e-6)
    tn.load_state_dict(llama_params_from_jax(p))
    with torch.no_grad():
        got = tn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_llama_block_matches_jax(family, padded):
    cfg = jllama.LlamaConfig(**FAMILIES[family])
    jb = jllama.LlamaBlock(cfg)
    x = np.random.default_rng(3).standard_normal((3, 12, 64)).astype(np.float32)
    mask = _mask() if padded else None
    p = _np_tree(jb.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"])
    want = np.asarray(jax.jit(lambda p, x, m: jb.apply({"params": p}, x, attn_mask=m))(
        p, jnp.asarray(x), None if mask is None else jnp.asarray(mask)))
    tb = llama.LlamaBlock(llama.LlamaConfig(**FAMILIES[family]))
    tb.load_state_dict(llama_params_from_jax(p))
    with torch.no_grad():
        got = tb(torch.from_numpy(x),
                 attn_mask=None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_layers", [None, 1])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_llama_model_matches_jax(family, n_layers):
    cfg = jllama.LlamaConfig(**FAMILIES[family])
    jm = jllama.LlamaModel(cfg, n_layers=n_layers)
    ids = np.random.default_rng(5).integers(0, 256, (3, 12)).astype(np.int32)
    mask = _mask()
    p = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(6), jnp.zeros((1, 8), jnp.int32))["params"])
    want = np.asarray(jax.jit(lambda p, i, m: jm.apply({"params": p}, i, attn_mask=m))(
        p, jnp.asarray(ids), jnp.asarray(mask)))
    tm = llama.LlamaModel(llama.LlamaConfig(**FAMILIES[family]), n_layers=n_layers).eval()
    tm.load_state_dict(llama_params_from_jax(p))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), attn_mask=torch.from_numpy(mask)).numpy()
    assert len(tm.layers) == (1 if n_layers else 2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_convert_hf_llama_matches_transformers_and_jax_route(family):
    transformers = pytest.importorskip("transformers")
    kw = FAMILIES[family]
    hf_cfg = transformers.LlamaConfig(**kw, max_position_embeddings=64, attention_bias=False,
                                      mlp_bias=False, attn_implementation="eager")
    torch.manual_seed(7)
    hf = transformers.LlamaModel(hf_cfg).eval()
    with torch.no_grad():  # the norms away from identity, so a swapped pair shows
        for name, p in hf.named_parameters():
            if "norm" in name:
                p.add_(0.2 * torch.randn(p.shape))
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    ids = np.random.default_rng(8).integers(0, 256, (3, 12))
    mask = _mask()
    tm = llama.LlamaModel(llama.LlamaConfig(**kw)).eval()
    state = llama.convert_hf_llama(sd)
    tm.load_state_dict(state)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids),
                  attention_mask=torch.from_numpy(mask).long()).last_hidden_state.numpy()
        got = tm(torch.from_numpy(ids), attn_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    jax_route = llama_params_from_jax(
        jllama.convert_hf_llama({k: v.numpy() for k, v in sd.items()}))
    assert jax_route.keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(v, jax_route[k]), k


@pytest.mark.parametrize("alias, billions", [("Llama", 7.50), ("DeepSeek", 6.49)])
def test_full_size_parameters_match_jax_tree(alias, billions):
    jm = jllama.LlamaModel(jllama.LLAMA_SIZES[alias])
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    shapes = jax.tree_util.tree_map(lambda s: s.shape, shapes["params"],
                                    is_leaf=lambda s: isinstance(s, jax.ShapeDtypeStruct))
    leaves = dict(convert._flatten(shapes, ""))
    want = {}
    for path, (key, transposed) in convert.port_keys(shapes, convert._LAYERS_RENAMES).items():
        want[key] = tuple(leaves[path])[::-1] if transposed else tuple(leaves[path])
    cfg = llama.LLAMA_SIZES[alias]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jllama.LLAMA_SIZES[alias])
    with torch.device("meta"):
        tm = llama.LlamaModel(cfg)
    got = {k: tuple(v.shape) for k, v in tm.named_parameters()}
    assert got == want
    assert round(sum(np.prod(s) for s in got.values()) / 1e9, 2) == billions
