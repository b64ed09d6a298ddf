"""The frozen LLM over a ("data", "model") mesh (llm/loader.make_llm_mesh,
resolve_llm_mesh, shard_llm_params, embed_notes(mesh=...); llm/llama.
LlamaShards) against the JAX package's sharded LLM, on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices; the port's
mesh is 8 copies of the CPU (`devices`, the test hook), driven by one
process. JAX's tiny Llama (tests/test_llm_sharded.py:17-35) is carried
across by `convert.llama_params_from_jax`:

- the shards are genuinely split: each holds I / tp gate and up rows (the
  JAX kernels' columns), its heads' q, k, v rows and I / tp down and H·Dh
  / tp o columns, equal to the JAX shards of the same slice; the token
  table is replicated (each data group's first device holds it whole);
- the port's sharded embed_notes matches the JAX package's sharded
  embed_notes on its 2x4 and 4x2 meshes, bucketed and not (token_batch
  3), within rtol 2e-5 and atol 2e-6 (tests/test_llm_sharded.py), masks
  and processed tokens equal; bfloat16 shards equal the unsharded
  bfloat16 model's embedding;
- GPT-2 over two data groups (one whole copy a group) matches no mesh;
- all-empty notes give the zero fallback row;
- the resolve_llm_mesh table of tests/test_llm_sharded.py:99-107 with n
  given, against the JAX rules; clipping to the device count; a width
  that does not divide the KV heads is refused;
- trainable with llm_tp=4 matches llm_tp=1 within rtol 5e-4 on the JAX
  test's flags (tests/test_llm_sharded.py:110-126); the raw-text path
  itself is held to the JAX package by tests/test_torch_raw_text_training.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imm_tsf_tpu.llm import loader as jloader
from imm_tsf_tpu.llm.llama import LlamaConfig as JLlamaConfig, LlamaModel as JLlamaModel

from imm_tsf_torch.config import Config
from imm_tsf_torch.convert import llama_params_from_jax
from imm_tsf_torch.llm import gpt2, llama, loader
from imm_tsf_torch.training.trainer import make_loader_wrappers, trainable

torch.set_num_threads(1)

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4)
NOTES = [
    ["sensor spike at noon", "maintenance window opened", "all clear"],
    [],  # empty-notes sample (the canonical reference fixture)
    ["pressure drift observed in unit seven over several hours"],
]
CPUS = [torch.device("cpu")] * 8
TOL = dict(rtol=2e-5, atol=2e-6)


@pytest.fixture(scope="module")
def tiny():
    """JAX's tiny Llama (its host params) and the port's, the same weights."""
    jm = JLlamaModel(JLlamaConfig(**TINY))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x.unbox()) if hasattr(x, "unbox") else np.asarray(x),
        variables["params"], is_leaf=lambda x: hasattr(x, "unbox"))
    tm = llama.LlamaModel(llama.LlamaConfig(**TINY))
    tm.load_state_dict(llama_params_from_jax(params))
    return jm, params, tm.eval().requires_grad_(False)


def test_shards_are_genuinely_split_as_the_jax_shards(tiny):
    jm, params, tm = tiny
    tp = 4
    mesh = loader.make_llm_mesh(tp, devices=CPUS)
    assert mesh.shape == {"data": 2, "model": 4}
    jmesh = jloader.make_llm_mesh(tp=tp)
    assert dict(jmesh.shape) == mesh.shape
    jshards = jloader.shard_llm_params(jm, params, jmesh)
    groups = loader.shard_llm_params(tm, mesh)
    I, E = TINY["intermediate_size"], TINY["hidden_size"]
    for g in groups:
        assert torch.equal(g.word_embedding_table(), tm.embed_tokens.weight)  # replicated
        for layer, (_, _, shards) in enumerate(g.layers):
            assert [s["gate_proj"].shape for s in shards] == [(I // tp, E)] * tp
            assert [s["up_proj"].shape for s in shards] == [(I // tp, E)] * tp
            assert [s["q_proj"].shape for s in shards] == [(E // tp, E)] * tp
            assert [s["down_proj"].shape for s in shards] == [(E, I // tp)] * tp
            assert [s["o_proj"].shape for s in shards] == [(E, E // tp)] * tp
            # each JAX shard of a kernel is the port's shard of the same slice
            for name in ("gate_proj", "down_proj", "k_proj", "o_proj"):
                kernel = jshards[f"layer_{layer}"][name]["kernel"]
                col = name in ("o_proj", "down_proj")  # ("model", None): input rows
                for js in kernel.addressable_shards:
                    cut = js.index[0 if col else 1]
                    n = kernel.shape[0 if col else 1]
                    s = cut.start // (n // tp)
                    np.testing.assert_array_equal(shards[s][name].numpy().T, np.asarray(js.data))
    # on the model's own device a shard is a view of the model's weight
    w = tm.layers[0].gate_proj.weight
    assert groups[1].layers[0][2][1]["gate_proj"].data_ptr() == w[I // tp:].data_ptr()


@pytest.mark.parametrize("bucketed", [True, False], ids=["bucketed", "max_length"])
@pytest.mark.parametrize("tp", [4, 2], ids=["2x4", "4x2"])
def test_sharded_embed_notes_matches_the_jax_sharded_embed_notes(tiny, tp, bucketed):
    jm, params, tm = tiny
    kw = dict(max_length=64, bucketed=bucketed)
    if not bucketed:
        kw["token_batch"] = 3  # dp 2 and 4: rows padded to multiples of the data groups
    j_stats, t_stats = {}, {}
    want, want_mask = jloader.embed_notes(NOTES, jm, params, jloader.HashTokenizer(256),
                                          mesh=jloader.make_llm_mesh(tp=tp),
                                          stats_out=j_stats, **kw)
    got, got_mask = loader.embed_notes(NOTES, tm, loader.HashTokenizer(256),
                                       mesh=loader.make_llm_mesh(tp, devices=CPUS),
                                       stats_out=t_stats, **kw)
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert t_stats == j_stats
    # and the unsharded port within the same tolerance
    ref, _ = loader.embed_notes(NOTES, tm, loader.HashTokenizer(256), **kw)
    np.testing.assert_allclose(got, ref, **TOL)


def test_bfloat16_shards_equal_the_unsharded_bfloat16_model(tiny):
    """Each shard casts its own weights; the row-split terms are summed in
    float32 and rounded once, so the sharded bfloat16 embedding equals the
    bfloat16 model's."""
    _, _, tm = tiny
    mesh = loader.make_llm_mesh(2, devices=CPUS)
    got, _ = loader.embed_notes(NOTES, tm, loader.HashTokenizer(256), max_length=64,
                                mesh=mesh, compute_dtype=torch.bfloat16)
    want, _ = loader.embed_notes(NOTES, tm, loader.HashTokenizer(256), max_length=64,
                                 compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got, want)
    g = loader.shard_llm_params(tm, mesh, torch.bfloat16)[0]
    assert {s["gate_proj"].dtype for s in g.layers[0][2]} == {torch.bfloat16}
    assert tm.layers[0].gate_proj.weight.dtype == torch.float32  # the model is not cast


def test_gpt2_on_two_data_groups_matches_no_mesh():
    cfg = gpt2.GPT2Config(vocab_size=256, n_positions=64, n_embd=32, n_layer=2, n_head=2)
    with torch.device("meta"):
        model = gpt2.GPT2Model(cfg, use_fused_attn=True)
    model = model.to_empty(device="cpu")
    loader._flax_init_(model, torch.Generator().manual_seed(0))
    model.eval().requires_grad_(False)
    mesh = loader.make_llm_mesh(1, devices=CPUS[:2])
    assert mesh.shape == {"data": 2, "model": 1}
    assert loader.shard_llm_params(model, mesh) == [model, model]  # whole, one a group
    got, mask = loader.embed_notes(NOTES, model, loader.HashTokenizer(256), max_length=64,
                                   mesh=mesh)
    want, want_mask = loader.embed_notes(NOTES, model, loader.HashTokenizer(256),
                                         max_length=64)
    np.testing.assert_array_equal(mask, want_mask)
    np.testing.assert_allclose(got, want, **TOL)


def test_all_empty_notes_give_the_zero_fallback_row(tiny):
    _, _, tm = tiny
    emb, mask = loader.embed_notes([[], []], tm, loader.HashTokenizer(256), max_length=64,
                                   mesh=loader.make_llm_mesh(2, devices=CPUS))
    assert emb.shape == (2, 1, 64) and not mask.any() and (emb == 0).all()


def test_resolve_llm_mesh_table_with_n_given():
    """tests/test_llm_sharded.py:99-107 with the 8 devices given, against
    the JAX rules on its 8 devices."""
    def shape(m):
        return None if m is None else dict(m.shape)

    for alias, tp in (("GPT2", 1), ("GPT2", 0), ("Llama", 0), ("DeepSeek", 4), ("Llama", 2),
                      ("BERT", 2), ("Llama", 16)):
        want = shape(jloader.resolve_llm_mesh(alias, tp))
        assert shape(loader.resolve_llm_mesh(alias, tp, devices=CPUS)) == want, (alias, tp)
    assert shape(loader.resolve_llm_mesh("Llama", 0, devices=CPUS)) == {"data": 1, "model": 8}
    assert shape(loader.resolve_llm_mesh("DeepSeek", 4, devices=CPUS)) == {"data": 2,
                                                                             "model": 4}
    # one device: every width clips to 1 (a card of a data mesh's rank)
    assert loader.resolve_llm_mesh("Llama", 2, devices=CPUS[:1]) is None
    assert loader.resolve_llm_mesh("Llama", 0, devices=CPUS[:1]) is None
    # the CPU's own count: llm_tp copies of it
    assert loader.llm_devices("cpu", 4) == CPUS[:4]
    assert shape(loader.resolve_llm_mesh("GPT2", 4, device="cpu")) == {"data": 1, "model": 4}
    with pytest.raises(ValueError, match="must divide device count 8"):
        loader.make_llm_mesh(3, devices=CPUS)


def test_a_width_that_does_not_divide_the_kv_heads_is_refused():
    cfg = llama.LlamaConfig(**dict(TINY, num_key_value_heads=2))
    tm = llama.LlamaModel(cfg).eval().requires_grad_(False)
    with pytest.raises(ValueError, match="llm_tp=4 does not divide the model's 2 KV heads"):
        loader.shard_llm_params(tm, loader.make_llm_mesh(4, devices=CPUS))
    # Llama-3.1-8B's 8 KV heads, before any weight is loaded
    with pytest.raises(ValueError, match="llm_tp=16 does not divide the model's 8 KV heads"):
        loader.resolve_llm_mesh("Llama", 16, devices=CPUS * 2)


def test_trainable_llm_tp_4_matches_llm_tp_1(synth_root):
    """The production trainable on raw text with cfg.llm_tp=4 (the frozen
    GPT-2 over 4 copies of the CPU, one data group) against llm_tp=1, on
    the JAX test's flags (tests/test_llm_sharded.py:110-126), rtol 5e-4."""
    base = dict(
        dataset="EPA-Air", data_root=synth_root, model="DLinear", enable_text=True,
        use_text_embeddings=False, llm_model_fusion="GPT2", llm_layers_fusion=1,
        max_length=32, batch_size=8, epoch=2, patience=2, seed=1, TTF_module="TTF_RecAvg",
        MMF_module="MMF_GR_Add", device_loop=False, host_prefetch=0)
    stage = make_loader_wrappers(Config(**base, llm_tp=4), "cpu")[0]([])
    assert stage.llm_mesh.shape == {"data": 1, "model": 4}
    r1 = trainable(Config(**base, llm_tp=1), device="cpu")
    r2 = trainable(Config(**base, llm_tp=4), device="cpu")
    for k in ("mse", "mae"):
        np.testing.assert_allclose(r2[k], r1[k], rtol=5e-4)
    assert r2["best_iter"] == r1["best_iter"]
