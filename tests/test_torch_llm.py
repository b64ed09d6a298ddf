"""The port's frozen-LLM path against the JAX package, on the CPU.

- GPT2Block / GPT2Model with params carried by convert.gpt2_params_from_jax,
  and convert_hf_gpt2 from one Hugging Face-layout state dict: 2e-5
  (float32, torch vs XLA summation order; the JAX side runs its einsum
  path, as it does off the TPU).
- HashTokenizer ids and masks: identical.
- embed_notes, bucketed and not: 2e-5, with equal stats_out.
- The slice as a whole: a raw-text PatchTST + TTF_RecAvg + MMF_GR_Add
  experiment served by the JAX ForecastService and by the port's
  ForecastService(device="cpu") from one local 2-layer GPT-2 checkpoint
  (IMM_TSF_LLM_DIR, hash tokenizer): answers to 1e-4, as for the
  precomputed-embedding service (tests/test_torch_serving.py); at the
  initial MMF_GR_Add bias, float64 shows the larger gap there to be the
  reference's own float32 LayerNorm over 3 channels, not the port.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imm_tsf_tpu.llm import gpt2 as jgpt2
from imm_tsf_tpu.llm import loader as jloader

from imm_tsf_torch.convert import gpt2_params_from_jax, params_from_jax
from imm_tsf_torch.kernels import attn
from imm_tsf_torch.llm import gpt2, loader

torch.set_num_threads(1)

ATOL = 2e-5
SMALL = dict(vocab_size=256, n_positions=64, n_embd=64, n_layer=2, n_head=4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _small_jax_model(seed=0):
    m = jgpt2.GPT2Model(jgpt2.GPT2Config(**SMALL))
    p = m.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return m, _np_tree(p)


def _small_port_model(params, n_layers=None, fused=False):
    m = gpt2.GPT2Model(gpt2.GPT2Config(**SMALL), n_layers=n_layers, use_fused_attn=fused)
    m.load_state_dict(gpt2_params_from_jax(params))
    return m.eval()


def _ids_and_mask(B=3, T=20, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (B, T)).astype(np.int32)
    mask = np.ones((B, T), bool)
    mask[0, 13:] = False  # right-padded
    mask[2, 5:] = False
    return ids, mask


@pytest.mark.parametrize("fused", [False, True])
def test_gpt2_block_matches_jax(fused):
    cfg = jgpt2.GPT2Config(**SMALL)
    jb = jgpt2.GPT2Block(cfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 20, 64)).astype(np.float32)
    _, mask = _ids_and_mask()
    p = _np_tree(jb.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want = np.asarray(jb.apply({"params": p}, jnp.asarray(x), attn_mask=jnp.asarray(mask)))
    tb = gpt2.GPT2Block(gpt2.GPT2Config(**SMALL), use_fused_attn=fused)
    tb.load_state_dict(gpt2_params_from_jax(p))
    with torch.no_grad():
        got = tb(torch.from_numpy(x), attn_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_layers", [None, 1])
def test_gpt2_model_matches_jax(n_layers):
    _, p = _small_jax_model()
    ids, mask = _ids_and_mask()
    jm = jgpt2.GPT2Model(jgpt2.GPT2Config(**SMALL), n_layers=n_layers)
    jp = {k: v for k, v in p.items() if n_layers is None or k != "h_1"}
    want = np.asarray(jm.apply({"params": jp}, jnp.asarray(ids), attn_mask=jnp.asarray(mask)))
    tm = gpt2.GPT2Model(gpt2.GPT2Config(**SMALL), n_layers=n_layers).eval()
    tm.load_state_dict(gpt2_params_from_jax(jp))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), attn_mask=torch.from_numpy(mask)).numpy()
    assert len(tm.h) == (1 if n_layers else 2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _hf_state_dict(cfg: dict, n_layer: int, seed=0) -> dict:
    """A Hugging Face GPT2Model state dict (Conv1D weights [in, out]) at
    flax's init scales, from numpy."""
    rng = np.random.default_rng(seed)
    E, V, P = cfg["n_embd"], cfg["vocab_size"], cfg["n_positions"]
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    sd = {"wte.weight": f(V, E, std=E ** -0.5), "wpe.weight": f(P, E, std=E ** -0.5),
          "ln_f.weight": 1 + f(E, std=0.1), "ln_f.bias": f(E, std=0.1)}
    for i in range(n_layer):
        for ln in ("ln_1", "ln_2"):
            sd[f"h.{i}.{ln}.weight"] = 1 + f(E, std=0.1)
            sd[f"h.{i}.{ln}.bias"] = f(E, std=0.1)
        for name, (n_in, n_out) in {"attn.c_attn": (E, 3 * E), "attn.c_proj": (E, E),
                                    "mlp.c_fc": (E, 4 * E), "mlp.c_proj": (4 * E, E)}.items():
            sd[f"h.{i}.{name}.weight"] = f(n_in, n_out, std=n_in ** -0.5)
            sd[f"h.{i}.{name}.bias"] = f(n_out, std=0.02)
        sd[f"h.{i}.attn.bias"] = np.tril(np.ones((P, P), np.float32))  # HF's mask buffer
    return sd


@pytest.mark.parametrize("n_layers", [None, 1])
def test_convert_hf_gpt2_matches_jax_route(n_layers):
    sd = _hf_state_dict(SMALL, 2)
    ids, mask = _ids_and_mask(seed=4)
    jm = jgpt2.GPT2Model(jgpt2.GPT2Config(**SMALL), n_layers=n_layers)
    jp = jgpt2.convert_hf_gpt2(sd, n_layers)
    want = np.asarray(jm.apply({"params": jp}, jnp.asarray(ids), attn_mask=jnp.asarray(mask)))
    tm = gpt2.GPT2Model(gpt2.GPT2Config(**SMALL), n_layers=n_layers).eval()
    tm.load_state_dict(gpt2.convert_hf_gpt2({k: torch.from_numpy(v) for k, v in sd.items()},
                                            n_layers))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), attn_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _notes(max_words=80, seed=5):
    """Ragged notes: repeated strings, "", one note longer than 64 words,
    and a sample with no notes."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(40)] + ["pressure", "ozone", "the", "fell"]

    def note(n):
        return " ".join(rng.choice(words, n))

    return [[note(3), "", note(30), note(max_words)],
            [],
            [note(1), "same note again", "same note again"],
            [note(45), note(70), "", note(10), note(33)]]


def test_hash_tokenizer_matches_jax():
    texts = [n for seq in _notes() for n in seq] + ["", "  ", "a " * 100]
    for vocab, max_length in ((256, 64), (50257, 16)):
        j_ids, j_mask = jloader.HashTokenizer(vocab)(texts, max_length=max_length)
        t_ids, t_mask = loader.HashTokenizer(vocab)(texts, max_length=max_length)
        np.testing.assert_array_equal(t_ids, j_ids)
        np.testing.assert_array_equal(t_mask, j_mask)
        assert t_ids.dtype == j_ids.dtype and t_mask.dtype == j_mask.dtype


@pytest.mark.parametrize("bucketed", [True, False])
def test_embed_notes_matches_jax(bucketed):
    jm, p = _small_jax_model(seed=3)
    notes = _notes()
    kw = dict(max_length=64, bucketed=bucketed, token_batch=4, token_budget=128)
    j_stats, t_stats = {}, {}
    want, want_mask = jloader.embed_notes(notes, jm, p, jloader.HashTokenizer(256),
                                          stats_out=j_stats, **kw)
    tm = _small_port_model(p, fused=True)  # CPU tensors: the plain attention
    got, got_mask = loader.embed_notes(notes, tm, loader.HashTokenizer(256),
                                       stats_out=t_stats, **kw)
    assert got.dtype == np.float32 and got.shape == want.shape == (4, 5, 64)
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    assert t_stats == j_stats
    assert (got[1] == 0).all() and (got[0, 1] == 0).all()  # no notes; an empty note


def test_embed_notes_every_note_empty_and_mesh_refused():
    _, p = _small_jax_model()
    tm = _small_port_model(p)
    emb, mask = loader.embed_notes([["", ""], []], tm, loader.HashTokenizer(256),
                                   max_length=64)
    assert emb.shape == (2, 2, 64) and (emb == 0).all()
    assert mask.tolist() == [[True, True], [False, False]]
    # through an LLM mesh (two data groups of two copies of the CPU) too
    mesh = loader.make_llm_mesh(2, devices=["cpu"] * 4)
    emb, mask = loader.embed_notes([[], []], tm, loader.HashTokenizer(256), max_length=64,
                                   mesh=mesh)
    assert emb.shape == (2, 1, 64) and (emb == 0).all() and not mask.any()
    with pytest.raises(TypeError, match="LlmMesh"):
        loader.embed_notes([["a"]], tm, loader.HashTokenizer(256), mesh=object())


def test_load_llm_defaults_to_cuda_and_refuses_unported():
    """Every alias builds (BERT here: 768 wide, frozen, on the CPU when
    asked); an unknown alias is refused; resolve_llm_mesh reads the cards
    (cuda by default) unless llm_tp is 1."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loader.load_llm("GPT2", 1)
    model, _ = loader.load_llm("BERT", 1, device="cpu")
    assert model.word_embedding_table().shape == (30522, 768) and len(model.layers) == 1
    assert not any(p.requires_grad for p in model.parameters()) and not model.training
    with pytest.raises(ValueError, match="Unknown LLM alias"):
        loader.load_llm("T5", 1, device="cpu")
    assert loader.resolve_llm_mesh("Llama", 0, device="cpu") is None
    assert loader.resolve_llm_mesh("BERT", 1) is None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loader.resolve_llm_mesh("Llama", 2)
    assert loader.get_d_model("GPT2M") == jloader.get_d_model("GPT2M") == 1024
    assert loader.D_MODEL == jloader.D_MODEL and loader.ALIAS == jloader.ALIAS
    assert all(loader.get_context_window_size(a) == jloader.get_context_window_size(a)
               for a in loader.ALIAS)


def test_load_llm_random_init_matches_flax_scales(monkeypatch):
    """No local checkpoint: a seeded GPT-2 at the flax initializers' scales."""
    monkeypatch.delenv("IMM_TSF_LLM_DIR", raising=False)
    model, tok = loader.load_llm("GPT2", 1, device="cpu", use_fused_attn=True,
                                 generator=torch.Generator().manual_seed(7))
    again, _ = loader.load_llm("GPT2", 1, device="cpu",
                               generator=torch.Generator().manual_seed(7))
    assert isinstance(tok, loader.HashTokenizer) and tok.vocab_size == 50257
    assert len(model.h) == 1 and model.h[0].use_fused_attn
    assert not any(q.requires_grad for q in model.parameters())
    torch.testing.assert_close(model.h[0].c_fc.weight, again.h[0].c_fc.weight, rtol=0, atol=0)
    E = 768
    np.testing.assert_allclose(float(model.wte.weight.std()), E ** -0.5, rtol=0.01)
    w = model.h[0].c_fc.weight  # [4E, E]: fan_in E, lecun normal truncated at 2 sigma
    np.testing.assert_allclose(float(w.std()), E ** -0.5, rtol=0.01)
    assert float(w.abs().max()) <= 2 * E ** -0.5 / 0.87962566103423978 + 1e-6
    assert float(model.h[0].c_fc.bias.abs().max()) == 0.0


# ------------------------------------------------------ the slice as a whole
D_IN = 3
CFG_KW = dict(
    model="PatchTST", dataset="EPA-Air", history=7, pred_window=7, stride=7,
    time_unit="days", e_layers=2, d_model=32, d_ff=64, n_heads=2,
    input_dim=D_IN, input_len=16, pred_len=8, enable_text=True,
    use_text_embeddings=False, TTF_module="TTF_RecAvg", MMF_module="MMF_GR_Add",
    llm_model_fusion="GPT2", llm_layers_fusion=2, d_txt=768, recency_sigma=2.0,
    use_fused_ffn=True, use_fused_attn=True,
)


@pytest.fixture(scope="module")
def raw_text_experiments(tmp_path_factory):
    """(llm_root, {"default" | "spread": (jax_dir, port_dir)}): one 2-layer
    full-width GPT-2 as a local HF checkpoint, and one raw-text experiment
    in both formats, at MMF_GR_Add's initial residual_head bias and at a
    spread one."""
    from imm_tsf_tpu.config import Config as JConfig
    from imm_tsf_tpu.data import collate as C
    from imm_tsf_tpu.data.dataset import Chunk
    from imm_tsf_tpu.fusion.fusion_model import FusionModel
    from imm_tsf_tpu.models import get_model
    from imm_tsf_tpu.training.checkpoint import save_checkpoint
    from imm_tsf_tpu.training.trainer import init_state

    from imm_tsf_torch.config import load_saved_config
    from imm_tsf_torch.training.checkpoint import save_experiment

    root = tmp_path_factory.mktemp("raw_text")
    llm_root = root / "llm"
    os.makedirs(llm_root / "GPT2")
    sd = _hf_state_dict(dict(vocab_size=50257, n_positions=1024, n_embd=768), 2, seed=11)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               llm_root / "GPT2" / "pytorch_model.bin")

    cfg = JConfig(**CFG_KW)
    chunk = Chunk("warm_chunk0", np.asarray([0.0, 1.0, 8.0], np.float32),
                  np.zeros((3, D_IN), np.float32), np.ones((3, D_IN), np.float32),
                  np.asarray([0.5], np.float32), [np.ones(768, np.float32)])
    batch = C.add_multimodal(
        C.standard_collate([chunk], 7.0, 14.0, cfg.input_len, cfg.pred_len),
        [chunk], True, True, 1, 768)
    params, stats = init_state(cfg, get_model(cfg), FusionModel(cfg), batch,
                               jax.random.PRNGKey(5))
    params["fusion"]["ttf"]["log_recency_sigma"] = np.float32(np.log(1.7))
    dirs = {}
    # MMF_GR_Add normalises its residual over the C=3 channels: where the
    # three nearly coincide, that LayerNorm scales float32 rounding up by as
    # much as 1/sqrt(eps) ~ 316. A spread bias keeps the channels apart, so
    # the answers' comparison measures the port and not that conditioning;
    # test_default_bias_gap_is_layernorm_conditioning shows the cause.
    for name, bias in (("default", None), ("spread", [-3.0, 0.0, 3.0])):
        if bias is not None:
            params["fusion"]["mmf"]["residual_head"]["bias"] = np.asarray(bias, np.float32)
        jdir, tdir = str(root / f"jax_{name}"), str(root / f"port_{name}")
        os.makedirs(jdir)
        with open(os.path.join(jdir, "config.json"), "w") as f:
            f.write(cfg.to_json())
        save_checkpoint(os.path.join(jdir, "best"), params, stats, 0)
        mstate, fstate = params_from_jax(_np_tree(params))
        save_experiment(tdir, load_saved_config(os.path.join(jdir, "config.json")),
                        mstate, fstate, step=0)
        dirs[name] = (jdir, tdir)
    return str(llm_root), dirs


def _text_requests(seed, k):
    """Ragged requests with 0-6 text notes: repeated strings, "", notes
    long enough for the 64- and 128-token buckets."""
    rng = np.random.default_rng(seed)
    pool = [" ".join(f"t{int(w)}" for w in rng.integers(0, 300, n))
            for n in (1, 4, 9, 20, 31, 40, 70, 100)] + ["", "ozone rising at the coast"]
    out = []
    for i in range(k):
        n = int(rng.integers(0, 17))
        m = int(rng.integers(1, 9))
        tt = np.sort(rng.choice(np.linspace(0, 6.99, 60), n, replace=False))
        vals = rng.standard_normal((n, D_IN))
        vals[rng.random(vals.shape) < 0.2] = np.nan
        tp = np.sort(rng.choice(np.linspace(7.0, 14.0, 30), m, replace=False))
        n_notes = 0 if i % 4 == 1 else int(rng.integers(1, 7))
        inst = {"observed_tp": tt.tolist(), "observed_data": vals.tolist(),
                "tp_to_predict": tp.tolist(),
                "notes": [{"tau": float(rng.uniform(0, 7)),
                           "text": pool[int(rng.integers(0, len(pool)))]}
                          for _ in range(n_notes)]}
        if i % 3 == 0:
            inst["mean"] = rng.standard_normal(D_IN).tolist()
            inst["std"] = (0.5 + rng.random(D_IN)).tolist()
        out.append(inst)
    return out


def test_raw_text_service_matches_jax(raw_text_experiments, monkeypatch):
    from imm_tsf_tpu.serving import ForecastService as JForecastService

    from imm_tsf_torch.serving import ForecastService

    llm_root, dirs = raw_text_experiments
    jdir, tdir = dirs["spread"]
    monkeypatch.setenv("IMM_TSF_LLM_DIR", llm_root)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    insts = _text_requests(0, 12)
    jsvc = JForecastService(jdir, max_batch=4, max_wait_ms=20.0)
    try:
        want = [f.result(timeout=600) for f in [jsvc.submit(i) for i in insts]]
    finally:
        jsvc.close()
    before = attn.launches
    tsvc = ForecastService(tdir, max_batch=4, max_wait_ms=20.0, device="cpu")
    try:
        got = [f.result(timeout=600) for f in [tsvc.submit(i) for i in insts]]
        stage = tsvc._stage_top
        assert isinstance(stage.tokenizer, loader.HashTokenizer)
        assert len(stage.llm.h) == 2 and stage.llm.h[0].use_fused_attn
        n_calls = stage.llm_calls
        serial = [tsvc.forecast([i])[0] for i in insts[:3]]
        assert stage.llm_calls == n_calls  # every string is cached by now
        bad = dict(insts[0], notes=[{"tau": 0.0, "embedding": [0.0] * 768}])
        with pytest.raises(ValueError, match="embeds raw text"):
            tsvc.submit(bad)
    finally:
        tsvc.close()
    assert attn.launches == before  # CPU tensors: the plain attention
    for inst, g, w in zip(insts, got, want):
        assert g["tp"] == w["tp"]
        ga, wa = np.asarray(g["prediction"]), np.asarray(w["prediction"])
        assert ga.shape == (len(inst["tp_to_predict"]), D_IN) and np.isfinite(ga).all()
        np.testing.assert_allclose(ga, wa, atol=1e-4, rtol=1e-4)
    for g, s in zip(got[:3], serial):
        np.testing.assert_allclose(g["prediction"], s["prediction"], atol=1e-5, rtol=1e-5)


def _mmf_tail64(delta_y, gate_logits, Y, M):
    """MMF_GR_Add after its residual head, in float64 (initial LayerNorm:
    scale 1, bias 0)."""
    d = delta_y.astype(np.float64) - delta_y.mean(-1, keepdims=True, dtype=np.float64)
    ln = d / np.sqrt((d * d).mean(-1, keepdims=True) + 1e-5)
    g = np.where(M[:, :, None], 1.0 / (1.0 + np.exp(-gate_logits.astype(np.float64))), 1.0)
    return g * Y + (1 - g) * (Y + ln)


def test_default_bias_gap_is_layernorm_conditioning(raw_text_experiments, monkeypatch):
    """At the initial residual_head bias the services' answers may differ
    by more than 1e-4 (by how much depends on the hash tokenizer's ids,
    that is on PYTHONHASHSEED). Each batch's notes, embedded by each
    package's own service, go through each fusion stack on one backbone
    output, and float64 is the witness:
    - MMF_GR_Add's residual before its LayerNorm (delta_y) agrees to 2e-5;
    - the rest of the stage computed exactly in float64 from each side's
      delta_y and gate logits agrees to 1e-4, so the two delta_y give
      the same answer in exact arithmetic;
    - the port's float32 answer lies within 1e-5 of its float64 value.
    What remains is the reference's own float32 rounding: flax's LayerNorm
    takes var = E[x^2] - E[x]^2, which cancels where the C=3 channels
    nearly coincide and is then scaled by a = 1/sqrt(var + eps)."""
    from imm_tsf_tpu.fusion.fusion_model import FusionModel as JFusionModel
    from imm_tsf_tpu.serving import ForecastService as JForecastService
    from imm_tsf_tpu.serving import _build_chunk as j_build_chunk

    from imm_tsf_torch.serving import ForecastService, _build_chunk

    llm_root, dirs = raw_text_experiments
    jdir, tdir = dirs["default"]
    monkeypatch.setenv("IMM_TSF_LLM_DIR", llm_root)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    insts = _text_requests(0, 12)
    jsvc = JForecastService(jdir, max_batch=4, max_wait_ms=20.0)
    tsvc = ForecastService(tdir, max_batch=4, max_wait_ms=20.0, device="cpu")
    jfusion, mmf = JFusionModel(jsvc.cfg), tsvc.fusion.mmf
    seen: dict = {}
    hooks = [mmf.register_forward_hook(lambda m, i, o: seen.update(inputs=i)),
             mmf.residual_head.register_forward_hook(lambda m, i, o: seen.update(dy=o)),
             mmf.gate_net.register_forward_hook(lambda m, i, o: seen.update(gate=o))]
    try:
        for s in range(0, len(insts), 4):
            part = insts[s:s + 4]
            jb = jsvc._collate([j_build_chunk(i, jsvc.cfg, jsvc.d_txt)[0] for i in part])
            jb = {k: jnp.asarray(v) for k, v in jb.items() if isinstance(v, np.ndarray)}
            tb = tsvc.to_device(tsvc._collate([_build_chunk(i, tsvc.cfg, tsvc.d_txt)[0]
                                               for i in part]))
            with torch.no_grad():
                y = tsvc.model(tb["tp_to_predict"], tb["observed_data"], tb["observed_tp"],
                               tb["observed_mask"]).float()
                got = tsvc.fusion(tb["notes_embeddings"], tb["tau"], tb["tp_to_predict"], y,
                                  tb["notes_mask"]).numpy()
            want, inter = jfusion.apply(
                {"params": jsvc.params["fusion"]}, jb["notes_embeddings"], jb["tau"],
                jb["tp_to_predict"], jnp.asarray(y.numpy()), jb["notes_mask"], train=False,
                capture_intermediates=True, mutable=["intermediates"])
            want, j_mmf = np.asarray(want), inter["intermediates"]["mmf"]
            Y, _, M = (t.numpy() for t in seen["inputs"])
            dy_t, dy_j = seen["dy"].numpy(), np.asarray(j_mmf["residual_head"]["__call__"][0])
            np.testing.assert_allclose(dy_t, dy_j, atol=2e-5, rtol=0)
            exact_t = _mmf_tail64(dy_t, seen["gate"].numpy(), Y, M)
            exact_j = _mmf_tail64(dy_j, np.asarray(j_mmf["gate_net"]["__call__"][0]), Y, M)
            np.testing.assert_allclose(exact_t, exact_j, atol=1e-4, rtol=0)
            np.testing.assert_allclose(got, exact_t, atol=1e-5, rtol=0)
            a = 1.0 / np.sqrt(dy_t.var(-1) + 1e-5)
            gap = np.abs(got - want).max(-1)
            worst = np.unravel_index(gap.argmax(), gap.shape)
            print(f"batch {s // 4}: max|d delta_y| {np.abs(dy_t - dy_j).max():.2e}; max gap "
                  f"{gap.max():.2e} at a {a[worst]:.1f} (max a {a.max():.1f}); float64 "
                  f"vs float32: port {np.abs(got - exact_t).max():.2e}, reference "
                  f"{np.abs(want - exact_j).max():.2e}; exact answers "
                  f"{np.abs(exact_t - exact_j).max():.2e} apart")
    finally:
        for h in hooks:
            h.remove()
        jsvc.close()
        tsvc.close()
