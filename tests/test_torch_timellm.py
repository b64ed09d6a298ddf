"""TimeLLM, the port against the JAX package, on the CPU.

GPT-2 stays 768 wide, as the JAX TimeLLM fixes it, with 1-2 blocks;
ts_vocab_size 64, d_model 16, patches of 4 (the sizes of
tests/test_timellm_exact_prompt.py). The port's modules take the JAX
init through `params_from_jax` and run in float32:

- the forward in eval, both prompt modes, to 2e-5; and with the frozen
  GPT-2 stored in bfloat16 (`frozen_param_dtype`), which both packages
  compute in float32 on the rounded weights;
- the gradients of every trainable tensor in train mode (hash dropout
  0.1, the same salts on both sides), on both attention routes, to 1e-4
  of each gradient's largest entry plus 1e-6 of the largest of all (the
  key projection's bias gets rounding noise for a gradient: the softmax
  over the prototypes ignores a shift common to all of them);
- `build_timellm_prompts` string for string, a tie in the lags included;
  the statistics' pieces: jnp.median (the mean of the two middle values),
  lax.top_k's order with exact ties, the float32 FFT autocorrelation;
- a two-epoch `trainable` from the JAX init against the JAX `trainable`
  (dropout 0): per-step losses to 1e-5 relative, the frozen GPT-2 bit for
  bit unchanged;
- an exact-prompt experiment served by the port's ForecastService and by
  the JAX one (each with its prompt stage): answers to 1e-4.

The fast prompt's lags are the top_k of an autocorrelation that is
symmetric in exact arithmetic (corr[k] = corr[L - k] for a real series),
so which lag of a pair ranks first is decided by the FFT's float32
rounding, in the JAX package itself (its CPU and TPU FFTs round
differently). The port keeps that semantics. So the fast-prompt
comparisons run at top_k 1 (lag 0 leads strictly), and one forward at
top_k 3 gives the port the JAX lags computed on the JAX package's own
statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imm_tsf_tpu.training.trainer as jtrainer
from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.data.loader import parse_datasets as j_parse_datasets
from imm_tsf_tpu.data.synthetic import make_synthetic_dataset
from imm_tsf_tpu.fusion.fusion_model import FusionModel as JFusionModel
from imm_tsf_tpu.layers import fast_dropout as jdropout
from imm_tsf_tpu.llm.loader import load_tokenizer as j_load_tokenizer
from imm_tsf_tpu.models import get_model as j_get_model
from imm_tsf_tpu.models import timellm as jtimellm
from imm_tsf_tpu.models.base import masked_norm as j_masked_norm

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.convert import params_from_jax
from imm_tsf_torch.kernels import attn
from imm_tsf_torch.layers.fast_dropout import Dropout, draw_salts
from imm_tsf_torch.llm.loader import load_tokenizer
from imm_tsf_torch.models import get_model
from imm_tsf_torch.models import timellm
from imm_tsf_torch.training.optim import cast_frozen
from imm_tsf_torch.training.trainer import check_trainable, trainable
from torch_port_parity import jitted_jax_init  # noqa: F401 -- autouse: JAX's init jitted

torch.set_num_threads(1)

ATOL = 2e-5
HP = dict(model="TimeLLM", dataset="EPA-Air", input_dim=3, input_len=12, pred_len=6,
          history=12, stride=4, input_token_len=4, d_model=16, d_ff=32, n_heads=2,
          ts_vocab_size=64, top_k=1, llm_layers_timellm=2, dropout=0.1, timellm_prompt_len=48)
B = 4


def _batch(seed=0, B=B, L=12, Lp=6, C=3):
    rng = np.random.default_rng(seed)
    mask = (rng.random((B, L, C)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    data = (rng.standard_normal((B, L, C)) * mask).astype(np.float32)
    data[1, :, 0] = np.tile([1.0, 0.0, -1.0, 0.0], L // 4)  # periodic: lags tie
    return dict(tp_to_predict=np.sort(1 + rng.random((B, Lp)), 1).astype(np.float32),
                observed_data=data,
                observed_tp=np.sort(rng.random((B, L)), 1).astype(np.float32),
                observed_mask=mask)


ARGS = ("tp_to_predict", "observed_data", "observed_tp", "observed_mask")


def _jax_model(exact, seed=0, **kw):
    """(JAX cfg, module, variables, extra apply kwargs, torch extra kwargs)."""
    cfg = JConfig(**dict(HP, timellm_exact_prompt=exact, **kw))
    b = _batch()
    extra, textra = {}, {}
    if exact:
        ids = jtimellm.build_timellm_prompt_ids(cfg, b, j_load_tokenizer("GPT2"),
                                                pad_to=cfg.timellm_prompt_len)
        extra, textra = {"prompt_ids": jnp.asarray(ids)}, {"prompt_ids": torch.from_numpy(ids)}
    model = j_get_model(cfg)
    init = jax.jit(lambda keys: model.init(keys, *(jnp.asarray(b[k]) for k in ARGS), **extra))
    variables = init({"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)})
    return cfg, model, jax.tree_util.tree_map(np.asarray, variables), extra, textra


def _jit_apply(model, variables, b, extra=None):
    """The JAX module's eval forward on batch b, compiled."""
    return jax.jit(lambda v: model.apply(v, *(jnp.asarray(b[k]) for k in ARGS), **(extra or {})))(
        variables)


def _port_model(variables, exact, **kw):
    cfg = TConfig(**dict(HP, timellm_exact_prompt=exact, **kw))
    model = get_model(cfg)
    params = {"model": variables["params"]}
    stats = {"model": {k: v for k, v in variables.items() if k != "params"}}
    cast_frozen(model, cfg.frozen_param_dtype)
    model.load_state_dict(params_from_jax(params, stats)[0])
    return model


@pytest.mark.parametrize("exact", [False, True])
def test_forward_matches_jax(exact):
    cfg, jm, variables, extra, textra = _jax_model(exact)
    b = _batch()
    want = np.asarray(_jit_apply(jm, variables, b, extra))
    tm = _port_model(variables, exact).eval()
    assert ("domain_prompt_ids" in dict(tm.named_buffers())) is not exact
    with torch.no_grad():
        got = tm(*(torch.from_numpy(b[k]) for k in ARGS), **textra).numpy()
    assert got.shape == (B, 6, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_fast_prompt_with_several_lags_matches_jax(monkeypatch):
    """top_k 3: the port is given the lags lax.top_k picks from the JAX
    package's own autocorrelation (its near ties are float32 rounding);
    everything else is the port's."""
    cfg, jm, variables, _, _ = _jax_model(False, top_k=3)
    b = _batch()
    x, _, _ = j_masked_norm(jnp.asarray(b["observed_data"]), jnp.asarray(b["observed_mask"]))
    F = jnp.fft.rfft(x.transpose(0, 2, 1), axis=-1)
    corr = jnp.fft.irfft(F * jnp.conj(F), n=cfg.input_len, axis=-1).mean(axis=1)
    jax_lags = torch.from_numpy(np.asarray(jax.lax.top_k(corr, 3)[1]).astype(np.int64))
    monkeypatch.setattr(timellm, "top_lags", lambda c, k: jax_lags)
    want = np.asarray(_jit_apply(jm, variables, b))
    tm = _port_model(variables, False, top_k=3).eval()
    with torch.no_grad():
        got = tm(*(torch.from_numpy(b[k]) for k in ARGS)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_frozen_bfloat16_forward_matches_jax():
    cfg = JConfig(**dict(HP, frozen_param_dtype="bfloat16"))
    b = _batch()
    params, stats = jax.jit(lambda key: jtrainer.init_state(cfg, j_get_model(cfg), None, b, key))(
        jax.random.PRNGKey(4))
    assert params["model"]["frozen_llm"]["wte"]["embedding"].dtype == jnp.bfloat16
    want = np.asarray(_jit_apply(j_get_model(cfg), {"params": params["model"], **stats["model"]},
                                 b))
    variables = jax.tree_util.tree_map(np.asarray, {"params": params["model"], **stats["model"]})
    tm = _port_model(variables, False, frozen_param_dtype="bfloat16").eval()
    dtypes = {p.dtype for n, p in tm.named_parameters() if n.startswith("frozen_llm.")}
    assert dtypes == {torch.bfloat16}
    assert tm.stat_prompt.weight.dtype == torch.float32
    with torch.no_grad():
        got = tm(*(torch.from_numpy(b[k]) for k in ARGS))
    assert got.dtype == torch.float32  # no bf16 weight pulls an activation down
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


class _Salts:
    """The JAX Dropout's salts, in call order, from the list the port draws."""

    def __init__(self, salts):
        self.salts = list(salts)

    def __call__(self, rng):
        s0, s1 = self.salts.pop(0)
        return jnp.uint32(s0), jnp.uint32(s1)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("exact", [False, True])
def test_gradients_match_jax_under_shared_salts(exact, fused, monkeypatch):
    cfg, jm, variables, extra, textra = _jax_model(exact, seed=2, llm_layers_timellm=1)
    b = _batch(seed=3)
    g = np.random.default_rng(5).standard_normal((B, 6, 3)).astype(np.float32)
    n_sites = 4  # the patch embedder twice, the reprogramming weights, the head
    gen, same = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    monkeypatch.setattr(jdropout, "_key_salts", _Salts(draw_salts(same) for _ in range(n_sites)))
    consts = {k: v for k, v in variables.items() if k != "params"}

    def loss(p):
        out = jm.apply({"params": p, **consts}, *(jnp.asarray(b[k]) for k in ARGS),
                       train=True, rngs={"dropout": jax.random.PRNGKey(0)}, **extra)
        return (out * g).sum()

    want_loss, want = jax.jit(jax.value_and_grad(loss))(variables["params"])
    want = params_from_jax({"model": jax.tree_util.tree_map(np.asarray, want)})[0]

    tm = _port_model(variables, exact, llm_layers_timellm=1, use_fused_attn=fused).train()
    for m in tm.modules():
        if isinstance(m, Dropout):
            m.generator = gen
    calls = attn.backward_calls
    out = tm(*(torch.from_numpy(b[k]) for k in ARGS), **textra)
    got_loss = (out * torch.from_numpy(g)).sum()
    got_loss.backward()
    assert attn.backward_calls == calls + int(fused)  # one GPT-2 block
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=1e-5)
    trained = {n: p for n, p in tm.named_parameters() if p.requires_grad}
    assert not any(n.startswith("frozen_llm.") for n in trained)
    assert all(p.grad is None for n, p in tm.named_parameters() if n.startswith("frozen_llm."))
    top = max(float(want[n].abs().max()) for n in trained)
    for n, p in trained.items():
        w = want[n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-6 * top, err_msg=n)


def test_prompt_text_matches_jax_with_a_tie_in_the_lags():
    cfg_kw = dict(HP, top_k=5)
    b = _batch()
    jc, tc = JConfig(**cfg_kw), TConfig(**cfg_kw)
    want = jtimellm.build_timellm_prompts(jc, b["observed_data"], b["observed_tp"],
                                          b["observed_mask"])
    got = timellm.build_timellm_prompts(tc, b["observed_data"], b["observed_tp"],
                                        b["observed_mask"])
    assert got == want
    # sample 1's first channel is periodic: its autocorrelation ties, and the
    # stable sort ranks a tied pair in index order
    assert "Top lags [0, " in got[1]
    ids = timellm.build_timellm_prompt_ids(tc, b, load_tokenizer("GPT2"), pad_to=48)
    np.testing.assert_array_equal(
        ids, jtimellm.build_timellm_prompt_ids(jc, b, j_load_tokenizer("GPT2"), pad_to=48))
    assert ids.dtype == np.int32 and ids.shape == (B, 48)
    # the trimmed form pads to the batch's longest prompt, as the reference does
    np.testing.assert_array_equal(
        timellm.build_timellm_prompt_ids(tc, b, load_tokenizer("GPT2")),
        jtimellm.build_timellm_prompt_ids(jc, b, j_load_tokenizer("GPT2")))


def test_statistics_pieces_match_jax():
    rng = np.random.default_rng(7)
    for L in (12, 13):  # jnp.median averages the two middle values of an even length
        x = rng.standard_normal((3, L, 4)).astype(np.float32)
        np.testing.assert_array_equal(timellm._median(torch.from_numpy(x), 1).numpy(),
                                      np.asarray(jnp.median(jnp.asarray(x), axis=1)))
        corr = timellm._autocorrelation(torch.from_numpy(x), L)
        xj = jnp.asarray(x).transpose(0, 2, 1)
        F = jnp.fft.rfft(xj, axis=-1)
        want = np.asarray(jnp.fft.irfft(F * jnp.conj(F), n=L, axis=-1).mean(axis=1))
        assert corr.dtype == torch.float32
        np.testing.assert_allclose(corr.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)
        # the symmetric pairs, equal in exact arithmetic
        np.testing.assert_allclose(want[:, 1:], want[:, 1:][:, ::-1], atol=1e-5 * L)
    ties = np.asarray([[3.0, 5.0, 1.0, 5.0, 3.0, 5.0], [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]],
                      np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(ties), 4)[1])
    np.testing.assert_array_equal(timellm.top_lags(torch.from_numpy(ties), 4).numpy(), want)
    np.testing.assert_array_equal(want, [[1, 3, 5, 0], [0, 1, 2, 3]])


def test_only_gpt2_is_ported():
    """Every TimeLLM LLM builds, frozen, at its width: BERT 768 and Llama
    4096 (one block here); an unknown name is refused."""
    for name, width, vocab in (("BERT", 768, 30522), ("LLAMA", 4096, 128256)):
        tm = get_model(TConfig(**dict(HP, llm_model_timellm=name, llm_layers_timellm=1)))
        assert tm.d_llm == width and len(tm.frozen_llm.layers) == 1
        assert tm.frozen_llm.word_embedding_table().shape == (vocab, width)
        assert tm.mapping_layer.weight.shape == (HP["ts_vocab_size"], vocab)
        assert not any(p.requires_grad for p in tm.frozen_llm.parameters())
        del tm
    with pytest.raises(ValueError, match="Unknown llm_model"):
        get_model(TConfig(**dict(HP, llm_model_timellm="T5")))
    check_trainable(TConfig(**dict(HP, use_fused_attn=True, frozen_param_dtype="bfloat16")))


# ------------------------------------------------------------ the slice
SLICE_KW = dict(
    dataset="EPA-Air", model="TimeLLM", history=7, pred_window=7, stride=7, time_unit="days",
    input_token_len=4, d_model=16, d_ff=32, n_heads=2, ts_vocab_size=64, top_k=1,
    llm_layers_timellm=1, timellm_prompt_len=48, batch_size=8, epoch=2, patience=3,
    dropout=0.0, seed=3, lr=1e-3, w_decay=0.01, device_loop=False, host_prefetch=0)
RUNS = {  # the fast prompt behind the fusion stack; the exact prompt alone
    "fast": dict(timellm_exact_prompt=False, enable_text=True, use_text_embeddings=True,
                 TTF_module="TTF_RecAvg", MMF_module="MMF_GR_Add", llm_model_fusion="GPT2",
                 llm_layers_fusion=6, d_txt=16),
    "exact": dict(timellm_exact_prompt=True, enable_text=False)}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("timellm"))
    make_synthetic_dataset(f"{root}/EPA-Air", n_entities=3, n_features=3, n_days=80,
                           obs_per_day=1.2, notes_per_day=0.7, d_txt=16, seed=0)
    return root


@pytest.fixture(scope="module", params=sorted(RUNS))
def jax_run(request, data_root):
    """(run, JAX init params, its stats, per-step losses) of the JAX trainable."""
    cfg = JConfig(data_root=data_root, **SLICE_KW, **RUNS[request.param])
    data = jtrainer.wrap_data_loaders(cfg, j_parse_datasets(cfg, verbose=False))
    jcfg = data["cfg"]
    rng = jax.random.key(jcfg.seed, impl=jcfg.rng_impl)
    rng, init_rng = jax.random.split(rng)
    fusion = JFusionModel(jcfg) if jcfg.enable_text else None
    params, stats = jtrainer.init_state(jcfg, j_get_model(jcfg), fusion,
                                        next(iter(data["train_dataloader"])), init_rng)
    params, stats = (jax.tree_util.tree_map(np.asarray, t) for t in (params, stats))
    losses = []
    build_steps = jtrainer.build_steps

    def recording_build_steps(*a, **k):
        train_step, eval_step = build_steps(*a, **k)

        def step(*args):
            out = train_step(*args)
            losses.append(float(out[-1]))
            return out

        return step, eval_step

    jtrainer.build_steps = recording_build_steps
    try:
        jtrainer.trainable(cfg)
    finally:
        jtrainer.build_steps = build_steps
    return request.param, params, stats, losses


@pytest.mark.parametrize("fused", [True, False])
def test_trainable_from_jax_init_matches_jax_trainable(jax_run, data_root, fused):
    run, params, stats, want_losses = jax_run
    initial = params_from_jax(params, stats)
    calls = attn.backward_calls
    got = trainable(TConfig(data_root=data_root, use_fused_attn=fused, **SLICE_KW, **RUNS[run]),
                    device="cpu", initial_state=initial)
    got_losses = [x for h in got["history"] for x in h["step_losses"]]
    assert len(got_losses) == len(want_losses) > 3
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    assert attn.backward_calls - calls == (len(got_losses) if fused else 0)
    frozen = {k: v for k, v in got["model"].state_dict().items() if k.startswith("frozen_llm.")}
    assert frozen and all(torch.equal(v, initial[0][k]) for k, v in frozen.items())


def _requests(seed, k, C=3):
    """Ragged requests: 0-12 observations with holes, 1-6 forecast times,
    every third with mean/std."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        n, m = int(rng.integers(0, 13)), int(rng.integers(1, 7))
        vals = rng.standard_normal((n, C))
        vals[rng.random(vals.shape) < 0.2] = np.nan
        inst = {"observed_tp": np.sort(rng.choice(np.linspace(0, 6.9, 40), n, replace=False)).tolist(),
                "observed_data": vals.tolist(),
                "tp_to_predict": np.sort(rng.choice(np.linspace(7, 14, 30), m, replace=False)).tolist()}
        if i % 3 == 0:
            inst["mean"] = rng.standard_normal(C).tolist()
            inst["std"] = (0.5 + rng.random(C)).tolist()
        out.append(inst)
    return out


def test_exact_prompt_service_matches_jax_service(tmp_path):
    """One exact-prompt TimeLLM experiment, served by the JAX ForecastService
    and by the port's (the prompt stage on both sides): answers to 1e-4."""
    import os

    from imm_tsf_tpu.serving import ForecastService as JForecastService
    from imm_tsf_tpu.training.checkpoint import save_checkpoint

    from imm_tsf_torch.config import load_saved_config
    from imm_tsf_torch.serving import ForecastService
    from imm_tsf_torch.training.checkpoint import save_experiment

    kw = dict(HP, timellm_exact_prompt=True, llm_layers_timellm=1, history=7, pred_window=7,
              stride=4)
    cfg = JConfig(**kw)
    b = _batch()
    b["prompt_ids"] = jtimellm.build_timellm_prompt_ids(cfg, b, j_load_tokenizer("GPT2"),
                                                        pad_to=cfg.timellm_prompt_len)
    params, stats = jax.jit(lambda key: jtrainer.init_state(cfg, j_get_model(cfg), None, b, key))(
        jax.random.PRNGKey(6))
    params, stats = (jax.tree_util.tree_map(np.asarray, t) for t in (params, stats))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(jdir)
    with open(os.path.join(jdir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    save_checkpoint(os.path.join(jdir, "best"), params, stats, 0)
    save_experiment(tdir, load_saved_config(os.path.join(jdir, "config.json")),
                    params_from_jax(params, stats)[0], None, step=0)
    insts = _requests(1, 9)
    jsvc = JForecastService(jdir, max_batch=4, max_wait_ms=20.0)
    try:
        want = [f.result(timeout=600) for f in [jsvc.submit(i) for i in insts]]
    finally:
        jsvc.close()
    tsvc = ForecastService(tdir, max_batch=4, max_wait_ms=20.0, device="cpu")
    try:
        got = [f.result(timeout=600) for f in [tsvc.submit(i) for i in insts]]
    finally:
        tsvc.close()
    for inst, g, w in zip(insts, got, want):
        assert g["tp"] == w["tp"]
        y = np.asarray(g["prediction"])
        assert y.shape == (len(inst["tp_to_predict"]), 3) and np.isfinite(y).all()
        np.testing.assert_allclose(y, np.asarray(w["prediction"]), atol=1e-4, rtol=1e-4)
