"""compute_dtype="amp_bf16" in the port against the JAX package, on the CPU.

Under amp the JAX package casts the backbone's parameters and float
inputs to bfloat16 and lets jnp's promotion set every later dtype; the
port does the same through layers/jax_promotion.py (amp_call and
JaxPromotion). Both sides get the same seeded NumPy inputs and the JAX
init through params_from_jax.

  - the per-module dtype map (flax intercept_methods against torch forward
    hooks, modules matched by their parameters' names): equal for all
    seven MTS/LMTS backbones;
  - the eval forward of each backbone, bare and with TTF_RecAvg +
    MMF_GR_Add, to FWD_ATOL;
  - the amp output differs from the float32 output (the no-op guard of
    tests/test_amp_bf16.py);
  - hash dropout on bf16 and kernel #2's plain version on bf16 weights,
    against the JAX ones;
  - JAX's refusal for the four continuous-time models; "bfloat16" runs the
    one-pass products (tests/test_torch_bf16*.py hold it to JAX).

tests/test_torch_amp_train.py holds the training step and the entry
points.

The JAX side runs under `strict_jit`: XLA's CPU compiler may keep a
fusion's bf16 intermediates in f32 (xla_allow_excess_precision, on by
default), which moves the JAX package's own amp outputs by about as much
as amp moves them from float32 (PatchTST: 1.0e-2 against 1.1e-2); with it
off, the jitted program equals JAX's op-by-op run to 1e-6, and rounds
every bf16 op as the program states it.

Tolerances, and why. The port rounds bf16 arithmetic op by op
(JaxPromotion), as XLA's CPU compiler does with excess precision off,
except where XLA still rewrites the arithmetic: a reduction's fusion sums
its producers' f32 values unrounded (TTM's statistics), and torch's and
XLA's bf16 products differ in about 1e-4 of their elements by an ulp
(TimeLLM's mapping layer). So the bf16-end-to-end models are held to
about a bf16 ulp of their output, and the f32-activation models to their
float32 parity tolerance. Measured maxima of |port - JAX| (eval forward,
bare / with the pair): PatchTST 1.8e-6 / 1.9e-6, Informer 5.4e-7 /
7.5e-7, TimesNet 4.2e-7 / 7.6e-7, TimeMixer 1.8e-7 / 8.1e-7, DLinear 0 /
1.0e-6, TimeLLM (top_k 1: the fast prompt's lags are a near tie by
construction) 1.2e-4 / 1.5e-4, TTM 3.9e-3 / 3.9e-3 (outputs of order 1,
where a bf16 ulp is 2^-7 to 2^-8)."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imm_tsf_tpu.training.trainer as jtrainer
from bench import build_batch
from imm_tsf_tpu.config import MODEL_PRESETS
from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.fusion.fusion_model import FusionModel as JFusionModel
from imm_tsf_tpu.models import get_model as j_get_model

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.convert import _model_renames, params_from_jax, port_keys
from imm_tsf_torch.fusion.fusion_model import FusionModel
from imm_tsf_torch.layers.jax_promotion import JaxPromotion, round_bf16
from imm_tsf_torch.models import get_model
from imm_tsf_torch.training import trainer

from torch_port_parity import perturbed
from torch_port_parity import jitted_jax_init  # noqa: F401 -- autouse: JAX's init jitted

torch.set_num_threads(1)

B, L, Lp, C, D_TXT = 8, 48, 24, 4, 32
MODELS = ("DLinear", "Informer", "PatchTST", "TimesNet", "TimeMixer", "TimeLLM", "TTM")
# the presets cut to test size (GPT-2 keeps its full width, one block)
SMALL = {"PatchTST": dict(d_model=32, d_ff=64), "Informer": dict(d_model=32, d_ff=64),
         "TimesNet": dict(d_model=16, d_ff=32), "TimeMixer": dict(d_model=16, d_ff=32),
         "DLinear": {}, "TTM": dict(d_model=64, e_layers=1, d_layers=1, d_d_model=16,
                                    AP_levels=2),
         "TimeLLM": dict(llm_layers_timellm=1, ts_vocab_size=64, d_model=16, d_ff=32,
                         top_k=1)}
FWD_ATOL = {"PatchTST": 5e-6, "Informer": 5e-6, "TimeMixer": 5e-6, "DLinear": 5e-6,
            "TimeLLM": 4e-4, "TimesNet": 5e-6, "TTM": 8e-3}
# the modules each backbone runs in bf16 under amp (the rest run in f32 on
# bf16-rounded weights), as flax intercept_methods records the JAX package's
BF16_MODULES = {
    "DLinear": {"seasonal", "trend", "time"},
    "PatchTST": {"patch_embedding.value_embedding"},
    "Informer": {"enc_embedding.value_embedding.tokenConv"},
    "TimesNet": {"enc_embedding.value_embedding.tokenConv"},
    "TimeMixer": {"enc_embedding.value_embedding.tokenConv"},
    "TimeLLM": {"patch_embedding.value_embedding", "frozen_llm.wte", "frozen_llm.wpe",
                "stat_prompt", "mapping_layer", "reprogramming_layer.key_projection",
                "reprogramming_layer.value_projection"},
}


def _cfg(model: str, text: bool, **kw) -> JConfig:
    base = dict(model=model, input_dim=C, input_len=L, pred_len=Lp, batch_size=B, stride=8,
                history=L, enable_text=text, use_text_embeddings=text, d_txt=D_TXT,
                llm_model_fusion="GPT2", TTF_module="TTF_RecAvg", MMF_module="MMF_GR_Add",
                compute_dtype="amp_bf16")
    return JConfig(**base).replace(**MODEL_PRESETS.get(model, {})).replace(**SMALL[model], **kw)


def _batch(seed: int = 0) -> dict:
    return build_batch(B=B, L=L, Lp=Lp, C=C, N=4, d_txt=D_TXT, seed=seed)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_state(jcfg, batch):
    """The JAX init under key 0, the model's leaves moved off their init."""
    jm = j_get_model(jcfg)
    jf = JFusionModel(jcfg) if jcfg.enable_text else None
    params, stats = jax.jit(lambda key: jtrainer.init_state(jcfg, jm, jf, batch, key))(
        jax.random.PRNGKey(0))
    params = _np(params)
    params["model"] = perturbed(params["model"], 0.02)
    return jm, jf, params, _np(stats)


def _port(jcfg, params, stats):
    """The port's modules (eval) loaded from the JAX state."""
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    torch.manual_seed(0)
    tm = get_model(tcfg)
    tf = FusionModel(tcfg, d_notes=D_TXT) if jcfg.enable_text else None
    mstate, fstate = params_from_jax(params, stats)
    tm.load_state_dict(mstate)
    if tf is not None:
        tf.load_state_dict(fstate)
    return tcfg, tm, tf


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _float_dtype(tree):
    leaves = [a for a in jax.tree_util.tree_leaves(tree)
              if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating)]
    return str(leaves[0].dtype) if leaves else None


def strict_jit(f, *args):
    """f(*args) jitted with XLA's excess precision off: every bf16 op rounds
    its result, as the program states it (and as JAX's op-by-op dispatch
    runs it). By default XLA may keep a fusion's bf16 intermediates in f32
    (xla_allow_excess_precision), which moves the JAX package's own amp
    outputs by about as much as amp moves them from float32."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _jax_dtype_map(jcfg, jm, jf, params, stats, batch) -> dict:
    """((flax module path) -> (input dtype, output dtype) of each module
    call in the amp eval forward, the forward's output)."""
    rec = {}

    def record(f, args, kwargs, context):
        out = f(*args, **kwargs)
        if context.method_name == "__call__" and context.module.path:
            rec.setdefault(tuple(context.module.path), (_float_dtype(args), _float_dtype(out)))
        return out

    fwd = jtrainer.make_forward(jcfg, jm, jf)

    def traced(params, stats, batch):  # the dtypes are recorded while jit traces
        with fnn.intercept_methods(record):
            return fwd(params, stats, batch, False, None)[0]

    out = strict_jit(traced, params, stats, {k: jnp.asarray(v) for k, v in batch.items()})
    return rec, np.asarray(out)


def _torch_dtype(out):
    """The dtype of the first floating tensor in out (nested lists and
    tuples), as _float_dtype reads a pytree."""
    if isinstance(out, torch.Tensor):
        return str(out.dtype).replace("torch.", "") if out.is_floating_point() else None
    if isinstance(out, (list, tuple)):
        return next((d for d in map(_torch_dtype, out) if d is not None), None)
    return None


def _port_dtype_map(tcfg, tm, tf, batch) -> tuple:
    rec, handles = {}, []

    def hook(name):
        def h(mod, args, out):
            rec.setdefault(name, (_torch_dtype(args), _torch_dtype(out)))
        return h

    for name, mod in tm.named_modules():
        if name:
            handles.append(mod.register_forward_hook(hook(name)))
    tm.eval()
    if tf is not None:
        tf.eval()
    try:
        with torch.inference_mode():
            out = trainer.make_forward(tcfg, tm, tf)(_tensors(batch)).numpy()
    finally:
        for h in handles:
            h.remove()
    return rec, out


_CASES: dict = {}


def _case(model: str, text: bool):
    """JAX's and the port's dtype maps and outputs for one backbone (cached)."""
    if (model, text) not in _CASES:
        jcfg, batch = _cfg(model, text), _batch()
        jm, jf, params, stats = _jax_state(jcfg, batch)
        jrec, want = _jax_dtype_map(jcfg, jm, jf, params, stats, batch)
        tcfg, tm, tf = _port(jcfg, params, stats)
        trec, got = _port_dtype_map(tcfg, tm, tf, batch)
        modules = {tuple(path.split(".")[:-1]): key.rsplit(".", 1)[0] for path, (key, _) in
                   port_keys(params["model"], _model_renames(params["model"])).items()}
        _CASES[(model, text)] = (jrec, trec, modules, want, got)
    return _CASES[(model, text)]


@pytest.mark.parametrize("model", MODELS)
def test_dtype_map_matches_jax(model):
    """Every module with parameters that both forwards call has the same
    input and output dtype in both; the bf16 ones are the recorded map's."""
    jrec, trec, modules, _, _ = _case(model, False)
    matched, bf16 = 0, set()
    for path, dtypes in jrec.items():
        name = modules.get(path)
        if name is None or name not in trec:
            continue
        matched += 1
        assert trec[name] == dtypes, f"{name}: port {trec[name]}, JAX {dtypes}"
        if dtypes[1] == "bfloat16":
            bf16.add(name)
    assert matched >= 3
    if model == "TTM":  # bf16 end to end: every module
        assert bf16 == {modules[p] for p in jrec if modules.get(p) in trec}
    else:
        assert bf16 == BF16_MODULES[model]


@pytest.mark.parametrize("text", [False, True], ids=["bare", "pair"])
@pytest.mark.parametrize("model", MODELS)
def test_eval_forward_matches_jax(model, text):
    _, _, _, want, got = _case(model, text)
    assert got.dtype == np.float32 and got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=FWD_ATOL[model], rtol=0)


@pytest.mark.parametrize("model", ["PatchTST", "TTM"])
def test_amp_output_differs_from_float32(model):
    """Bit-equality with the float32 forward would mean the casts never
    engaged."""
    jcfg, batch = _cfg(model, True), _batch()
    _, _, params, stats = _jax_state(jcfg, batch)
    outs = []
    for dtype in ("amp_bf16", "float32"):
        tcfg, tm, tf = _port(jcfg.replace(compute_dtype=dtype), params, stats)
        tm.eval(), tf.eval()
        with torch.inference_mode():
            outs.append(trainer.make_forward(tcfg, tm, tf)(_tensors(batch)).numpy())
    amp, f32 = outs
    assert not np.array_equal(amp, f32)
    assert np.abs(amp - f32).max() < 0.05 * np.abs(f32).max()


# ------------------------------------------------------------- pieces
def test_hash_dropout_on_bf16_matches_jax():
    """The same mask, x / keep_prob rounded once with keep_prob a bf16 weak
    scalar (bf16(0.9) = 0.8984375), as XLA computes it; the gradient too."""
    from imm_tsf_tpu.layers.fast_dropout import _hash_dropout

    from imm_tsf_torch.layers.fast_dropout import hash_dropout

    x = np.random.default_rng(0).standard_normal((64, 96)).astype(np.float32)
    g = np.random.default_rng(1).standard_normal((64, 96)).astype(np.float32)
    s0, s1 = 123456789, 987654321
    xb = jnp.asarray(x, jnp.bfloat16)
    f = lambda v: _hash_dropout(v, jnp.uint32(s0), jnp.uint32(s1), 0.9, v.shape)
    want, vjp = jax.vjp(f, xb)
    (want_g,) = vjp(jnp.asarray(g, jnp.bfloat16))
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    with JaxPromotion():
        got = hash_dropout(tx, s0, s1, 0.9)
    got.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and round_bf16(0.9) == 0.8984375
    np.testing.assert_array_equal(got.float().detach().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(tx.grad.float().numpy(),
                                  np.asarray(want_g.astype(jnp.float32)))


@pytest.mark.parametrize("drop", [False, True])
def test_ffn_plain_version_on_bf16_weights_matches_jax(drop):
    """Kernel #2's plain version with f32 x and bf16 weights against the JAX
    kernel in interpret mode (forward, training residuals) and its VJP: each
    weight's gradient in bf16, rounded once (ffn_kernel.py:228-231)."""
    from imm_tsf_tpu.ops.pallas import ffn_kernel as jffn

    from imm_tsf_torch.kernels import ffn

    rng = np.random.default_rng(3)
    M, D, F = 40, 32, 64
    x = rng.standard_normal((M, D)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * sc
          for s, sc in (((D, F), 0.2), ((F,), 0.1), ((F, D), 0.2), ((D,), 0.1),
                        ((D,), 0.1), ((D,), 0.1))]
    ws[4] += 1.0  # gamma near 1
    salts = np.array([[11, 13], [17, 19]], np.uint32)
    g = rng.standard_normal((M, D)).astype(np.float32)
    jw = [jnp.asarray(w, jnp.bfloat16) for w in ws]
    want, a1, r = jffn._ffn_forward_pallas(jnp.asarray(x), *jw, jnp.asarray(salts), 0.9,
                                           "gelu", drop, with_residuals=True)
    _, vjp = jax.vjp(lambda *a: jffn.fused_encoder_ffn(*a, jnp.asarray(salts), 0.9, "gelu",
                                                       drop), jnp.asarray(x), *jw)
    want_g = vjp(jnp.asarray(g))
    tw = [torch.from_numpy(w).to(torch.bfloat16).requires_grad_() for w in ws]
    tx = torch.from_numpy(x).requires_grad_()
    got = ffn.fused_encoder_ffn(tx, *tw, torch.from_numpy(salts.astype(np.int64)), 0.9,
                                "gelu", drop)
    got.backward(torch.from_numpy(g))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-6, rtol=0)
    _, ta1, tr = ffn._forward(tx.detach(), *[w.detach() for w in tw], torch.from_numpy(
        salts.astype(np.int64)), 0.9, "gelu", drop, with_residuals=True)
    np.testing.assert_allclose(ta1.numpy(), np.asarray(a1), atol=2e-6, rtol=0)
    np.testing.assert_allclose(tr.numpy(), np.asarray(r), atol=2e-6, rtol=0)
    for name, t, w in zip(("x", "w1", "b1", "w2", "b2", "gamma", "beta"), [tx, *tw], want_g):
        assert t.grad.dtype == t.dtype, name
        wf = np.asarray(w.astype(jnp.float32))
        # bf16 gradients: the f32 sums agree to ~1e-6, then round once; a sum
        # within that of a rounding boundary lands one bf16 ulp apart
        np.testing.assert_allclose(t.grad.float().numpy(), wf, rtol=2.0**-7,
                                   atol=1e-5 * np.abs(wf).max(), err_msg=name)


@pytest.mark.parametrize("model", ["CRU", "LatentODE", "NeuralFlow", "tPatchGNN"])
def test_amp_refused_for_continuous_time_models(model):
    """JAX's ValueError, word for word."""
    jcfg = JConfig(model=model, compute_dtype="amp_bf16")
    with pytest.raises(ValueError) as want:
        jtrainer.make_forward(jcfg, None, None)
    with pytest.raises(ValueError) as got:
        trainer.make_forward(TConfig(model=model, compute_dtype="amp_bf16"), None, None)
    assert str(got.value) == str(want.value)


def test_bfloat16_compute_still_refused():
    """(Named for the refusal compute_dtype="bfloat16" met until its one-pass
    products were ported.) make_forward takes it: DLinear's forward equals
    the float32 forward run inside Bf16Products, bit for bit, and is not the
    float32 forward (tests/test_torch_bf16*.py hold the mode to JAX)."""
    from imm_tsf_torch.layers.bf16_products import Bf16Products

    jcfg = _cfg("DLinear", False)
    tcfg = TConfig(**dataclasses.asdict(jcfg.replace(compute_dtype="bfloat16")))
    torch.manual_seed(0)
    tm = get_model(tcfg).eval()
    batch = _tensors(_batch())
    f32 = tcfg.replace(compute_dtype="float32")
    with torch.inference_mode():
        got = trainer.make_forward(tcfg, tm, None)(batch)
        with Bf16Products():
            want = trainer.make_forward(f32, tm, None)(batch)
        float32 = trainer.make_forward(f32, tm, None)(batch)
    assert torch.equal(got, want)
    assert (got - float32).abs().max() >= 1e-4


