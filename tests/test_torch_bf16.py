"""compute_dtype="bfloat16" in the port against the JAX package, on the CPU:
the products, kernels #1-#3's one-pass forms, GPT-2's stages and the
frozen bf16 LLM. tests/test_torch_bf16_models.py holds the backbones' eval
forwards, tests/test_torch_bf16_train.py the training steps and the entry
points.

The JAX package runs its forward under jax.default_matmul_precision(
"bfloat16"): every dot and convolution it traces is stamped DEFAULT, which
an accelerator runs with bf16-rounded operands and float32 sums. JAX on the
CPU ignores the stamp, so `install_bf16_oracle` (tests/torch_port_parity.py)
gives the CPU those semantics: its lowerings round a DEFAULT product's
float32 operands to bf16 before the product. The oracle rounds nothing at
HIGHEST (ops/expm.py, the fused CRU scan), and nothing outside the context.
JAX traces a custom VJP's backward after the forward's context has closed
(its products carry no stamp, which the TPU runs at DEFAULT too), so the
gradients here are traced under the context as a whole.

Both sides get the same seeded NumPy inputs and, for the backbones, the JAX
init through params_from_jax.

Tolerances, and why. A product of rounded operands is exact in float32;
what the two packages still do differently is the order of the float32
sums (and torch's and XLA's exp, tanh and LayerNorm, an ulp apart). Where
no rounding flips on the way, the port is held to its float32 tolerances.
Where a float32 value that differs by an ulp lies at a bf16 rounding
boundary, the two round it to neighbouring bf16 values (2^-8 relative), and
every later product spreads that: the measured gaps are stated beside each
tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.ops.expm import _mm as j_highest_mm
from imm_tsf_tpu.ops.pallas import attn_kernel as jattn
from imm_tsf_tpu.ops.pallas import ffn_kernel as jffn
from imm_tsf_tpu.ops.pallas import fusion_kernels as jrecavg
from imm_tsf_tpu.serving import collate_chunks

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.kernels import attn as tattn
from imm_tsf_torch.kernels import ffn as tffn
from imm_tsf_torch.kernels import recavg as trecavg
from imm_tsf_torch.layers.attention import masked_softmax
from imm_tsf_torch.layers.bf16_products import Bf16Products, active, full_precision
from imm_tsf_torch.models import get_model
from imm_tsf_torch.training import trainer
from imm_tsf_torch.training.optim import cast_frozen

from torch_port_parity import (BF16_BASE, BF16_MODELS, D_TXT, install_bf16_oracle,
                               sample_chunks, tensors)

torch.set_num_threads(1)

CTX = lambda: jax.default_matmul_precision("bfloat16")  # noqa: E731


@pytest.fixture(scope="module")
def oracle():
    restore = install_bf16_oracle()
    yield
    restore()


def rounded64(a) -> np.ndarray:
    """a rounded to bf16 (nearest even), in float64."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).double().numpy()


# ---------------------------------------------------------------- the oracle
def test_oracle_rounds_default_products_only(oracle):
    """Under the context a float32 product is the float64 product of the
    rounded operands to float32 summation (64 terms); without it, and at
    HIGHEST (ops/expm.py's _mm), it is the float32 product."""
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((64, 64)).astype(np.float32) for _ in range(2))
    exact, one_pass = a.astype(np.float64) @ b, rounded64(a) @ rounded64(b)
    with CTX():
        got = np.asarray(jax.jit(lambda x, y: x @ y)(a, b))
        highest = np.asarray(jax.jit(j_highest_mm)(a, b))
    plain = np.asarray(jax.jit(lambda x, y: x @ y)(a, b))
    assert np.abs(got - one_pass).max() <= 1e-5 and np.abs(got - exact).max() >= 1e-2
    assert np.abs(highest - exact).max() <= 2e-5 and np.abs(plain - exact).max() <= 2e-5


# --------------------------------------------------------------- the products
def _conv2d(x, w):
    return F.conv2d(x, w, None, 1, (1, 2))


PRODUCTS = {  # name: (shapes of a and b, the product)
    "linear": (((5, 7, 16), (8, 16)), lambda a, b: F.linear(a, b)),
    "conv1d": (((2, 4, 10), (6, 4, 3)), lambda a, b: F.conv1d(a, b, None, 1, 1)),
    "conv2d": (((2, 3, 6, 7), (5, 3, 3, 5)), _conv2d),
    "einsum": (((2, 3, 5, 4), (2, 3, 6, 4)),
               lambda a, b: torch.einsum("bhqd,bhkd->bhqk", a, b)),
    "bmm": (((3, 5, 16), (3, 16, 6)), torch.bmm),
}


@pytest.mark.parametrize("name", sorted(PRODUCTS))
def test_mode_products_are_one_pass_forward_and_backward(name):
    """Each product under Bf16Products, forward and both gradients, against
    float64 on the rounded operands and the rounded incoming gradient (the
    float32 sums: 2e-6 relative to the largest value); the same product
    outside the mode, or under full_precision(), is float32's."""
    (sa, sb), fn = PRODUCTS[name]
    rng = np.random.default_rng(len(name))
    a_np, b_np = (rng.standard_normal(s).astype(np.float32) for s in (sa, sb))
    a, b = (torch.from_numpy(v).requires_grad_() for v in (a_np, b_np))
    with Bf16Products():
        assert active()
        out = fn(a, b)
        with full_precision():
            assert not active()
            full = fn(a, b)
    g_np = rng.standard_normal(out.shape).astype(np.float32)
    out.backward(torch.from_numpy(g_np))
    ra, rb = (torch.from_numpy(rounded64(v)).requires_grad_() for v in (a_np, b_np))
    want = fn(ra, rb)
    want.backward(torch.from_numpy(rounded64(g_np)))
    for got, ref in ((out, want), (a.grad, ra.grad), (b.grad, rb.grad)):
        ref = ref.detach().numpy()
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                                   atol=2e-6 * np.abs(ref).max())
    exact = fn(*(torch.from_numpy(v.astype(np.float64)) for v in (a_np, b_np))).numpy()
    assert np.abs(full.detach().numpy() - exact).max() <= 1e-5 * np.abs(exact).max()
    assert np.abs(out.detach().numpy() - exact).max() >= 1e-3 * np.abs(exact).max()


# ------------------------------------------------------------- kernel #2
def _ffn_inputs(M=48, D=64, Fd=128, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, D)).astype(np.float32)
    w1 = (rng.standard_normal((D, Fd)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal(Fd) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((Fd, D)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal(D) * 0.1).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(D)).astype(np.float32)
    salts = rng.integers(0, 2**32, (2, 2)).astype(np.uint32)
    g = rng.standard_normal((M, D)).astype(np.float32)
    return [x, w1, b1, w2, b2, gamma, beta, salts], g


FFN_NAMES = ("x", "w1", "b1", "w2", "b2", "gamma", "beta")
# no flip at these sizes: the float32 tolerances of tests/test_torch_ffn_train.py
# (measured: forward 4.8e-7, residuals 2.4e-7, gradients 2.4e-6)
FFN_FWD_TOL = dict(atol=2e-5, rtol=0)
FFN_GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("act,drop", [("gelu", True), ("relu", False)])
def test_ffn_one_pass_form_matches_jax(oracle, act, drop):
    """#2's one-pass plain version (both forms) against the Pallas kernel in
    interpret mode under the context, and its gradients (the autograd
    Function inside the mode, whose backward rounds its four products)
    against jax.vjp of the JAX fused_encoder_ffn, traced under the context."""
    args, g = _ffn_inputs()
    jargs = list(map(jnp.asarray, args))
    with CTX():
        want = jffn._ffn_forward_pallas(*jargs, 0.9, act, drop, with_residuals=True)
        out_j, vjp = jax.vjp(lambda *p: jffn.fused_encoder_ffn(*p, jargs[7], 0.9, act, drop),
                             *jargs[:7])
        want_g = vjp(jnp.asarray(g))
    params = [torch.from_numpy(a.copy()) for a in args[:7]]
    salts = torch.from_numpy(args[7].astype(np.int64))
    got = tffn.ffn_forward_reference(*params, salts, 0.9, act, drop, with_residuals=True,
                                     one_pass=True)
    for name, gt, w in zip(("out", "a1", "r"), got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), **FFN_FWD_TOL, err_msg=name)
    float32 = tffn.ffn_forward_reference(*params, salts, 0.9, act, drop)
    assert np.abs(float32.numpy() - np.asarray(want[0])).max() >= 1e-3  # the mode is live
    for p in params:
        p.requires_grad_()
    before = (tffn.launches, tffn.one_pass_launches)
    with Bf16Products():
        out = tffn.fused_encoder_ffn(*params, salts, 0.9, act, drop)
    grads = torch.autograd.grad(out, params, torch.from_numpy(g))
    assert (tffn.launches, tffn.one_pass_launches) == before  # CPU tensors never launch
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **FFN_FWD_TOL)
    for name, gt, gj in zip(FFN_NAMES, grads, want_g):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **FFN_GRAD_TOL, err_msg=name)


# ------------------------------------------------------------- kernel #3
def _attn_inputs(B=3, H=2, T=20, D=16, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(4))
    lens = np.array([0, T, T // 2 + 3])[:B]  # sample 0 keeps no key
    pad = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    return q, k, v, pad, g


def test_attention_one_pass_form_matches_jax(oracle):
    """#3's one-pass plain version against the Pallas kernel in interpret
    mode under the context (a sample with no key gives exact zeros), and its
    gradients against jax.vjp of the JAX fused_causal_attention traced under
    the context (`_attn_bwd`'s products rounded). No flip at this size: the
    float32 tolerances of tests/test_torch_attn_bwd.py (measured 0 and 4.8e-7)."""
    q, k, v, pad, g = _attn_inputs()
    with CTX():
        want, vjp = jax.vjp(lambda a, b, c: jattn.fused_causal_attention(a, b, c, pad), q, k, v)
        want_g = vjp(jnp.asarray(g))
    T = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    with Bf16Products():
        out = tattn.fused_causal_attention(*T, torch.from_numpy(pad))
    assert bool((out[0] == 0).all())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    plain = tattn.attention_reference(*(t.detach() for t in T), torch.from_numpy(pad),
                                      one_pass=True)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    calls = tattn.backward_calls
    grads = torch.autograd.grad(out, T, torch.from_numpy(g))
    assert tattn.backward_calls == calls + 1
    for name, gt, gj in zip("qkv", grads, want_g):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    float32 = tattn.attention_reference(*(t.detach() for t in T), torch.from_numpy(pad))
    assert np.abs(float32.numpy() - np.asarray(want)).max() >= 1e-3


# ------------------------------------------------------------- kernel #1
FLIP_TOL = dict(atol=1e-4, rtol=1e-3)
def test_recency_average_one_pass_form_matches_jax(oracle):
    """#1's weighted sum is a dot_general at DEFAULT under the context
    (fusion_kernels.py:44-48): the one-pass plain version against the Pallas
    kernel in interpret mode, and its gradients against jax.vjp of the JAX
    recency_weighted_average (`_bwd`'s einsums rounded), traced under the
    context: the forward and dV to 1e-5 (measured 2.4e-7 and 9.5e-7); tau's
    and t_hat's gradients (up to 12.5) to FLIP_TOL, since `_bwd` takes
    1/denom from the kernel's denominator (tau and t_hat divided by sigma
    first) where the port recomputes it, and an ulp there flips a rounding
    of dE/denom (measured 3.9e-5 and 1.9e-5 at one element each)."""
    rng = np.random.default_rng(3)
    B, N, T, d = 4, 6, 5, 32
    tau = (rng.random((B, N)) * 7).astype(np.float32)
    t_hat = (7 + rng.random((B, T)) * 7).astype(np.float32)
    V = rng.standard_normal((B, N, d)).astype(np.float32)
    mask = (rng.random((B, N)) < 0.8).astype(np.float32)
    sigma = np.float32(1.7)
    g = rng.standard_normal((B, T, d)).astype(np.float32)
    with CTX():
        want, vjp = jax.vjp(lambda *a: jrecavg.recency_weighted_average(*a, mask, sigma),
                            tau, t_hat, V)
        want_g = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (tau, t_hat, V)]
    with Bf16Products():
        out = trecavg.recency_weighted_average(*ts, torch.from_numpy(mask), torch.tensor(sigma))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    for name, gt, gj, tol in zip(("tau", "t_hat", "V"), grads, want_g,
                                 (FLIP_TOL, FLIP_TOL, dict(atol=1e-5, rtol=1e-5))):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **tol, err_msg=name)
    float32 = trecavg.recavg_reference(*(t.detach() for t in ts), torch.from_numpy(mask),
                                       torch.tensor(sigma))
    assert np.abs(float32.numpy() - np.asarray(want)).max() >= 1e-4


# ---------------------------------------------------------- GPT-2's stages
def test_gpt2_block_stages_match_jax(oracle):
    """TimeLLM's frozen GPT-2 block, stage by stage on the JAX stage's
    input (so no flip carries over): LayerNorm, the fused qkv Dense, the
    scores, the masked softmax, P V and the tanh GELU, each within 2e-6
    (measured 8.3e-7 at most)."""
    from imm_tsf_tpu.layers.attention import masked_softmax as j_masked_softmax

    rng = np.random.default_rng(0)
    B, T, E, H = 2, 24, 768, 12
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    w = (rng.standard_normal((E, 3 * E)) * 0.02).astype(np.float32)
    causal = np.tril(np.ones((T, T), bool))[None, None]
    tt = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    run = lambda f, *a: np.asarray(jax.jit(f)(*a))  # noqa: E731
    with CTX():
        h = run(lambda a: (a - a.mean(-1, keepdims=True))
                * jax.lax.rsqrt(a.var(-1, keepdims=True) + 1e-5), x)
        qkv = run(lambda a, b: a @ b, h, w)
        q, k, v = (z.reshape(B, T, H, 64).transpose(0, 2, 1, 3) for z in np.split(qkv, 3, -1))
        s = run(lambda a, b: jnp.einsum("bhqd,bhkd->bhqk", a, b,
                                        preferred_element_type=jnp.float32) / jnp.sqrt(64.0),
                q, k)
        p = run(lambda a: j_masked_softmax(a, causal), s)
        o = run(lambda a, b: jnp.einsum("bhqk,bhkd->bhqd", a, b), p, v)
        gelu = run(lambda a: jax.nn.gelu(a, approximate=True), qkv)
    with Bf16Products(), torch.inference_mode():
        got = {"ln": F.layer_norm(tt(x), (E,), eps=1e-5), "qkv": tt(h) @ tt(w),
               "scores": torch.einsum("bhqd,bhkd->bhqk", tt(q), tt(k)) * 0.125,
               "softmax": masked_softmax(tt(s), tt(causal)),
               "pv": torch.einsum("bhqk,bhkd->bhqd", tt(p), tt(v)),
               "gelu": F.gelu(tt(qkv), approximate="tanh")}
    for name, want in (("ln", h), ("qkv", qkv), ("scores", s), ("softmax", p), ("pv", o),
                       ("gelu", gelu)):
        np.testing.assert_allclose(got[name].numpy(), want, atol=2e-6, rtol=0, err_msg=name)


def test_frozen_bf16_llm_under_the_mode_equals_its_float32_copy():
    """frozen_param_dtype="bfloat16" with "bfloat16": the bf16 weight is
    widened to float32 before the product and rounding it back is exact, so
    TimeLLM's forward equals the one whose frozen GPT-2 holds float32 copies
    of the same bf16 values, bit for bit."""
    jcfg = JConfig(**{**BF16_BASE, "model": "TimeLLM", **BF16_MODELS["TimeLLM"],
                      "compute_dtype": "bfloat16", "frozen_param_dtype": "bfloat16"})
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    torch.manual_seed(0)
    tm = get_model(tcfg).eval()
    cast_frozen(tm, tcfg.frozen_param_dtype)
    llm = tm.frozen_llm
    assert {p.dtype for p in llm.parameters()} == {torch.bfloat16}
    batch = collate_chunks(jcfg, sample_chunks(3), D_TXT, 14.0, 8)
    batch = tensors({k: v for k, v in batch.items() if isinstance(v, np.ndarray)})
    forward = trainer.make_forward(tcfg, tm, None)
    with torch.inference_mode():
        got = forward(batch)
        llm.float()
        want = forward(batch)
    assert torch.equal(got, want)
    llm.bfloat16()
    with torch.inference_mode():
        float32 = trainer.make_forward(dataclasses.replace(tcfg, compute_dtype="float32"),
                                       tm, None)(batch)
    assert not torch.equal(got, float32)
