"""The port's kernel modules against the JAX package, on the CPU.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the JAX oracle and the Pallas kernel (interpret
mode, as tests/test_ffn_kernel.py runs it). The CUDA kernels themselves
run only on the card: tests/test_torch_cuda.py holds them against these
plain versions there, and chip_smoke.py at the serving shapes.

Tolerances: float32 with a different summation order (torch vs XLA
matmuls over K=D then K=F), so the FFN agrees to 2e-5 absolute on
LayerNorm-scaled outputs; the recency average to rtol 1e-5 / atol 1e-6
(the Pallas kernel pre-divides by sigma, an ulp-level gap)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imm_tsf_tpu.layers.fast_dropout import _keep_mask as j_keep_mask
from imm_tsf_tpu.ops.pallas import ffn_kernel as jffn
from imm_tsf_tpu.ops.pallas import fusion_kernels as jrec

from imm_tsf_torch.kernels import ffn as tffn
from imm_tsf_torch.kernels import recavg as trec
from imm_tsf_torch.layers.fast_dropout import _keep_mask as t_keep_mask

torch.set_num_threads(1)

KP = 0.9


@pytest.mark.parametrize("s0,s1,keep,shape", [
    (0, 0, 0.9, (7, 13)),
    (0x12345678, 0x9ABCDEF0, 0.9, (200, 256)),
    (0xFFFFFFFF, 1, 0.5, (3, 5, 11)),
    (2**31 + 7, 2**32 - 3, 0.999, (64, 128)),
    (17, 99, 1.0, (10, 10)),
])
def test_keep_mask_bit_identical(s0, s1, keep, shape):
    j = np.asarray(j_keep_mask(np.uint32(s0), np.uint32(s1), keep, shape))
    t = t_keep_mask(s0, s1, keep, shape).numpy()
    assert t.shape == j.shape
    np.testing.assert_array_equal(t, j)
    # salts as 0-d tensors (how ffn_reference passes them) give the same bits
    t2 = t_keep_mask(torch.tensor(s0), torch.tensor(s1), keep, shape).numpy()
    np.testing.assert_array_equal(t2, j)


def _ffn_inputs(M=200, D=128, F=256, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, D)).astype(np.float32)
    w1 = (rng.standard_normal((D, F)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal(F) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((F, D)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal(D) * 0.1).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(D)).astype(np.float32)
    salts = rng.integers(0, 2**32, (2, 2)).astype(np.uint32)
    return x, w1, b1, w2, b2, gamma, beta, salts


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("drop", [False, True])
def test_plain_ffn_matches_jax_reference_and_pallas(act, drop):
    args = _ffn_inputs()  # ragged M=200: not a multiple of any row block
    ref = np.asarray(jffn.ffn_reference(*map(jnp.asarray, args), KP, act, drop))
    pallas = np.asarray(jffn.fused_encoder_ffn(*map(jnp.asarray, args), KP, act, drop))
    targs = [torch.from_numpy(a) for a in args]
    before = tffn.launches
    port = tffn.fused_encoder_ffn(*targs, KP, act, drop).numpy()
    plain = tffn.ffn_reference(*targs, KP, act, drop).numpy()
    assert tffn.launches == before  # CPU tensors never reach the kernel
    np.testing.assert_array_equal(port, plain)
    np.testing.assert_allclose(port, ref, atol=2e-5, rtol=0)
    np.testing.assert_allclose(port, pallas, atol=2e-5, rtol=0)


def test_plain_ffn_accepts_linear_weight_views():
    """The encoder layer passes `linear.weight.t()` views and no salts in
    eval; the result equals contiguous [D, F] weights."""
    x, w1, b1, w2, b2, g, be, _ = (torch.from_numpy(a) for a in _ffn_inputs(M=37, D=32, F=64))
    w1_view = w1.t().contiguous().t()
    w2_view = w2.t().contiguous().t()
    assert not w1_view.is_contiguous()
    a = tffn.fused_encoder_ffn(x, w1_view, b1, w2_view, b2, g, be, None, KP, "gelu", False)
    b = tffn.ffn_reference(x, w1, b1, w2, b2, g, be, None, KP, "gelu", False)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def _recavg_random(seed=0, B=4, N=6, T=5, d=16):
    rng = np.random.default_rng(seed)
    tau = rng.uniform(0, 5, (B, N)).astype(np.float32)
    t_hat = rng.uniform(3, 8, (B, T)).astype(np.float32)
    V = rng.standard_normal((B, N, d)).astype(np.float32)
    mask = (rng.random((B, N)) < 0.7).astype(np.float32)
    mask[-1] = 0.0  # a sample with no notes
    return tau, t_hat, V, mask


@pytest.mark.parametrize("case", ["fixture", "random"])
@pytest.mark.parametrize("sigma", [1.0, 0.37])
def test_plain_recavg_matches_jax(case, sigma, ragged_fusion_batch):
    if case == "fixture":
        fb = ragged_fusion_batch
        tau, t_hat, V, mask = fb["tau"], fb["t_hat"], fb["notes"], fb["notes_mask"]
    else:
        tau, t_hat, V, mask = _recavg_random()
    s = np.float32(sigma)
    jargs = (jnp.asarray(tau), jnp.asarray(t_hat), jnp.asarray(V), jnp.asarray(mask),
             jnp.asarray(s))
    pallas = np.asarray(jrec.recency_weighted_average(*jargs))
    xla = np.asarray(jrec._recavg_xla(*jargs)[0])
    targs = [torch.from_numpy(a) for a in (tau, t_hat, V, mask)]
    before = trec.launches
    port = trec.recency_weighted_average(*targs, torch.tensor(s)).numpy()
    assert trec.launches == before
    assert port.shape == pallas.shape
    np.testing.assert_allclose(port, xla, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port, pallas, rtol=1e-5, atol=1e-6)
    empty = mask.sum(1) == 0
    assert (port[empty] == 0).all()  # no notes: denominator at the clamp, E = 0
