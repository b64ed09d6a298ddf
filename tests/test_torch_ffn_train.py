"""Kernel #2's training form and its backward, the port against the JAX
package, on the CPU.

On the CPU `fused_encoder_ffn` runs its plain versions: the training
form's forward (`ffn_forward_reference(with_residuals=True)`: out, a1, r)
and the hand backward (`ffn_backward_reference`, a transcription of
`_ffn_bwd`). They are held to the Pallas kernel's training form
(`_ffn_forward_pallas(with_residuals=True)`, interpret mode, as
tests/test_ffn_kernel.py runs it) and to `jax.vjp` of the JAX
`fused_encoder_ffn` (its custom VJP over the interpret-mode kernel), under
the same hash-dropout salts. The CUDA kernel's training form is held to
these plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: float32 in another summation order (torch vs XLA products
over K = D, then K = F): forward and residuals 2e-5 absolute, gradients
1e-4 absolute + 1e-4 relative (batch-summed weight cotangents).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imm_tsf_tpu.ops.pallas import ffn_kernel as jffn

from imm_tsf_torch.kernels import ffn as tffn

torch.set_num_threads(1)

KP = 0.9
FWD_TOL = dict(atol=2e-5, rtol=0)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
NAMES = ("x", "w1", "b1", "w2", "b2", "gamma", "beta")


def _inputs(M=48, D=64, F=128, seed=0):
    """tests/test_ffn_kernel.py:_inputs' draws, in numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, D)).astype(np.float32)
    w1 = (rng.standard_normal((D, F)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal(F) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((F, D)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal(D) * 0.1).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(D)).astype(np.float32)
    salts = rng.integers(0, 2**32, (2, 2)).astype(np.uint32)
    g = rng.standard_normal((M, D)).astype(np.float32)
    return [x, w1, b1, w2, b2, gamma, beta, salts], g


def _torch(args):
    params = [torch.from_numpy(a.copy()) for a in args[:7]]
    return params, torch.from_numpy(args[7].astype(np.int64))


@pytest.mark.parametrize("M", [48, 37])  # 37: a ragged row block
@pytest.mark.parametrize("act,drop", [("gelu", True), ("relu", True), ("gelu", False)])
def test_training_form_matches_pallas_interpret(M, act, drop):
    args, _ = _inputs(M=M)
    want = jffn._ffn_forward_pallas(*map(jnp.asarray, args), KP, act, drop,
                                    with_residuals=True)
    params, salts = _torch(args)
    got = tffn.ffn_forward_reference(*params, salts, KP, act, drop, with_residuals=True)
    for name, g, w in zip(("out", "a1", "r"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL, err_msg=name)
    # the eval form's plain version is the training form's `out`
    assert torch.equal(tffn.ffn_reference(*params, salts, KP, act, drop), got[0])


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("drop", [True, False])
def test_gradients_match_jax_vjp(act, drop):
    args, g = _inputs()
    jargs = list(map(jnp.asarray, args))
    out_j, vjp = jax.vjp(
        lambda *p: jffn.fused_encoder_ffn(*p, jargs[7], KP, act, drop), *jargs[:7])
    want = vjp(jnp.asarray(g))
    params, salts = _torch(args)
    for p in params:
        p.requires_grad_()
    before = (tffn.launches, tffn.train_launches)
    out = tffn.fused_encoder_ffn(*params, salts, KP, act, drop)
    grads = torch.autograd.grad(out, params, torch.from_numpy(g))
    assert (tffn.launches, tffn.train_launches) == before  # CPU tensors never launch
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **FWD_TOL)
    for name, gt, gj in zip(NAMES, grads, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_hand_backward_matches_autograd_of_the_plain_forward(act):
    """The hand VJP against torch autograd through the plain forward (the
    plain route's backward), float64 so only the algebra can differ."""
    args, g = _inputs(M=40, D=32, F=96, seed=1)
    params = [torch.from_numpy(a.astype(np.float64)).requires_grad_() for a in args[:7]]
    salts = torch.from_numpy(args[7].astype(np.int64))
    out = tffn.ffn_reference(*params, salts, KP, act, True)
    want = torch.autograd.grad(out, params, torch.from_numpy(g.astype(np.float64)))
    with torch.no_grad():
        _, a1, r = tffn.ffn_forward_reference(*params, salts, KP, act, True,
                                              with_residuals=True)
        got = tffn.ffn_backward_reference(params[0], params[1], params[3], params[5], salts,
                                          a1, r, torch.from_numpy(g.astype(np.float64)),
                                          KP, act, True)
    for name, gt, w in zip(NAMES, got, want):
        np.testing.assert_allclose(gt.numpy(), w.numpy(), atol=1e-10, rtol=1e-9,
                                   err_msg=name)


def test_linear_weight_view_gradients_reach_the_linear_weights():
    """EncoderLayer passes `conv1.weight.t()` and `conv2.weight.t()`: their
    gradients land on the nn.Linear weights as the transposed JAX kernel
    cotangents."""
    args, g = _inputs()
    jargs = list(map(jnp.asarray, args))
    _, vjp = jax.vjp(lambda *p: jffn.fused_encoder_ffn(*p, jargs[7], KP, "gelu", True),
                     *jargs[:7])
    want = vjp(jnp.asarray(g))
    D, F = args[1].shape
    conv1, conv2 = torch.nn.Linear(D, F), torch.nn.Linear(F, D)
    with torch.no_grad():
        conv1.weight.copy_(torch.from_numpy(args[1].T.copy()))
        conv1.bias.copy_(torch.from_numpy(args[2]))
        conv2.weight.copy_(torch.from_numpy(args[3].T.copy()))
        conv2.bias.copy_(torch.from_numpy(args[4]))
    params, salts = _torch(args)
    out = tffn.fused_encoder_ffn(params[0], conv1.weight.t(), conv1.bias, conv2.weight.t(),
                                 conv2.bias, params[5], params[6], salts, KP, "gelu", True)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(conv1.weight.grad.numpy(), np.asarray(want[1]).T, **GRAD_TOL)
    np.testing.assert_allclose(conv2.weight.grad.numpy(), np.asarray(want[3]).T, **GRAD_TOL)
    np.testing.assert_allclose(conv1.bias.grad.numpy(), np.asarray(want[2]), **GRAD_TOL)
    np.testing.assert_allclose(conv2.bias.grad.numpy(), np.asarray(want[4]), **GRAD_TOL)


def test_eval_form_runs_without_a_gradient_in_flight():
    """No gradient in flight: the eval form (no residuals), no graph."""
    args, _ = _inputs()
    params, salts = _torch(args)
    params[1].requires_grad_()
    with torch.no_grad():
        out = tffn.fused_encoder_ffn(*params, salts, KP, "gelu", True)
    assert out.grad_fn is None
    out = tffn.fused_encoder_ffn(*params, salts, KP, "gelu", True)
    assert type(out.grad_fn).__name__ == "_FusedFFNBackward"
