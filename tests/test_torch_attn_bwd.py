"""Kernel #3's backward, the port against the JAX package, on the CPU.

`kernels.attn.fused_causal_attention` is an autograd Function when a
gradient is in flight: its forward is the CUDA kernel on the card and the
plain version on CPU tensors, its backward `attention_backward_reference`
(the plain transcription of the JAX package's `_attn_bwd`). These tests
hold the Function on CPU tensors against `jax.vjp` of the JAX
`fused_causal_attention` (the Pallas kernel in interpret mode, as
tests/test_attn_kernel.py runs it, and its custom VJP) with ragged pads,
a row that sees no key and a sample with no real token: output, dq, dk
and dv to 1e-5 (float32, another summation order). In float64 the hand
backward equals autograd of the plain forward to 1e-12. The CUDA route
is held to the plain one on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imm_tsf_tpu.ops.pallas.attn_kernel import fused_causal_attention as j_fused

from imm_tsf_torch.kernels import attn

torch.set_num_threads(1)

TOL = 1e-5


def _inputs(T, pad_kind, B=3, H=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(4))
    pad = np.ones((B, T), np.float32)
    if pad_kind == "ragged":  # right-padded, token 0 padded in one sample, one empty
        pad[0, 9:] = 0.0
        pad[1, 0] = 0.0
        pad[2] = 0.0
    elif pad_kind == "token0":
        pad[:, 0] = 0.0
    return q, k, v, pad, g


@pytest.mark.parametrize("T,pad_kind", [(13, "ragged"), (24, "none"), (8, "token0")])
def test_backward_matches_jax_vjp(T, pad_kind):
    q, k, v, pad, g = _inputs(T, pad_kind)
    want, vjp = jax.vjp(j_fused, *(jnp.asarray(a) for a in (q, k, v, pad)))
    wq, wk, wv, wpad = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tpad = torch.from_numpy(pad)
    launches, calls = attn.launches, attn.backward_calls
    out = attn.fused_causal_attention(tq, tk, tv, tpad)
    out.backward(torch.from_numpy(g))
    assert attn.launches == launches  # CPU tensors take the plain forward
    assert attn.backward_calls == calls + 1
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    for name, got, ref in (("dq", tq.grad, wq), ("dk", tk.grad, wk), ("dv", tv.grad, wv)):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL, err_msg=name)
    np.testing.assert_array_equal(wpad, 0.0)  # the JAX pad cotangent; the port returns none
    if pad_kind == "ragged":
        # an empty sample gets nothing; a row that sees no key adds nothing
        for grad in (tq.grad, tk.grad, tv.grad):
            assert bool((grad[2] == 0).all())
        assert bool((tq.grad[1, :, 0] == 0).all())


@pytest.mark.parametrize("pad_kind", ["ragged", "none"])
def test_hand_backward_is_autograd_of_plain_forward_in_float64(pad_kind):
    q, k, v, pad, g = (torch.from_numpy(a).double() for a in _inputs(11, pad_kind, D=8))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    attn.attention_reference(*leaves, pad).backward(g)
    got = attn.attention_backward_reference(q, k, v, pad, g)
    for name, a, b in zip(("dq", "dk", "dv"), got, leaves):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b.grad, atol=1e-12, rtol=1e-12, msg=name)


def test_no_graph_without_a_gradient():
    """Under no_grad (the embedding stage runs in inference mode) the plain
    forward runs without the Function: no graph, no backward."""
    q, k, v, pad, _ = (torch.from_numpy(a) for a in _inputs(10, "ragged"))
    with torch.no_grad():
        out = attn.fused_causal_attention(q.requires_grad_(), k, v, pad)
    assert out.grad_fn is None and not out.requires_grad
    torch.testing.assert_close(out, attn.attention_reference(q, k, v, pad), rtol=0, atol=0)
