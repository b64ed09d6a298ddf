"""The port's causal-attention module against the JAX package, on the CPU.

On the CPU `kernels.attn.fused_causal_attention` runs its plain version;
these tests hold it against the Pallas kernel (interpret mode, as
tests/test_attn_kernel.py runs it) and against the JAX oracle
`attention_reference`, to 1e-5 (float32, another summation order). The
CUDA kernel runs only on the card: tests/test_torch_cuda.py and
chip_smoke.py hold it against this plain version there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imm_tsf_tpu.ops.pallas.attn_kernel import attention_reference as j_reference
from imm_tsf_tpu.ops.pallas.attn_kernel import fused_causal_attention as j_fused

from imm_tsf_torch.kernels import attn

torch.set_num_threads(1)


def _inputs(T, pad_kind, B=2, H=3, D=16, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3))
    pad = np.ones((B, T), np.float32)
    if pad_kind == "right":  # notes of different lengths, right-padded
        pad[0, 25:] = 0.0
        pad[1, 11:] = 0.0
    elif pad_kind == "token0":  # row 0 sees no key
        pad[:, 0] = 0.0
    elif pad_kind == "all":  # a sample with no real token
        pad[1] = 0.0
    return q, k, v, pad


@pytest.mark.parametrize("T,pad_kind", [
    (40, "none"),
    (37, "right"),   # T not a multiple of 8
    (8, "token0"),
    (12, "all"),
])
def test_plain_attention_matches_jax(T, pad_kind):
    q, k, v, pad = _inputs(T, pad_kind)
    jargs = [jnp.asarray(a) for a in (q, k, v, pad)]
    pallas = np.asarray(j_fused(*jargs))
    ref = np.asarray(j_reference(*jargs))
    before = attn.launches
    port = attn.fused_causal_attention(*(torch.from_numpy(a) for a in (q, k, v, pad))).numpy()
    assert attn.launches == before  # CPU tensors never reach the kernel
    assert port.shape == q.shape and np.isfinite(port).all()
    np.testing.assert_allclose(port, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(port, pallas, atol=1e-5, rtol=1e-5)
    if pad_kind == "token0":
        np.testing.assert_array_equal(port[:, :, 0], 0.0)
    if pad_kind == "all":
        np.testing.assert_array_equal(port[1], 0.0)


def test_wrapper_refuses_other_devices():
    q = torch.empty((1, 1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attn.fused_causal_attention(q, q, q, torch.empty((1, 4), device="meta"))
