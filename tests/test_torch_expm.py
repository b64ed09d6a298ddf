"""The port's batched expm against the JAX package, on the CPU.

On the CPU `ops.expm.expm` and the kernel wrapper `kernels.expm.
batched_expm` run the plain version `expm_taylor12`; these tests hold it
to the JAX package's `expm_taylor12` (the same chain: 2e-6 of the
largest entry, float32 matmuls in another order) and to its Pallas
kernel `expm_pallas` in interpret mode, whose tiered Taylor truncates
differently below float32 eps (1e-5 of the largest entry, the bar of
tests/test_ops_expm.py), across the norms of tests/test_ops_expm.py:54
at n = 24 and at the CRU's n = 64. The CUDA kernel itself is held to
this plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm as scipy_expm

from imm_tsf_tpu.ops.expm import expm_taylor12 as j_expm_taylor12
from imm_tsf_tpu.ops.pallas.expm_kernel import expm_pallas as j_expm_pallas

from imm_tsf_torch.kernels import expm as kexpm
from imm_tsf_torch.ops.expm import expm, expm_taylor12

torch.set_num_threads(1)

NORMS = [0.001, 0.03, 0.2, 1.0, 6.0, 80.0]


def _matrices(n, target_norm, B=4, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n)).astype(np.float32)
    return (M / np.abs(M).sum(-1).max(-1)[:, None, None] * target_norm).astype(np.float32)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@pytest.mark.parametrize("n", [24, 64])
@pytest.mark.parametrize("target_norm", NORMS)
def test_plain_expm_matches_jax_taylor12_and_pallas(n, target_norm):
    M = _matrices(n, target_norm)
    ours = expm_taylor12(torch.from_numpy(M), 7).numpy()
    taylor = np.asarray(j_expm_taylor12(jnp.asarray(M), max_squarings=7))
    pallas = np.asarray(j_expm_pallas(jnp.asarray(M), max_squarings=7))
    assert _rel(ours, taylor) < 2e-6, f"vs expm_taylor12: {_rel(ours, taylor):.2e}"
    assert _rel(ours, pallas) < 1e-5, f"vs expm_pallas: {_rel(ours, pallas):.2e}"
    truth = np.stack([scipy_expm(m.astype(np.float64)) for m in M])
    assert _rel(ours, truth) < 1e-5


def test_cpu_tensors_take_the_plain_version():
    M = torch.from_numpy(_matrices(64, 6.0))
    before = kexpm.launches
    want = expm_taylor12(M, 7)
    assert torch.equal(expm(M), want) and torch.equal(kexpm.batched_expm(M), want)
    assert expm(M.double()).dtype == torch.float64  # off the kernel, the caller's dtype
    assert kexpm.launches == before  # CPU tensors never reach the kernel


def test_zero_matrix_gives_exactly_identity():
    """Pad steps of the CRU scan have dt = 0: their Van Loan block is 0."""
    out = expm(torch.zeros(3, 64, 64))
    assert torch.equal(out, torch.eye(64).expand(3, 64, 64))


def test_unbatched_and_leading_dims():
    """[..., n, n] off the kernel's [B, n, n] takes the same chain."""
    M = torch.from_numpy(_matrices(12, 3.0, B=6)).reshape(2, 3, 12, 12)
    got = expm(M)
    want = expm_taylor12(M.reshape(6, 12, 12)).reshape(2, 3, 12, 12)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
