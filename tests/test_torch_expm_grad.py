"""The port's expm backward against the JAX package, on the CPU.

`expm_frechet_taylor12`, the plain version of kernel #4, against the JAX
package's (the same pair recursion: 2e-6 of the largest entry, float32
products in another order) and its Pallas kernel `expm_frechet_pallas` in
interpret mode (2e-5 of each matrix's largest entry, the bar of
tests/test_ops_expm.py:117); the port's differentiable `expm` against
`jax.vjp` of the JAX package's custom-VJP `expm` at n 24 and 64 across
inf-norms 0.01-80 (on the CPU both take the block form: 1e-5 of the
largest entry); and the block form against the pair form, which compute
the same adjoint (float64, 1e-10). The CUDA kernel itself is held to the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imm_tsf_tpu.ops.expm import expm as j_expm
from imm_tsf_tpu.ops.expm import expm_frechet_taylor12 as j_frechet
from imm_tsf_tpu.ops.pallas.expm_kernel import expm_frechet_pallas as j_frechet_pallas

from imm_tsf_torch.kernels import expm as kexpm
from imm_tsf_torch.ops.expm import expm, expm_adjoint, expm_frechet_taylor12, expm_plain

torch.set_num_threads(1)

NORMS = [0.01, 0.2, 1.0, 6.0, 80.0]


def _pair(n, norm, B=4, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    M = (M / np.abs(M).sum(-1).max(-1)[:, None, None] * norm).astype(np.float32)
    return M, rng.standard_normal((B, n, n)).astype(np.float32)


def _rel(got, want):
    """max|got - want| / max|want| over each matrix, the worst matrix."""
    err = np.abs(got - want).max(axis=(-2, -1)) / np.abs(want).max(axis=(-2, -1))
    return float(err.max())


@pytest.mark.parametrize("n", [24, 64])
@pytest.mark.parametrize("norm", NORMS)
def test_plain_frechet_matches_jax(n, norm):
    M, E = _pair(n, norm)
    got = expm_frechet_taylor12(torch.from_numpy(M), torch.from_numpy(E), 7).numpy()
    want = np.asarray(j_frechet(jnp.asarray(M), jnp.asarray(E), 7))
    assert _rel(got, want) < 2e-6


@pytest.mark.parametrize("norm", [0.01, 1.0, 6.0, 80.0])
def test_plain_frechet_matches_pallas_kernel(norm):
    M, E = _pair(64, norm, B=3, seed=1)
    before = kexpm.frechet_launches
    got = kexpm.batched_expm_frechet(torch.from_numpy(M), torch.from_numpy(E), 7).numpy()
    assert kexpm.frechet_launches == before  # CPU tensors take the plain version
    want = np.asarray(j_frechet_pallas(jnp.asarray(M), jnp.asarray(E), 7))
    assert _rel(got, want) < 2e-5


@pytest.mark.parametrize("n", [24, 64])
@pytest.mark.parametrize("norm", NORMS)
def test_expm_vjp_matches_jax(n, norm):
    M, G = _pair(n, norm, seed=2)
    want_y, vjp = jax.vjp(lambda m: j_expm(m, 7), jnp.asarray(M))
    (want_g,) = vjp(jnp.asarray(G))
    for fn in (expm, expm_plain):  # the dispatch and the plain route
        Mt = torch.from_numpy(M).requires_grad_()
        y = fn(Mt, 7)
        (g,) = torch.autograd.grad(y, Mt, torch.from_numpy(G))
        assert _rel(y.detach().numpy(), np.asarray(want_y)) < 1e-5
        assert _rel(g.numpy(), np.asarray(want_g)) < 1e-5


@pytest.mark.parametrize("n,norm", [(8, 0.05), (24, 3.0), (64, 0.5), (64, 40.0)])
def test_block_form_equals_pair_form(n, norm):
    """L_exp(M^T)[G] two ways, in float64: the 2n-square block exp the
    CPU backward runs, and the pair recursion kernel #4 runs."""
    M, G = (torch.from_numpy(a).double() for a in _pair(n, norm, seed=3))
    block = expm_adjoint(M, G, 7)
    pair = expm_frechet_taylor12(M.transpose(-1, -2), G, 7)
    torch.testing.assert_close(block, pair, rtol=1e-10, atol=1e-10 * float(pair.abs().max()))
