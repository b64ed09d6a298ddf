"""The 3xTF32 arithmetic of the fused encoder FFN (kernel #2) and of the
expm's Frechet derivative (kernel #4), emulated on the CPU.

`imm_tsf_torch/csrc/ffn.cu` runs both of its products on the tensor cores
as three TF32 passes (tf32x3.cuh: each float32 operand split into hi =
tf32(x) and lo = tf32(x - hi), a product lo*hi + hi*lo + hi*hi in float32).
These tests do not run the kernels (they run only on the card,
tests/test_torch_cuda.py): they emulate that rounding on the bits of
float32 tensors (tests/test_torch_attn_tf32x3.py) and hold the split
function to the JAX package's oracle.

- FFN: at M 256, D 512, F 2048 (the main path's widths), both activations,
  with and without dropout, against JAX `ffn_reference` within
  chip_smoke's FFN_TOL, the tolerance the kernel is held to on the card.
- Frechet derivative: the pair recursion with every product split, at
  [4, 64, 64] for each of chip_smoke's norms and at n 24, against JAX
  `expm_frechet_taylor12`, per matrix max|err| / max|ref|. Tensor cores
  were to carry kernel #4 only if this stayed within half of
  FRECHET_RTOL at every norm. It does up to norm 6, but at norm 80
  (7 squarings, which amplify every product's rounding) it strays past
  half: kernel #4 keeps its float32 FMA products (PERF.md).

With `-s` each test prints its errors and those of one TF32 pass."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import FFN_TOL, FRECHET_RTOL
from imm_tsf_tpu.ops.expm import expm_frechet_taylor12 as j_frechet
from imm_tsf_tpu.ops.pallas.ffn_kernel import ffn_reference as j_ffn

from imm_tsf_torch.layers.fast_dropout import _keep_mask
from tests.test_torch_attn_tf32x3 import mm_3xtf32, mm_tf32

torch.set_num_threads(1)

KEEP = 0.9
FRECHET_NORMS = (0.01, 0.5, 6.0, 80.0)  # chip_smoke's Frechet checks
_C = [1.0 / math.factorial(i) for i in range(13)]


def ffn_inputs(M, D, F, seed):
    """x ~ N(0, 1) like a LayerNorm output, weights at torch.nn.Linear's
    init scale (chip_smoke.ffn_inputs' distributions)."""
    rng = np.random.default_rng(seed)
    u = lambda shape, fan_in: (rng.uniform(-1, 1, shape) / np.sqrt(fan_in)).astype(np.float32)
    x = rng.standard_normal((M, D)).astype(np.float32)
    w1, b1, w2, b2 = u((D, F), D), u(F, D), u((F, D), F), u(D, F)
    gamma = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(D)).astype(np.float32)
    salts = rng.integers(0, 2**32, (2, 2)).astype(np.uint32)
    return x, w1, b1, w2, b2, gamma, beta, salts


def split_ffn(x, w1, b1, w2, b2, gamma, beta, salts, act, drop, mm):
    """csrc/ffn.cu's function with both products by `mm`."""
    M, D = x.shape
    F = w1.shape[1]
    a1 = mm(x, w1) + b1
    h = torch.relu(a1) if act == "relu" else torch.nn.functional.gelu(a1, approximate="tanh")
    s = salts.to(torch.int64)
    if drop:
        h = torch.where(_keep_mask(s[0, 0], s[0, 1], KEEP, (M, F)), h / KEEP, 0.0)
    a2 = mm(h, w2) + b2
    if drop:
        a2 = torch.where(_keep_mask(s[1, 0], s[1, 1], KEEP, (M, D)), a2 / KEEP, 0.0)
    r = x + a2
    mu = r.mean(-1, keepdim=True)
    var = (r * r).mean(-1, keepdim=True) - mu * mu
    return (r - mu) * torch.rsqrt(var + 1e-5) * gamma + beta


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("drop", [False, True])
def test_3xtf32_ffn_matches_jax(act, drop):
    args = ffn_inputs(256, 512, 2048, seed=7)
    ref = np.asarray(j_ffn(*map(jnp.asarray, args), KEEP, act, drop))
    targs = [torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a) for a in args]
    got = split_ffn(*targs, act, drop, mm_3xtf32).numpy()
    one = split_ffn(*targs, act, drop, mm_tf32).numpy()
    atol, rtol = FFN_TOL
    err = np.abs(got - ref)
    score = lambda e: float((e / (atol + rtol * np.abs(ref))).max())
    print(f"ffn {act} dropout={drop}: 3xTF32 max|err| {err.max():.3e} ({score(err):.3f} x "
          f"FFN_TOL); one TF32 pass max|err| {np.abs(one - ref).max():.3e} "
          f"({score(np.abs(one - ref)):.2f} x FFN_TOL)")
    assert np.isfinite(got).all()
    assert (err <= atol + rtol * np.abs(ref)).all(), f"max |err| {err.max():.3e}"


def split_frechet(M, E, mm, max_squarings=7):
    """L_exp(M)[E] by csrc/frechet.cuh's pair recursion (Taylor-12 on
    M / 2^k, then k squarings), every product by `mm`."""
    k = torch.ceil(torch.log2(M.abs().sum(-1).amax(-1).clamp(min=1.0))).clamp(max=max_squarings)
    s = (2.0 ** -k)[:, None, None]
    I = torch.eye(M.shape[-1])

    def pmm(p, q):
        (X, dX), (Y, dY) = p, q
        return mm(X, Y), mm(X, dY) + mm(dX, Y)

    P1 = (M * s, E * s)
    P2 = pmm(P1, P1)
    P3 = pmm(P2, P1)
    P4 = pmm(P2, P2)

    def lin(a, b, c, d):
        return (a * I + b * P1[0] + c * P2[0] + d * P3[0], b * P1[1] + c * P2[1] + d * P3[1])

    B0, B1, B2 = lin(*_C[0:4]), lin(*_C[4:8]), lin(*_C[8:12])
    mid = pmm(P4, (B2[0] + _C[12] * P4[0], B2[1] + _C[12] * P4[1]))
    outer = pmm(P4, (B1[0] + mid[0], B1[1] + mid[1]))
    R, L = B0[0] + outer[0], B0[1] + outer[1]
    for i in range(max_squarings):
        R2, L2 = pmm((R, L), (R, L))
        sel = (i < k)[:, None, None]
        R, L = torch.where(sel, R2, R), torch.where(sel, L2, L)
    return L


def frechet_case(B, n, norm, seed):
    """(M, E, JAX reference): M Gaussian scaled to inf-norm `norm` per
    matrix, E ~ N(0, 1) (chip_smoke.frechet_inputs' distributions)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n)).astype(np.float32)
    M = (M / np.abs(M).sum(-1).max(-1)[:, None, None] * norm).astype(np.float32)
    E = rng.standard_normal((B, n, n)).astype(np.float32)
    return M, E, np.asarray(j_frechet(jnp.asarray(M), jnp.asarray(E)))


def rel_err(got, ref) -> float:
    """Max over matrices of max|got - ref| / max|ref| (chip_smoke.frechet_rel_err)."""
    return float((np.abs(got - ref).max((1, 2)) / np.abs(ref).max((1, 2))).max())


def frechet_errors(B, n, norm, seed):
    M, E, ref = frechet_case(B, n, norm, seed)
    tM, tE = torch.from_numpy(M), torch.from_numpy(E)
    return (rel_err(split_frechet(tM, tE, mm_3xtf32).numpy(), ref),
            rel_err(split_frechet(tM, tE, mm_tf32).numpy(), ref))


@pytest.mark.parametrize("B,n,norm", [(4, 64, x) for x in FRECHET_NORMS[:-1]] + [(4, 24, 3.0)])
def test_3xtf32_frechet_within_half_the_tolerance_up_to_norm_6(B, n, norm):
    three, one = frechet_errors(B, n, norm, seed=11)
    print(f"frechet [{B},{n},{n}] norm {norm}: 3xTF32 {three:.3e}, one TF32 pass {one:.3e} "
          f"(FRECHET_RTOL / 2 = {FRECHET_RTOL / 2:.1e})")
    assert three < FRECHET_RTOL / 2


def test_3xtf32_frechet_strays_past_half_the_tolerance_at_norm_80():
    """Why kernel #4 keeps float32 FMA products: at norm 80 the seven
    squarings carry the split products' rounding past half of
    FRECHET_RTOL on some matrix of three draws of [8, 64, 64] (draws of
    [4, 64, 64] reach 0.90-1.53 times half of it)."""
    errs = [frechet_errors(8, 64, 80.0, seed)[0] for seed in (1, 2, 3)]
    print(f"frechet [8,64,64] norm 80, three draws: 3xTF32 {[f'{e:.3e}' for e in errs]} "
          f"(FRECHET_RTOL / 2 = {FRECHET_RTOL / 2:.1e})")
    assert max(errs) > FRECHET_RTOL / 2
