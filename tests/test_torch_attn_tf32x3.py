"""The arithmetic of the causal-attention kernel's 3xTF32 products, on the CPU.

`imm_tsf_torch/csrc/attn.cu` computes S = Q K^T and O = P V on the tensor
cores: each float32 operand x is split into hi = tf32(x) and lo =
tf32(x - hi) (`cvt.rna.tf32.f32`: round to 10 mantissa bits, ties away
from zero) and a product takes lo*hi + hi*lo + hi*hi, accumulated in
float32. These tests do not run the kernel (it runs only on the card,
tests/test_torch_cuda.py): they emulate the rounding on the bits of float32
tensors and hold the split attention to the JAX package's
`attention_reference` at every embed_notes bucket, within chip_smoke's
ATTN_TOL, the tolerance the kernel is held to on the card. With `-s` they
print the error of one TF32 pass at the same shapes, which misses that
tolerance (PERF.md).

Also here: the pure-Python choice of the cluster size of the kernels that
split a matrix over a thread-block cluster (#4 and #7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATTN_TOL, attn_ragged_inputs, bucket_lo
from imm_tsf_tpu.ops.pallas.attn_kernel import attention_reference as j_reference

from imm_tsf_torch.kernels._cluster import cluster_size
from imm_tsf_torch.llm.loader import EMBED_BUCKETS

torch.set_num_threads(1)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on float32: keep 10 mantissa bits, round half away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_3xtf32(a, b):
    """a @ b as the kernel's mma passes: lo*hi, then hi*lo, then hi*hi."""
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_tf32(a, b):
    return tf32(a) @ tf32(b)


def split_attention(q, k, v, pad, mm):
    """The kernel's function with its products by `mm`: masked scores
    scaled by 1/sqrt(D), P = exp(s - rowmax), O = (P V) / rowsum, exact
    zeros where a row keeps no key."""
    T, D = q.shape[2], q.shape[3]
    s = mm(q, k.transpose(-1, -2)) * (1.0 / np.sqrt(D))
    keep = torch.ones((T, T), dtype=torch.bool).tril()[None, None] & (pad > 0)[:, None, None, :]
    s = torch.where(keep, s, torch.tensor(-torch.inf))
    m = s.amax(-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - torch.where(torch.isinf(m), 0.0, m)), 0.0)
    l = p.sum(-1, keepdim=True)
    return mm(p, v) * torch.where(l > 0, 1.0 / l, 0.0)


def bucket_inputs(B, H, T, D, seed=0):
    """q, k, v ~ N(0, 1) and pad right-padded as embed_notes' bucket T
    pads its notes: lengths uniform in [bucket_lo(T), T]."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3))
    n = rng.integers(bucket_lo(T), T + 1, size=B)
    pad = (np.arange(T)[None] < n[:, None]).astype(np.float32)
    return q, k, v, pad


def ragged_inputs():
    q, k, v, pad = attn_ragged_inputs(torch.Generator().manual_seed(0), torch.device("cpu"))
    return tuple(t.numpy() for t in (q, k, v, pad))


def max_err(got, want) -> float:
    """Max |err| after checking |err| <= ATTN_TOL's atol + rtol|want|."""
    atol, rtol = ATTN_TOL
    err = np.abs(got - want)
    assert np.isfinite(got).all()
    assert (err <= atol + rtol * np.abs(want)).all(), f"max |err| {err.max():.3e}"
    return float(err.max())


@pytest.mark.parametrize("x", [
    np.float32([1.0, -1.0, 0.0, 3.0e-20, -7.5e12]),
    np.random.default_rng(1).standard_normal(4096).astype(np.float32),
    np.random.default_rng(2).standard_normal(4096).astype(np.float32) * 1e-3,
])
def test_split_keeps_float32_accuracy(x):
    t = torch.from_numpy(x)
    hi, lo = split(t)
    for part in (hi, lo):  # at most 10 mantissa bits: the low 13 are 0
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    gap = (hi.double() + lo.double() - t.double()).abs()
    assert bool((gap <= 2.0 ** -21 * t.double().abs()).all())


def test_tf32_rounds_half_away_from_zero():
    one = torch.tensor([1.0], dtype=torch.float32)
    half_ulp = 2.0 ** -11  # 1 + half of tf32's last place at 1
    x = torch.tensor([1.0 + half_ulp, -(1.0 + half_ulp), 1.0 + half_ulp / 2], dtype=torch.float32)
    got = tf32(x)
    assert got.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]
    assert tf32(one).item() == 1.0


@pytest.mark.parametrize("case", [f"bucket-{T}" for T in EMBED_BUCKETS] + ["d128", "ragged"])
def test_3xtf32_attention_matches_jax(case):
    if case == "ragged":
        q, k, v, pad = ragged_inputs()
    elif case == "d128":
        q, k, v, pad = bucket_inputs(2, 2, 130, 128, seed=3)
    else:
        T = int(case.split("-")[1])
        B, H = (4, 3) if T <= 128 else (2, 2)
        q, k, v, pad = bucket_inputs(B, H, T, 64, seed=T)
    ref = np.asarray(j_reference(*(jnp.asarray(a) for a in (q, k, v, pad))))
    args = [torch.from_numpy(a) for a in (q, k, v, pad)]
    got = split_attention(*args, mm_3xtf32).numpy()
    err = max_err(got, ref)
    one = np.abs(split_attention(*args, mm_tf32).numpy() - ref)
    atol, rtol = ATTN_TOL
    score = float((one / (atol + rtol * np.abs(ref))).max())
    print(f"{case} {tuple(q.shape)}: 3xTF32 max|err| {err:.3e}; one TF32 pass max|err| "
          f"{one.max():.3e}, {score:.1f} x ATTN_TOL")
    if case == "ragged":
        assert (got[0, :, 0] == 0).all() and (got[1] == 0).all()


def test_one_tf32_pass_misses_the_tolerance():
    """Why three passes: one TF32 pass at the bucket-32 shape's widths
    leaves ATTN_TOL."""
    q, k, v, pad = bucket_inputs(4, 3, 32, 64, seed=32)
    ref = np.asarray(j_reference(*(jnp.asarray(a) for a in (q, k, v, pad))))
    got = split_attention(*(torch.from_numpy(a) for a in (q, k, v, pad)), mm_tf32).numpy()
    with pytest.raises(AssertionError):
        max_err(got, ref)


@pytest.mark.parametrize("B,active,want", [
    (32, {1: 132, 2: 66, 4: 33}, 4),   # the trained batch: one wave of 128 CTAs
    (32, {1: 132, 2: 66, 4: 32}, 4),
    (33, {1: 132, 2: 66, 4: 32}, 2),   # two waves of 4 cost as much as one of 2
    (64, {1: 132, 2: 66, 4: 33}, 2),
    (1, {1: 132, 2: 66, 4: 33}, 4),
    (500, {1: 132, 2: 66, 4: 33}, 1),  # every size takes as long: the fewest barriers
    (200, {1: 132, 2: 66, 4: 33}, 4),
    (0, {1: 132, 2: 66, 4: 33}, 1),
    (8, {1: 132, 2: 66, 4: 0}, 2),     # no cluster of 4 fits
])
def test_cluster_size_choice(B, active, want):
    assert cluster_size(B, active) == want


def test_cluster_size_refuses_a_card_without_room():
    with pytest.raises(ValueError, match="no cluster size"):
        cluster_size(4, {1: 0, 2: 0, 4: 0})
