"""JAX's default PRNG in NumPy: threefry2x32, `jax.random.randint` and
`jax.random.normal`.

ProbSparse attention (layers/prob_attention.py) samples its keys in eval
with `jax.random.randint(jax.random.PRNGKey(0), (L_Q, U_part), 0, L_K)`
(after imm_tsf_tpu/layers/prob_attention.py:53-56), so served answers
depend on those exact integers. This module reproduces them bit for bit
for the default `threefry2x32` implementation with
`jax_threefry_partitionable` on (JAX's default since 0.5):

  - `PRNGKey(seed)` is the key (seed >> 32, seed & 0xFFFFFFFF);
  - a split into n keys hashes the counters (0, i), i < n, and key i is
    the hash's two output words;
  - 32 random bits at flat index i are the two output words of the hash
    of the counter pair (i >> 32, i & 0xFFFFFFFF), xor-ed;
  - `randint` splits its key in two, draws 32 bits from each (high and
    low) and returns minval + (hi % span * (2^32 % span) + lo % span) % span,
    in uint32 arithmetic.

  - `normal` (float32) is sqrt(2) * erf_inv(u), u uniform on
    [nextafter(-1, 0), 1): 23 of the 32 random bits become the mantissa of
    a float in [1, 2), less 1, scaled into that range; erf_inv is XLA's
    float32 polynomial (Giles), evaluated in float32 with fused
    multiply-adds. XLA's log1p differs from NumPy's by an ulp here and
    there, so a draw may differ from JAX's by a few float32 ulps (under
    1e-6 at the sizes served).
    The LatentODE's and NeuralFlow's eval_sample_traj serve that draw.

All arithmetic is on uint32 NumPy arrays, which wrap like the hardware.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 block (20 rounds) of counters (x0, x1) under `key`:
    jax._src.prng._threefry2x32_lowering, unrolled."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> tuple[int, int]:
    """jax.random.PRNGKey(seed) as its two uint32 words."""
    return (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF


def _counters(n: int):
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key: tuple[int, int], n: int = 2) -> list[tuple[int, int]]:
    """jax.random.split(key, n) (the partitionable, fold-like split)."""
    b0, b1 = threefry2x32(key, *_counters(n))
    return [(int(a), int(b)) for a, b in zip(b0, b1)]


def random_bits32(key: tuple[int, int], shape: tuple) -> np.ndarray:
    """32 uniform random bits of `shape` (uint32), as jax.random.bits."""
    n = int(np.prod(shape, dtype=np.int64))
    b0, b1 = threefry2x32(key, *_counters(n))
    return (b0 ^ b1).reshape(shape)


def randint(key: tuple[int, int], shape: tuple, minval: int, maxval: int) -> np.ndarray:
    """jax.random.randint(key, shape, minval, maxval) for the default int32
    dtype and Python-int bounds: int32 values in [minval, maxval)."""
    k1, k2 = split(key, 2)
    hi, lo = random_bits32(k1, shape), random_bits32(k2, shape)
    span = np.uint32(maxval - minval if maxval > minval else 1)
    with np.errstate(over="ignore"):  # uint32 scalars wrap, as lax.mul does
        multiplier = np.uint32(2**16) % span
        multiplier = (multiplier * multiplier) % span
        offset = ((hi % span) * multiplier + lo % span) % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)


# XLA's ErfInv32 (Giles' single-precision approximation), by branch
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erf_inv32(x: np.ndarray) -> np.ndarray:
    f = np.float32
    w = -np.log1p(-x * x)
    lt = w < f(5.0)
    w = np.where(lt, w - f(2.5), np.sqrt(w) - f(3.0)).astype(np.float32)
    p = np.where(lt, f(_ERFINV_W_LT_5[0]), f(_ERFINV_W_GE_5[0])).astype(np.float32)
    for a, b in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        c = np.where(lt, f(a), f(b))
        # c + p * w rounded once, as a fused multiply-add: nearer XLA's draws than two roundings
        p = (c.astype(np.float64) + p.astype(np.float64) * w).astype(np.float32)
    return np.where(np.abs(x) == f(1), x * np.finfo(np.float32).max, p * x).astype(np.float32)


def normal(key: tuple[int, int], shape: tuple) -> np.ndarray:
    """jax.random.normal(key, shape) for the default float32 dtype."""
    f = np.float32
    lo = np.nextafter(f(-1.0), f(0.0), dtype=np.float32)
    bits = random_bits32(key, shape)
    floats = ((bits >> np.uint32(9)) | np.float32(1.0).view(np.uint32)).view(np.float32) - f(1.0)
    u = np.maximum(lo, floats * (f(1.0) - lo) + lo)
    return (f(np.sqrt(2)) * _erf_inv32(u)).astype(np.float32)
