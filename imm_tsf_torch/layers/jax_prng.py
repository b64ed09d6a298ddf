"""JAX's default PRNG in NumPy: threefry2x32 and `jax.random.randint`.

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
