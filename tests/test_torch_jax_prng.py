"""The port's NumPy threefry2x32 and `randint` against JAX's, bit for bit
(the default threefry implementation with `jax_threefry_partitionable`,
JAX's default): ProbSparse attention's eval sample
`jax.random.randint(PRNGKey(0), (L_Q, U_part), 0, L_K)` at every length
pair of a grid that covers the served and trained Informer lengths."""

import math

import jax
import numpy as np
import pytest
import torch

from imm_tsf_torch.layers import jax_prng

torch.set_num_threads(1)

LENGTHS = (1, 2, 12, 19, 24, 25, 36, 48, 96, 336)


def test_jax_runs_the_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("L_Q", LENGTHS)
def test_randint_is_jax_randint(L_Q):
    for L_K in LENGTHS:
        U = min(3 * math.ceil(math.log(max(L_K, 2))), L_K)  # the preset's factor 3
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (L_Q, U), 0, L_K))
        got = jax_prng.randint(jax_prng.prng_key(0), (L_Q, U), 0, L_K)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 42, 12345])
def test_keys_split_and_bits_are_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert jax_prng.prng_key(seed) == tuple(int(w) for w in np.asarray(key))
    want = np.asarray(jax.random.split(key, 3))
    assert jax_prng.split(jax_prng.prng_key(seed), 3) == [tuple(int(w) for w in r) for r in want]
    np.testing.assert_array_equal(jax_prng.random_bits32(jax_prng.prng_key(seed), (5, 7)),
                                  np.asarray(jax.random.bits(key, (5, 7), np.uint32)))
    # wide ranges and a shifted minimum
    for lo, hi in ((3, 1000), (-50, 50), (0, 2**31 - 1)):
        np.testing.assert_array_equal(
            jax_prng.randint(jax_prng.prng_key(seed), (64,), lo, hi),
            np.asarray(jax.random.randint(key, (64,), lo, hi)))
