"""The port's PrefetchIterator (imm_tsf_torch/data/loader.py), after the
JAX package's (imm_tsf_tpu/data/loader.py:92-126): the base loader's
items in order, a worker's exception raised in the consumer, and the
worker never more than the queue's depth ahead."""

import threading
import time

import numpy as np
import pytest
import torch

from imm_tsf_tpu.data.loader import PrefetchIterator as JPrefetchIterator
from imm_tsf_torch.data.loader import BatchIterator, PrefetchIterator

torch.set_num_threads(1)


class _Counting:
    """n items, counting how many the worker has taken."""

    def __init__(self, n: int, fail_at: int | None = None):
        self.n, self.fail_at, self.taken = n, fail_at, 0
        self.lock = threading.Lock()

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            if i == self.fail_at:
                raise ValueError(f"collate failed at {i}")
            with self.lock:
                self.taken += 1
            yield {"i": i}


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_items_in_order_as_the_jax_iterator(depth):
    base = _Counting(23)
    got = [b["i"] for b in PrefetchIterator(base, depth=depth)]
    assert got == list(range(23)) == [b["i"] for b in JPrefetchIterator(base, depth=depth)]
    assert len(PrefetchIterator(base, depth)) == 23


def test_batches_and_shuffle_stream_as_the_base_loader():
    """Over a shuffling BatchIterator: the same batches as iterating the
    loader itself, and the shuffle stream left where it would be."""
    chunks = list(range(50))
    collate = lambda batch: {"x": np.asarray(batch, np.float32)[:, None]}
    a = BatchIterator(chunks, list(range(50)), 8, collate, shuffle=True, seed=3)
    b = BatchIterator(chunks, list(range(50)), 8, collate, shuffle=True, seed=3)
    for _ in range(2):
        got = [x["x"] for x in PrefetchIterator(a, depth=2)]
        want = [x["x"] for x in b]
        assert len(got) == len(want) == 7
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert a._rng.bit_generator.state == b._rng.bit_generator.state


def test_worker_exception_is_raised_in_the_consumer():
    it = iter(PrefetchIterator(_Counting(10, fail_at=4), depth=2))
    assert [next(it)["i"] for _ in range(4)] == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="collate failed at 4"):
        next(it)


@pytest.mark.parametrize("depth", [1, 3])
def test_worker_stays_within_the_depth(depth):
    """While the consumer holds its first item, the worker fills the queue
    (depth items) and holds one more at its put: depth + 2 taken at most."""
    base = _Counting(100)
    it = iter(PrefetchIterator(base, depth=depth))
    next(it)
    time.sleep(0.3)
    assert base.taken == depth + 2
    assert [x["i"] for x in it] == list(range(1, 100))
