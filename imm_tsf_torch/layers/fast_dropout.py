"""Hash dropout (after imm_tsf_tpu/layers/fast_dropout.py).

Keep bits come from a murmur3-style integer hash of the flat element
index and two uint32 salts:

    keep = fmix(fmix(i * GOLD ^ s0) ^ s1) < round(keep_prob * 2^32)

The fused-FFN kernel (csrc/ffn.cu) inlines the same bits, and its plain
version needs them here. Torch on the CPU has no `>>` or `<` for uint32,
so the uint32 arithmetic is emulated in int64 and cut to the low 32 bits
after every multiply; the mask is bit-identical to the JAX one.

`Dropout` is the identity in eval. In train mode it computes
where(keep, x / keep_prob, 0), keep drawn from two uint32 salts, as the
JAX package's `_hash_dropout` (:94-114) does; autograd re-derives
nothing, since the mask is an input of the `where`. The salts come from
the module's `generator`, which the trainer sets to a torch.Generator it
owns (torch's default generator when unset): the two frameworks' random
streams differ, so trained runs compare in their seed band, and tests
hand both the same salts. The mask runs as plain PyTorch elementwise ops:
the JAX package computes it outside any Pallas kernel.

Every site takes its salts through `take_salts` (the FFN's pair of sites
through `take_salt_table`). Outside a `SaltTape` they are drawn there and
then, as host ints. Under a tape (the device-resident epoch loop,
training/device_loop.py) a step reads them from the tape's `row`, a
tensor on the step's device that the loop fills before the step: a CUDA
graph replays reads of device memory, where it would freeze host ints.
The host still draws every pair through `draw_salts`, from the same
generators, in the same site order and as often a step, so the salt
stream, and every mask, equals the eager one.

dropout_impl="flax" (`Dropout.impl`, set by the trainer) is flax
nn.Dropout's mask, bit for bit with the JAX package under
rng_impl="threefry2x32": a site's key is fold_in(step key, flax's hash of
the site's scope path and call counter), and the mask is
jax.random.bernoulli of that key over x's shape (kernels/dropout.py).
The step key comes from the run's `jax_prng.KeyChain`, one split a
training step; the model's and the fusion stack's sites share it, as the
JAX package's two applies do (imm_tsf_tpu/training/trainer.py:223,
250-280). `flax_step(chain)` (entered by trainer.make_forward around a
training forward) takes the step's key and counts each site's calls;
under a SaltTape the chain is one more "generator": the first step records
it, the host draws its keys in order, and a step reads its key from the
tape's row on the device. A site knows its flax scope path
(`flax_path`, given once at build time by convert.assign_flax_sites) and
how flax names its calls (`flax_fresh`): a fresh module a call, named
Dropout_<k + call> in its parent (imm_tsf_tpu/layers/transformer.py:165,
242), or one module whose make_rng counter counts the calls.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.dropout import flax_dropout
from .jax_prng import KeyChain, site_hash

_MASK32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLD = 0x9E3779B1


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for int64 h in [0, 2^32), without int64 overflow:
    split m into 16-bit halves so no partial product reaches 2^49."""
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (hi + h * (m & 0xFFFF)) & _MASK32


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = _mul32(h ^ (h >> 16), _M1)
    h = _mul32(h ^ (h >> 13), _M2)
    return h ^ (h >> 16)


def _thresh(keep_prob: float) -> int:
    return min(_MASK32, round(keep_prob * 2.0**32))


def _keep_mask(s0, s1, keep_prob: float, shape, device=None, offset: int = 0) -> torch.Tensor:
    """Bernoulli(keep_prob) bool mask of `shape` from two uint32 salts
    (Python ints or 0-d integer tensors), hashing the flat indices offset,
    offset + 1, ...: a rank's block of a global mask whose outermost axis
    is the batch starts at `offset` (parallel/mesh.DataMesh.offset). The
    index is uint32, as the JAX package's `arange(n, uint32)`: the mask is
    that of the global shape for a global element count below 2^32."""
    n = max(1, math.prod(shape))
    i = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    if offset:
        i = (i + offset) & _MASK32
    h = _fmix(_fmix(_mul32(i, _GOLD) ^ s0) ^ s1)
    return h < _thresh(keep_prob)


def draw_salts(generator: torch.Generator | None = None) -> tuple[int, int]:
    """Two uint32 salts from `generator` (a CPU generator)."""
    s0, s1 = torch.randint(0, 2**32, (2,), generator=generator, dtype=torch.int64).tolist()
    return s0, s1


def _draw(source) -> tuple[int, int]:
    """A pair from a salt generator, or a KeyChain's next step key."""
    return source.next() if isinstance(source, KeyChain) else draw_salts(source)


class SaltTape:
    """The salts of a training step's dropout sites, read from `row`.

    The first step under the tape records its sites: each draws through
    `draw_salts` from its own generator, in call order, and `generators`
    lists them after it. From then on a step reads site k's pairs from
    `row[k]` (int64 [n_sites, 2], set by the caller before the step), and
    `draw(steps)` draws the host pairs of `steps` steps, [steps, n_sites,
    2], the same calls the sites would make. A step that takes another
    number of pairs than the recorded one raises."""

    def __init__(self):
        self.generators: list | None = None  # each pair's generator, once recorded
        self.row: torch.Tensor | None = None  # [n_sites, 2]: the running step's salts
        self._taken: list = []

    @property
    def n_sites(self) -> int:
        return len(self.generators)

    def begin(self) -> None:
        self._taken = []

    def end(self) -> None:
        if self.generators is None:
            self.generators = self._taken
        elif len(self._taken) != self.n_sites:
            raise RuntimeError(f"a step took {len(self._taken)} salt pairs, its first "
                               f"{self.n_sites}: the dropout sites changed between steps")

    def take(self, generator, n: int):
        """n pairs for a site drawing from `generator`: host ints while
        recording, else rows of `row`."""
        k = len(self._taken)
        self._taken += [generator] * n
        if self.generators is None:
            return [_draw(generator) for _ in range(n)]
        if k + n > self.n_sites:
            raise RuntimeError(f"a step took more than its first {self.n_sites} salt pairs")
        return self.row[k:k + n]

    def draw(self, steps: int) -> torch.Tensor:
        pairs = [_draw(gen) for _ in range(steps) for gen in self.generators]
        return torch.tensor(pairs, dtype=torch.int64).reshape(steps, self.n_sites, 2)


_TAPE: SaltTape | None = None  # the active tape, set by `salt_tape`


class salt_tape:
    """Route every site's salts through `tape` inside the block."""

    def __init__(self, tape: SaltTape):
        self.tape = tape

    def __enter__(self):
        global _TAPE
        self.saved, _TAPE = _TAPE, self.tape
        return self.tape

    def __exit__(self, *exc):
        global _TAPE
        _TAPE = self.saved


def take_salts(generator: torch.Generator | None = None):
    """A site's two salts: host ints from `generator`, or under a tape the
    tape's (0-d tensors on the step's device once the tape has recorded)."""
    if _TAPE is None:
        return draw_salts(generator)
    pair = _TAPE.take(generator, 1)[0]
    return pair[0], pair[1]


def take_salt_table(generator: torch.Generator | None, n: int) -> torch.Tensor:
    """n sites' salts as an int64 [n, 2] tensor: drawn now on the host, or
    under a tape the tape's rows (on the step's device once recorded)."""
    if _TAPE is None:
        return torch.tensor([draw_salts(generator) for _ in range(n)])
    pairs = _TAPE.take(generator, n)
    return torch.tensor(pairs) if isinstance(pairs, list) else pairs


def take_key(chain: KeyChain) -> torch.Tensor:
    """A training step's key as an int64 [2] tensor: the chain's next key
    (host), or under a tape the tape's (on the step's device once the tape
    has recorded)."""
    if _TAPE is None:
        return torch.tensor(chain.next(), dtype=torch.int64)
    pairs = _TAPE.take(chain, 1)
    return torch.tensor(pairs[0], dtype=torch.int64) if isinstance(pairs, list) else pairs[0]


class FlaxSites:
    """One training forward's flax-mode draws: the step key (int64 [2]),
    each site's calls so far, and the (path, counter) of every draw in
    order (`drawn`)."""

    def __init__(self, key: torch.Tensor):
        self.key = key
        self.calls: dict = {}
        self.drawn: list = []
        self._on: dict = {}  # the key on each device it was asked on

    def key_on(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = self.key.to(device)
        return self._on[device]

    def site(self, drop: "Dropout") -> tuple[tuple, int]:
        """The (scope path, counter) of `drop`'s next call."""
        n = self.calls.get(drop, 0)
        self.calls[drop] = n + 1
        path = drop.flax_path
        if drop.flax_fresh:
            head, k = path[-1].rsplit("_", 1)
            return (*path[:-1], f"{head}_{int(k) + n}"), 1
        return path, n + 1


_FLAX: FlaxSites | None = None  # the running training forward's, set by flax_step


class flax_step:
    """Inside the block every flax-mode Dropout draws from one step key:
    `key` (an int64 [2] tensor, or two ints), or the next of `chain`
    (take_key). Entered once a training forward."""

    def __init__(self, chain: KeyChain | None = None, key=None):
        self.chain, self.key = chain, key

    def __enter__(self) -> FlaxSites:
        global _FLAX
        key = take_key(self.chain) if self.key is None else torch.as_tensor(
            self.key, dtype=torch.int64)
        self.saved, _FLAX = _FLAX, FlaxSites(key)
        return _FLAX

    def __exit__(self, *exc):
        global _FLAX
        _FLAX = self.saved


def hash_dropout(x: torch.Tensor, s0, s1, keep_prob: float, offset: int = 0) -> torch.Tensor:
    """where(keep, x / keep_prob, 0) with keep = _keep_mask(s0, s1) over x's
    shape (from flat index `offset`): bit-identical to the JAX package's
    `_hash_dropout` given the same salts, its gradient too."""
    keep = _keep_mask(s0, s1, keep_prob, tuple(x.shape), x.device, offset)
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class Dropout(nn.Module):
    """Identity in eval; in train mode hash dropout, or with `impl` "flax"
    flax nn.Dropout's mask from the running flax_step's key (module
    docstring). Under a data mesh (`data_mesh`, set by the trainer) a rank
    draws its block of the global batch's mask: every site's input has the
    batch as its outermost axis (the models' layouts: [B, ...], [B * C,
    ...] or [B * N, ...]), so the block starts at rank x x.numel()."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: torch.Generator | None = None  # salt source, set by the trainer
        self.data_mesh = None  # parallel/mesh.DataMesh, set by the trainer
        self.impl = "hash"  # or "flax", set by the trainer with the two below
        self.flax_path: tuple | None = None  # flax scope path of the first call's module
        self.flax_fresh = False  # a fresh Dropout_<k> a call, else a counter a call

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        offset = self.data_mesh.offset(x.numel()) if self.data_mesh is not None else 0
        if self.impl == "flax":
            if _FLAX is None:
                raise RuntimeError("a flax-mode dropout site ran outside flax_step: "
                                   "a training forward takes its step key there")
            path, counter = _FLAX.site(self)
            _FLAX.drawn.append((path, counter))
            return flax_dropout(x, _FLAX.key_on(x.device), site_hash(path, counter),
                                1.0 - self.rate, offset)
        return hash_dropout(x, *take_salts(self.generator), 1.0 - self.rate, offset)
