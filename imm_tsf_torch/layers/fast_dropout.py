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
hand both the same salts. Only `dropout_impl="hash"` is ported; the
trainer refuses "flax". The mask runs as plain PyTorch elementwise ops:
the JAX package computes it outside any Pallas kernel.
"""

from __future__ import annotations

import math

import torch
from torch import nn

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


def _keep_mask(s0, s1, keep_prob: float, shape, device=None) -> torch.Tensor:
    """Bernoulli(keep_prob) bool mask of `shape` from two uint32 salts
    (Python ints or 0-d integer tensors)."""
    n = max(1, math.prod(shape))
    i = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    h = _fmix(_fmix(_mul32(i, _GOLD) ^ s0) ^ s1)
    return h < _thresh(keep_prob)


def draw_salts(generator: torch.Generator | None = None) -> tuple[int, int]:
    """Two uint32 salts from `generator` (a CPU generator)."""
    s0, s1 = torch.randint(0, 2**32, (2,), generator=generator, dtype=torch.int64).tolist()
    return s0, s1


def hash_dropout(x: torch.Tensor, s0, s1, keep_prob: float) -> torch.Tensor:
    """where(keep, x / keep_prob, 0) with keep = _keep_mask(s0, s1) over x's
    shape: bit-identical to the JAX package's `_hash_dropout` given the
    same salts, its gradient too."""
    keep = _keep_mask(s0, s1, keep_prob, tuple(x.shape), x.device)
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class Dropout(nn.Module):
    """Identity in eval, hash dropout in train mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: torch.Generator | None = None  # salt source, set by the trainer

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        return hash_dropout(x, *draw_salts(self.generator), 1.0 - self.rate)
