"""Flax-mode dropout: the CUDA kernel `csrc/dropout.cu` and its plain
version.

Under dropout_impl="flax" the JAX package draws each dropout site's mask
as flax nn.Dropout does (imm_tsf_tpu/layers/fast_dropout.py:158-163):
`jax.random.bernoulli(site_key, keep_prob, x.shape)`, then
select(mask, x / keep_prob, 0). site_key is flax's fold of the site's
scope path and call counter into the step's key (layers/jax_prng.
site_hash), a `jax.random.fold_in`. It replaces no Pallas kernel: XLA
fuses the threefry bits and the select there, and this kernel is their
counterpart (PyTorch has no call that draws these bits: F.dropout draws
Philox).

`flax_dropout(x, key, site, keep_prob, offset)` takes the step key as an
int64 [2] tensor (its two uint32 words), on x's device: the kernel folds
`site` into it on the device, so a captured step replays with the key
the host wrote before the replay. `offset` is the flat index of x's
first element in the global mask (a rank of a data mesh), 64 bits wide.
It is an autograd Function; the backward is the same function on the
incoming gradient (the JAX VJP of the select: select(mask, g, 0) /
keep_prob), the mask recomputed, not stored.

On CUDA tensors the wrapper launches the kernel (float32 or bf16) or
raises; the plain version (`flax_dropout_reference`: threefry2x32 in
int64 torch ops, cut to 32 bits after every addition) runs only for CPU
tensors, and beside the kernel in the card's checks. A bf16 x divides by
bf16(keep_prob), as jnp's weak scalar meets bf16 (layers/jax_promotion).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..layers.jax_promotion import round_bf16
from . import _build

launches = 0  # kernel launches through flax_dropout, forward and backward
backward_launches = 0  # of which the backward's

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & _MASK32) | (v >> (32 - r))


def _threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """layers/jax_prng.threefry2x32 on int64 tensors holding uint32 values
    (k0, k1: int64 tensors or ints)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (x0 + ks[0]) & _MASK32, (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0, x1


def keep_mask_reference(key: torch.Tensor, site: int, keep_prob: float, shape,
                        offset: int = 0) -> torch.Tensor:
    """jax.random.bernoulli(fold_in(key, site), keep_prob, shape) from flat
    index `offset` on, as a bool tensor on key's device."""
    key = key.to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    k0, k1 = _threefry2x32(key[0], key[1], zero, zero + site)
    n = max(1, math.prod(shape))
    i = torch.arange(n, dtype=torch.int64, device=key.device) + offset
    b0, b1 = _threefry2x32(k0, k1, i >> 32, i & _MASK32)
    u = (((b0 ^ b1) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return (u < torch.tensor(keep_prob, dtype=torch.float32)).reshape(shape)


def divisor(dtype: torch.dtype, keep_prob: float) -> float:
    """What x / keep_prob divides by in x's dtype: bf16(keep_prob) for bf16
    (jnp's weak scalar), else float32(keep_prob)."""
    return round_bf16(keep_prob) if dtype == torch.bfloat16 else keep_prob


def flax_dropout_reference(x: torch.Tensor, key: torch.Tensor, site: int, keep_prob: float,
                           offset: int = 0) -> torch.Tensor:
    """Plain PyTorch: where(keep, x / keep_prob, 0) with the site's mask.
    keep_prob is a 0-d tensor on x's device: torch's CUDA division by a
    Python scalar multiplies by its reciprocal, an ulp off x / keep_prob."""
    keep = keep_mask_reference(key.to(x.device), site, keep_prob, tuple(x.shape), offset)
    d = torch.tensor(divisor(x.dtype, keep_prob), dtype=x.dtype, device=x.device)
    return torch.where(keep, x / d, torch.zeros_like(x))


_P = ctypes.c_void_p
_SIGNATURES = {"flax_dropout": ([_P, _P, ctypes.c_longlong, ctypes.c_longlong, _P,
                                 ctypes.c_uint, ctypes.c_float, ctypes.c_float, ctypes.c_int, _P],
                                ctypes.c_int)}


def _library() -> ctypes.CDLL:
    return _build.load("dropout", _SIGNATURES)


def _launch(x: torch.Tensor, key: torch.Tensor, site: int, keep_prob: float,
            offset: int) -> torch.Tensor:
    """One kernel launch on x's current stream; checks what it takes."""
    global launches
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flax_dropout kernel takes float32 or bfloat16, got {x.dtype}")
    if key.device != x.device or key.dtype != torch.int64 or key.shape != (2,):
        raise ValueError(f"flax_dropout: the key must be an int64 [2] tensor on {x.device}, "
                         f"got {key.dtype} {tuple(key.shape)} on {key.device}")
    if not 0 <= site <= _MASK32 or offset < 0:
        raise ValueError(f"flax_dropout: site {site} is not a uint32 or offset {offset} < 0")
    x = x.contiguous()
    key = key.contiguous()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(_library().flax_dropout(
        x.data_ptr(), out.data_ptr(), x.numel(), offset, key.data_ptr(), site,
        keep_prob, divisor(x.dtype, keep_prob), int(x.dtype == torch.bfloat16), stream),
        "flax_dropout")
    launches += 1
    return out


def _apply(x, key, site: int, keep_prob: float, offset: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return flax_dropout_reference(x, key, site, keep_prob, offset)
    return _launch(x, key, site, keep_prob, offset)


class _FlaxDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key, site, keep_prob, offset):
        ctx.save_for_backward(key)
        ctx.site, ctx.keep_prob, ctx.offset = site, keep_prob, offset
        return _apply(x, key, site, keep_prob, offset)

    @staticmethod
    def backward(ctx, g):
        global backward_launches
        (key,) = ctx.saved_tensors
        dx = _apply(g, key, ctx.site, ctx.keep_prob, ctx.offset)
        if g.device.type != "cpu":
            backward_launches += 1
        return dx, None, None, None, None


def flax_dropout(x: torch.Tensor, key: torch.Tensor, site: int, keep_prob: float,
                 offset: int = 0) -> torch.Tensor:
    """where(keep, x / keep_prob, 0), keep the flax site's mask (module
    docstring), differentiable in x. key: int64 [2] on x's device."""
    return _FlaxDropout.apply(x, key, site, keep_prob, offset)
