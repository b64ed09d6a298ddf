"""Causal, key-padded attention: the CUDA kernel `csrc/attn.cu`, its plain
version and its backward.

Port of imm_tsf_tpu/ops/pallas/attn_kernel.py (`fused_causal_attention`
and its custom VJP):

    keep[b,q,k] = k <= q and pad[b,k] > 0
    out = softmax over the kept keys of (Q K^T / sqrt(D)) @ V

over q, k, v [B, H, T, D] and pad [B, T] (> 0 = real token). A query row
with no kept key gives exact zeros, not NaN. The wrapper runs the plain
version for CPU tensors and launches the kernel for CUDA tensors, for any
B, H, T and D <= 128; a larger D raises. `fused_causal_attention` is
differentiable: with a gradient in flight it runs as an autograd Function
whose backward is `attention_backward_reference`, the plain transcription
of the JAX package's `_attn_bwd` (:157-182), which is XLA there and not a
Pallas kernel; the pad mask gets no gradient.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..layers.attention import masked_softmax
from . import _build

launches = 0  # kernel launches through fused_causal_attention
launches_by_shape: dict = {}  # the same launches by (B, H, T, D)
backward_calls = 0  # backward calls of fused_causal_attention (plain, both devices)


def softmax_probs(q, k, pad) -> torch.Tensor:
    """The masked softmax probabilities [B, H, T, T] (after
    attn_kernel.py:_softmax_probs), in float32 or, for float64 inputs,
    float64."""
    T = q.shape[2]
    ct = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), k.to(ct)) * scale
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    keep = causal[None, None] & (pad > 0)[:, None, None, :]
    return masked_softmax(scores, keep)


def attention_reference(q, k, v, pad) -> torch.Tensor:
    """Plain PyTorch forward (after attn_kernel.py:attention_reference)."""
    p = softmax_probs(q, k, pad)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(p.dtype)).to(q.dtype)


def attention_backward_reference(q, k, v, pad, g):
    """The hand VJP (attn_kernel.py:_attn_bwd) -> (dq, dk, dv): the
    probabilities recomputed from q, k and pad (none stored), then
    dv = p^T g, dp = g v^T, ds = p (dp - sum(dp p)), dq = ds k / sqrt(D),
    dk = ds^T q / sqrt(D). A row with no kept key has p = 0 and gives
    nothing to any gradient. The products stay torch.matmul: the JAX
    package leaves them to XLA."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = softmax_probs(q, k, pad)
    ct = p.dtype
    g = g.to(ct)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, v.to(ct))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.to(ct)) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(ct)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "attn_forward": ([_P] * 5 + [_I, _I, _I, _I, ctypes.c_float, _P], _I),
    "attn_max_d": ([], _I),
}


def _library() -> ctypes.CDLL:
    return _build.load("attn", _SIGNATURES)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte-aligned start (the kernel reads float4)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(q, k, v, pad) -> torch.Tensor:
    """Kernel #3 for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, pad)
    if q.device.type != "cuda":
        raise ValueError(f"fused_causal_attention: unsupported device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"fused_causal_attention: q must be [B, H, T, D], got {tuple(q.shape)}")
    B, H, T, D = q.shape
    for name, (t, shape) in {"q": (q, (B, H, T, D)), "k": (k, (B, H, T, D)),
                             "v": (v, (B, H, T, D)), "pad": (pad, (B, T))}.items():
        if t.dtype != torch.float32 or t.device != q.device or tuple(t.shape) != shape:
            raise ValueError(
                f"fused_causal_attention: {name} must be float32 {shape} on {q.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    lib = _library()
    if D > lib.attn_max_d():
        raise ValueError(
            f"fused_causal_attention: head dim {D} exceeds the kernel's "
            f"{lib.attn_max_d()} columns")
    scale = 1.0 / math.sqrt(D)
    D4 = -(-D // 4) * 4  # the kernel reads rows as float4: zero columns change no dot product
    if D4 != D:
        q, k, v = (F.pad(t, (0, D4 - D)) for t in (q, k, v))
    q, k, v, pad = (_aligned(t) for t in (q, k, v, pad))
    out = torch.empty((B, H, T, D4), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out[..., :D]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.attn_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
                          out.data_ptr(), B, H, T, D4, scale, stream)
    _build.check(rc, "fused_causal_attention")
    global launches
    launches += 1
    launches_by_shape[(B, H, T, D)] = launches_by_shape.get((B, H, T, D), 0) + 1
    return out if D4 == D else out[..., :D].contiguous()


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pad):
        ctx.save_for_backward(q, k, v, pad)
        return _forward(q, k, v, pad)

    @staticmethod
    def backward(ctx, g):
        global backward_calls
        backward_calls += 1
        return (*attention_backward_reference(*ctx.saved_tensors, g), None)


def fused_causal_attention(q, k, v, pad) -> torch.Tensor:
    """q, k, v [B, H, T, D] float32, pad [B, T] float32 -> [B, H, T, D].
    With a gradient in flight to q, k or v, the same forward runs as an
    autograd Function whose backward is attention_backward_reference."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FusedAttention.apply(q, k, v, pad)
    return _forward(q, k, v, pad)
