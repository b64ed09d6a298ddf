"""Causal, key-padded attention: the CUDA kernel `csrc/attn.cu` and its
plain version.

Port of imm_tsf_tpu/ops/pallas/attn_kernel.py (`fused_causal_attention`,
forward only):

    keep[b,q,k] = k <= q and pad[b,k] > 0
    out = softmax over the kept keys of (Q K^T / sqrt(D)) @ V

over q, k, v [B, H, T, D] and pad [B, T] (> 0 = real token). A query row
with no kept key gives exact zeros, not NaN. The wrapper runs the plain
version for CPU tensors and launches the kernel for CUDA tensors, for any
B, H, T and D <= 128; a larger D raises. The backward (the TPU package's
`_attn_bwd`) comes with TimeLLM training; the trainer refuses
use_fused_attn until then.
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


def attention_reference(q, k, v, pad) -> torch.Tensor:
    """Plain PyTorch forward (after attn_kernel.py:attention_reference)."""
    T = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    keep = causal[None, None] & (pad > 0)[:, None, None, :]
    p = masked_softmax(scores, keep)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


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


def fused_causal_attention(q, k, v, pad) -> torch.Tensor:
    """q, k, v [B, H, T, D] float32, pad [B, T] float32 -> [B, H, T, D]."""
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
