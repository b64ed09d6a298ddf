"""Fused encoder FFN: the CUDA kernel `csrc/ffn.cu` and its plain version.

Port of imm_tsf_tpu/ops/pallas/ffn_kernel.py (`fused_encoder_ffn`,
forward only):

    out = LayerNorm(x + drop(drop(act(x W1 + b1)) W2 + b2)) * gamma + beta

with the hash-dropout bits of layers/fast_dropout.py; the kernel runs both
products on the tensor cores as 3xTF32 (float32 accuracy). The wrapper runs
the plain version for CPU tensors and launches the kernel for CUDA
tensors; a shape the kernel cannot take raises instead of silently
running unfused. The backward and the a1/r residual outputs come with
PatchTST training; the trainer refuses use_fused_ffn until then.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..layers.fast_dropout import _keep_mask, _thresh
from . import _build

_EPS = 1e-5  # LayerNorm epsilon (flax default used by EncoderLayer)
_ACTS = {"relu": 0, "gelu": 1}

launches = 0  # kernel launches through fused_encoder_ffn


def _act_fn(a: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(a)
    return F.gelu(a, approximate="tanh")  # flax nn.gelu's default


def ffn_reference(x, w1, b1, w2, b2, gamma, beta, salts, keep_prob: float,
                  act: str, apply_dropout: bool) -> torch.Tensor:
    """Plain PyTorch forward with the same hash masks (after
    ffn_kernel.py:ffn_reference). x [M, D], w1 [D, F], w2 [F, D]."""
    M, D = x.shape
    Fdim = w1.shape[1]
    xf = x.float()
    a1 = xf @ w1.float() + b1
    h = _act_fn(a1, act)
    if apply_dropout:
        s = salts.to(torch.int64).reshape(2, 2)
        keep_a = _keep_mask(s[0, 0], s[0, 1], keep_prob, (M, Fdim), x.device)
        h = torch.where(keep_a, h / keep_prob, 0.0)
    a2 = h @ w2.float() + b2
    if apply_dropout:
        keep_b = _keep_mask(s[1, 0], s[1, 1], keep_prob, (M, D), x.device)
        a2 = torch.where(keep_b, a2 / keep_prob, 0.0)
    r = xf + a2
    mu = r.mean(dim=-1, keepdim=True)
    var = (r * r).mean(dim=-1, keepdim=True) - mu * mu
    rhat = (r - mu) * torch.rsqrt(var + _EPS)
    return (rhat * gamma + beta).to(x.dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ffn_forward": ([_P] * 9 + [_I, _I, _I, ctypes.c_float, ctypes.c_uint, _I, _I, _I, _P],
                    _I),
    "ffn_max_d": ([], _I),
}


def _library() -> ctypes.CDLL:
    return _build.load("ffn", _SIGNATURES)


def fused_encoder_ffn(x, w1, b1, w2, b2, gamma, beta, salts,
                      keep_prob: float, act: str,
                      apply_dropout: bool) -> torch.Tensor:
    """x [M, D] -> LayerNorm(x + drop(drop(act(x@W1+b1)) @ W2 + b2)).

    w1 [D, F] and w2 [F, D] in the JAX layout; the transposed view of a
    torch.nn.Linear weight (`linear.weight.t()`) is passed to the kernel
    without a copy. salts: integer [2, 2] hash-dropout salts for the
    hidden and output sites (rows 0/1), read only when apply_dropout
    (may then be None otherwise)."""
    if x.device.type == "cpu":
        return ffn_reference(x, w1, b1, w2, b2, gamma, beta, salts,
                             keep_prob, act, apply_dropout)
    if x.device.type != "cuda":
        raise ValueError(f"fused_encoder_ffn: unsupported device {x.device}")
    M, D = x.shape
    Fdim = w1.shape[1]
    if act not in _ACTS:
        raise ValueError(f"fused_encoder_ffn: act must be relu or gelu, got {act!r}")
    shapes = {"w1": (w1, (D, Fdim)), "b1": (b1, (Fdim,)), "w2": (w2, (Fdim, D)),
              "b2": (b2, (D,)), "gamma": (gamma, (D,)), "beta": (beta, (D,))}
    for name, (t, shape) in {"x": (x, (M, D)), **shapes}.items():
        if t.dtype != torch.float32 or t.device != x.device or tuple(t.shape) != shape:
            raise ValueError(
                f"fused_encoder_ffn: {name} must be float32 {shape} on {x.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    lib = _library()
    if D > lib.ffn_max_d():
        raise ValueError(
            f"fused_encoder_ffn: d_model={D} exceeds the kernel's per-block "
            f"accumulator ({lib.ffn_max_d()} columns)")
    x = x.contiguous()
    w1t = w1.t().contiguous()  # [F, D]: a no-op for a Linear weight's .t() view
    w2t = w2.t().contiguous()  # [D, F]
    b1, b2 = b1.contiguous(), b2.contiguous()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    salts_ptr = None
    if apply_dropout:
        salts = salts.to(device=x.device, dtype=torch.int64).contiguous()
        if salts.numel() != 4:
            raise ValueError("fused_encoder_ffn: salts must be [2, 2]")
        salts_ptr = salts.data_ptr()
    out = torch.empty_like(x)
    if M == 0:
        return out
    # 16-byte copies of x and the weights when their rows allow them
    vec = D % 4 == 0 and Fdim % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, w1t, w2t))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.ffn_forward(
        x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
        b2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), salts_ptr,
        out.data_ptr(), M, D, Fdim, float(keep_prob), _thresh(keep_prob),
        _ACTS[act], int(bool(apply_dropout)), int(vec), stream)
    _build.check(rc, "fused_encoder_ffn")
    global launches
    launches += 1
    return out
