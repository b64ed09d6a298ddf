"""Fused encoder FFN: the CUDA kernel `csrc/ffn.cu` and its plain versions.

Port of imm_tsf_tpu/ops/pallas/ffn_kernel.py (`fused_encoder_ffn`):

    a1  = x W1 + b1                                  # [M, F]
    r   = x + drop(drop(act(a1)) W2 + b2)            # [M, D]
    out = LayerNorm(r) * gamma + beta

with the hash-dropout bits of layers/fast_dropout.py; the kernel runs both
products on the tensor cores as 3xTF32 (float32 accuracy). It has the
JAX kernel's two forms: the eval form writes `out` only, the training form
also writes the backward's residuals a1 and r (`_ffn_fwd`, :174-179).
`fused_encoder_ffn` is differentiable: when a gradient is in flight it
runs the training form and its backward is `ffn_backward_reference`, the
plain transcription of `_ffn_bwd` (:182-232), which is XLA there and not
a Pallas kernel. The wrapper runs the plain versions for CPU tensors and
launches the kernel for CUDA tensors; a shape the kernel cannot take
raises instead of silently running unfused.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..layers.fast_dropout import _keep_mask, _thresh
from . import _build

_EPS = 1e-5  # LayerNorm epsilon (flax default used by EncoderLayer)
_ACTS = {"relu": 0, "gelu": 1}

launches = 0  # kernel launches through fused_encoder_ffn, both forms
train_launches = 0  # of which the training form (a1 and r written too)


def _act_fn(a: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(a)
    return F.gelu(a, approximate="tanh")  # flax nn.gelu's default


def _act_grad(dh: torch.Tensor, a: torch.Tensor, act: str) -> torch.Tensor:
    """dh * act'(a): the backward autograd runs for _act_fn."""
    if act == "relu":
        return torch.where(a > 0, dh, 0.0)
    return torch.ops.aten.gelu_backward(dh, a, approximate="tanh")


def _masks(salts, keep_prob: float, M: int, D: int, Fdim: int, device):
    """(keep_a [M, F], keep_b [M, D]): the hash bits of the hidden and
    output dropout sites, from salts rows 0 and 1."""
    s = torch.as_tensor(salts).to(torch.int64).reshape(2, 2)
    return (_keep_mask(s[0, 0], s[0, 1], keep_prob, (M, Fdim), device),
            _keep_mask(s[1, 0], s[1, 1], keep_prob, (M, D), device))


def ffn_forward_reference(x, w1, b1, w2, b2, gamma, beta, salts, keep_prob: float,
                          act: str, apply_dropout: bool, with_residuals: bool = False):
    """Plain PyTorch forward with the same hash masks (after
    ffn_kernel.py:_ffn_kernel). x [M, D], w1 [D, F], w2 [F, D]. Returns
    out, or (out, a1, r) with the residuals of the training form: a1 the
    pre-activation x W1 + b1, r the pre-LayerNorm sum. Computes in float32,
    or float64 for float64 inputs."""
    M, D = x.shape
    Fdim = w1.shape[1]
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct)
    a1 = xf @ w1.to(ct) + b1
    h = _act_fn(a1, act)
    if apply_dropout:
        keep_a, keep_b = _masks(salts, keep_prob, M, D, Fdim, x.device)
        h = torch.where(keep_a, h / keep_prob, 0.0)
    a2 = h @ w2.to(ct) + b2
    if apply_dropout:
        a2 = torch.where(keep_b, a2 / keep_prob, 0.0)
    r = xf + a2
    mu = r.mean(dim=-1, keepdim=True)
    var = (r * r).mean(dim=-1, keepdim=True) - mu * mu
    rhat = (r - mu) * torch.rsqrt(var + _EPS)
    out = (rhat * gamma + beta).to(x.dtype)
    return (out, a1, r) if with_residuals else out


def ffn_reference(x, w1, b1, w2, b2, gamma, beta, salts, keep_prob: float,
                  act: str, apply_dropout: bool) -> torch.Tensor:
    """The eval form's plain version (ffn_kernel.py:ffn_reference); under
    autograd it is the unfused FFN of the JAX package's EncoderLayer."""
    return ffn_forward_reference(x, w1, b1, w2, b2, gamma, beta, salts, keep_prob,
                                 act, apply_dropout)


def ffn_backward_reference(x, w1, w2, gamma, salts, a1, r, g, keep_prob: float,
                           act: str, apply_dropout: bool):
    """The hand VJP (ffn_kernel.py:_ffn_bwd) -> (dx, dw1, db1, dw2, db2,
    dgamma, dbeta). The LayerNorm statistics are recomputed from r with the
    forward's E[r^2] - mu^2 variance; both dropout masks are re-derived
    from the salts (no stored mask); act' is taken at a1. The four
    products stay torch.matmul: the JAX package leaves them to XLA."""
    M, D = x.shape
    Fdim = a1.shape[1]
    ct = r.dtype
    g = g.to(ct)

    mu = r.mean(dim=-1, keepdim=True)
    var = (r * r).mean(dim=-1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var + _EPS)
    rhat = (r - mu) * rstd
    dgamma = (g * rhat).sum(dim=0)
    dbeta = g.sum(dim=0)
    gg = g * gamma.to(ct)
    dr = rstd * (gg - gg.mean(dim=-1, keepdim=True)
                 - rhat * (gg * rhat).mean(dim=-1, keepdim=True))

    h = _act_fn(a1, act)
    if apply_dropout:
        keep_a, keep_b = _masks(salts, keep_prob, M, D, Fdim, x.device)
        da2 = torch.where(keep_b, dr / keep_prob, 0.0)
        hd = torch.where(keep_a, h / keep_prob, 0.0)
    else:
        da2, hd = dr, h

    dw2 = hd.t() @ da2
    db2 = da2.sum(dim=0)
    dhd = da2 @ w2.to(ct).t()
    dh = torch.where(keep_a, dhd / keep_prob, 0.0) if apply_dropout else dhd
    da1 = _act_grad(dh, a1, act)

    dw1 = x.to(ct).t() @ da1
    db1 = da1.sum(dim=0)
    dx = da1 @ w1.to(ct).t() + dr
    return dx.to(x.dtype), dw1, db1, dw2, db2, dgamma, dbeta


_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_SIGNATURES = {
    "ffn_forward": ([_P] * 10 + [_I, _I, _I, ctypes.c_float, _U, _P, _I, _I, _I, _P], _I),
    "ffn_max_d": ([], _I),
}


def _library() -> ctypes.CDLL:
    return _build.load("ffn", _SIGNATURES)


def _device_salts(salts, device) -> torch.Tensor:
    """The four salts as a contiguous int64 [4] tensor on `device`, which
    the kernel reads (their low 32 bits). Salts already there, as the
    captured step's salt buffer holds them (training/graphs.py), are read in
    place; host salts, as the eager steps draw them, are copied over."""
    s = torch.as_tensor(salts)
    if s.numel() != 4:
        raise ValueError("fused_encoder_ffn: salts must be [2, 2]")
    return s.to(device=device, dtype=torch.int64, non_blocking=True).reshape(4).contiguous()


def _forward(x, w1, b1, w2, b2, gamma, beta, salts, keep_prob: float, act: str,
             apply_dropout: bool, with_residuals: bool):
    """Kernel #2 for CUDA tensors, the plain version for CPU tensors: out,
    or (out, a1, r) in the training form."""
    if x.device.type == "cpu":
        return ffn_forward_reference(x, w1, b1, w2, b2, gamma, beta, salts, keep_prob,
                                     act, apply_dropout, with_residuals)
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
    s = _device_salts(salts, x.device) if apply_dropout else None
    out = torch.empty_like(x)
    a1 = r = None
    if with_residuals:
        a1 = torch.empty((M, Fdim), dtype=torch.float32, device=x.device)
        r = torch.empty_like(x)
    if M > 0:
        # 16-byte copies of x and the weights when their rows allow them
        vec = D % 4 == 0 and Fdim % 4 == 0 and all(t.data_ptr() % 16 == 0
                                                   for t in (x, w1t, w2t))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ffn_forward(
            x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            a1.data_ptr() if with_residuals else None,
            r.data_ptr() if with_residuals else None,
            M, D, Fdim, float(keep_prob), _thresh(keep_prob),
            s.data_ptr() if s is not None else None, _ACTS[act], int(bool(apply_dropout)),
            int(vec), stream)
        _build.check(rc, "fused_encoder_ffn")
        global launches, train_launches
        launches += 1
        train_launches += int(with_residuals)
    return (out, a1, r) if with_residuals else out


class _FusedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, gamma, beta, salts, keep_prob, act, apply_dropout):
        out, a1, r = _forward(x, w1, b1, w2, b2, gamma, beta, salts, keep_prob, act,
                              apply_dropout, with_residuals=True)
        ctx.save_for_backward(x, w1, w2, gamma, a1, r)
        ctx.salts, ctx.static = salts, (keep_prob, act, apply_dropout)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w1, w2, gamma, a1, r = ctx.saved_tensors
        grads = ffn_backward_reference(x, w1, w2, gamma, ctx.salts, a1, r, g, *ctx.static)
        return (*grads, None, None, None, None)


def fused_encoder_ffn(x, w1, b1, w2, b2, gamma, beta, salts,
                      keep_prob: float, act: str,
                      apply_dropout: bool) -> torch.Tensor:
    """x [M, D] -> LayerNorm(x + drop(drop(act(x@W1+b1)) @ W2 + b2)).

    w1 [D, F] and w2 [F, D] in the JAX layout; the transposed view of a
    torch.nn.Linear weight (`linear.weight.t()`) is passed to the kernel
    without a copy, and its gradient reaches the Linear weight through the
    view. salts: integer [2, 2] hash-dropout salts for the hidden and
    output sites (rows 0/1), read only when apply_dropout (may be None
    otherwise); on the card the kernel reads them from device memory, so
    host salts are copied there first and device salts are read in place.
    With a gradient in flight the training form runs; without one, the
    eval form (the a1 [M, F] write is waste there)."""
    params = (x, w1, b1, w2, b2, gamma, beta)
    if torch.is_grad_enabled() and any(t.requires_grad for t in params):
        return _FusedFFN.apply(*params, salts, keep_prob, act, apply_dropout)
    return _forward(*params, salts, keep_prob, act, apply_dropout, with_residuals=False)
