"""One-pass bfloat16 products, for compute_dtype="bfloat16"
(training/trainer.make_forward): the counterpart of the JAX package's
`jax.default_matmul_precision("bfloat16")` context around its whole
forward (imm_tsf_tpu/training/trainer.py:199-207).

Under that context JAX stamps precision DEFAULT on every dot_general and
conv_general_dilated it traces, and an accelerator runs such a float32
product in one pass: each operand rounded to bfloat16 (round to nearest
even, as XLA's convert rounds), the products exact in float32, the sums
and the result float32. The transposed products of the backward inherit
the stamp, so dX = bf16(g) bf16(W)^T and dW = bf16(X)^T bf16(g): the
incoming gradient is rounded too. Everything else (bias adds,
LayerNorm, softmax, activations, dropout, the loss, the optimizer) stays
float32, and so do the parameters: this is a precision context, not
amp_bf16's bf16 copies. JAX traces a custom VJP's backward after the
forward's context has closed, so its products carry no precision stamp,
which on the TPU is DEFAULT all the same: the port rounds them too
(kernels #1-#3's backwards).

`Bf16Products` is a TorchFunctionMode that takes the float32 operands of
`F.linear`, `F.conv1d`/`conv2d`, `matmul`/`@`, `mm`, `bmm`, `addmm`,
`baddbmm` and two-operand `einsum` into one-pass products:

  - the forward rounds the operands to bf16 and takes their product with
    a float32 result: on CPU tensors the float32 product of the rounded
    operands (TF32 is off, device.py); on CUDA tensors a matrix product
    (linear, matmul, mm, bmm) is one cuBLAS bf16 GEMM with float32 output
    (`out_dtype=torch.float32`), a convolution or an einsum the float32
    product of the rounded operands;
  - with a gradient in flight the product is a `Bf16Product` autograd
    Function, whose backward rounds the incoming gradient and takes each
    operand's gradient as one such product of the rounded operands (no
    recomputed forward);
  - a bias is added after the product, in float32, as flax's Dense and
    Conv add it after the dot.

Do not round with `x.bfloat16().float()` under autograd: the cast's VJP
would round the gradient of x itself and leave the gradient products
unrounded. `full_precision()` suspends the mode where the JAX package pins
a product to HIGHEST (ops/expm.py, the fused CRU scan: kernels #4-#7 and
their plain versions). Kernels #1-#3 read `active()` and take their
one-pass routes while it holds. The mode is Python only, so a captured
CUDA graph and torch.export record what it does (the casts and the GEMMs).
"""

from __future__ import annotations

import contextlib
import re
import threading

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

LOW = torch.bfloat16
_state = threading.local()


def _stack() -> list:
    s = getattr(_state, "stack", None)
    if s is None:
        s = _state.stack = []
    return s


def active() -> bool:
    """True inside `Bf16Products` and outside any `full_precision()`
    nested in it (this thread)."""
    s = _stack()
    return bool(s) and s[-1]


@contextlib.contextmanager
def _pushed(on: bool):
    s = _stack()
    s.append(on)
    try:
        yield
    finally:
        s.pop()


def full_precision():
    """A block (or, as a decorator, a function) whose products run in full
    float32 under the mode: the JAX package's Precision.HIGHEST."""
    return _pushed(False)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t's values rounded to bf16 (nearest even), in t's dtype. For the
    plain versions of the kernels, outside autograd."""
    return t.to(LOW).to(t.dtype)


def rounding(one_pass: bool):
    """What a plain version does to a product's operands: round_bf16 in
    the one-pass form, nothing otherwise."""
    return round_bf16 if one_pass else (lambda t: t)


# ------------------------------------------------------------ the products
def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 a [..., M, K] @ bf16 b [..., K, N] -> float32: one cuBLAS GEMM
    with float32 output on CUDA (batch dims broadcast), the float32 product
    of the widened operands on the CPU."""
    if not a.is_cuda or a.dim() < 2 or b.dim() < 2:
        return torch.matmul(a.float(), b.float())
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    return torch.bmm(a3, b3, out_dtype=torch.float32).reshape(*batch, a.shape[-2], b.shape[-1])


def _einsum_terms(eq: str):
    """(a, b, out) subscripts of a two-operand einsum whose gradients are
    einsums themselves (explicit output, no ellipsis, no index repeated
    within an operand, every operand index in the other operand or the
    output), else None."""
    eq = eq.replace(" ", "")
    m = re.fullmatch(r"([a-zA-Z]*),([a-zA-Z]*)->([a-zA-Z]*)", eq)
    if m is None:
        return None
    a, b, out = m.groups()
    if any(len(set(s)) != len(s) for s in (a, b, out)):
        return None
    if not (set(a) <= set(b) | set(out) and set(b) <= set(a) | set(out)):
        return None
    return a, b, out


def _forward(kind: str, spec, a16: torch.Tensor, b16: torch.Tensor) -> torch.Tensor:
    """The product of two bf16 operands with a float32 result."""
    if kind == "matmul":
        return _mm_f32(a16, b16)
    if kind == "linear":  # x [..., K] W^T, W [N, K]
        return _mm_f32(a16, b16.t())
    if kind == "einsum":
        return torch.einsum(spec, a16.float(), b16.float())
    stride, padding, dilation, groups = spec  # conv
    return torch.convolution(a16.float(), b16.float(), None, stride, padding, dilation, False,
                             [0] * len(stride), groups)


def _matmul_grads(a16, b16, g16, shapes, need):
    """d(a @ b) for operands of at least two dims: each gradient one product
    of the rounded gradient and the other rounded operand, batch dims that
    were broadcast summed after it (a 2-D b: one GEMM over the rows)."""
    sa, sb = shapes
    ga = gb = None
    if need[0]:
        ga = _mm_f32(g16, b16.mT).sum_to_size(sa)
    if need[1]:
        if b16.dim() == 2:
            gb = _mm_f32(a16.reshape(-1, sa[-1]).t(), g16.reshape(-1, sb[-1]))
        else:
            gb = _mm_f32(a16.mT, g16).sum_to_size(sb)
    return ga, gb


class Bf16Product(torch.autograd.Function):
    """One one-pass product with its one-pass gradients. forward(kind,
    spec, a, b): a, b float32; the bf16 copies are saved (half the bytes
    of the float32 operands)."""

    @staticmethod
    def forward(ctx, kind, spec, a, b):
        a16, b16 = a.to(LOW), b.to(LOW)
        ctx.save_for_backward(a16, b16)
        ctx.kind, ctx.spec, ctx.shapes = kind, spec, (a.shape, b.shape)
        return _forward(kind, spec, a16, b16)

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        g16 = g.to(LOW)
        kind, spec, need = ctx.kind, ctx.spec, ctx.needs_input_grad[2:]
        if kind == "linear":
            K = a16.shape[-1]
            ga = _mm_f32(g16, b16) if need[0] else None
            gb = (_mm_f32(g16.reshape(-1, b16.shape[0]).t(), a16.reshape(-1, K))
                  if need[1] else None)
        elif kind == "matmul" and a16.dim() >= 2 and b16.dim() >= 2:
            ga, gb = _matmul_grads(a16, b16, g16, ctx.shapes, need)
        elif kind == "einsum" and _einsum_terms(spec) is not None:
            sa, sb, so = _einsum_terms(spec)
            ga = torch.einsum(f"{so},{sb}->{sa}", g16.float(), b16.float()) if need[0] else None
            gb = torch.einsum(f"{so},{sa}->{sb}", g16.float(), a16.float()) if need[1] else None
        elif kind == "conv":
            stride, padding, dilation, groups = spec
            ga, gb, _ = torch.ops.aten.convolution_backward(
                g16.float(), a16.float(), b16.float(), None, stride, padding, dilation, False,
                [0] * len(stride), groups, [need[0], need[1], False])
        else:  # the product's own autograd on the rounded operands, fed the rounded gradient
            with torch.enable_grad():
                a = a16.float().requires_grad_(need[0])
                b = b16.float().requires_grad_(need[1])
                out = _forward(kind, spec, a, b) if kind != "matmul" else torch.matmul(a, b)
                wrt = [t for t in (a, b) if t.requires_grad]
                grads = iter(torch.autograd.grad(out, wrt, g16.float()))
            ga = next(grads) if need[0] else None
            gb = next(grads) if need[1] else None
        return None, None, ga, gb


def product(kind: str, spec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The one-pass product of float32 a and b (through Bf16Product when a
    gradient is in flight)."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return Bf16Product.apply(kind, spec, a, b)
    return _forward(kind, spec, a.to(LOW), b.to(LOW))


def _f32(*ts) -> bool:
    return all(isinstance(t, torch.Tensor) and t.dtype == torch.float32 for t in ts)


def _arg(args, kwargs, i, name, default=None):
    return args[i] if len(args) > i else kwargs.get(name, default)


def _tuple(v, n: int) -> list:
    return list(v) if isinstance(v, (tuple, list)) else [v] * n


def _linear(func, args, kwargs):
    x, w, bias = args[0], _arg(args, kwargs, 1, "weight"), _arg(args, kwargs, 2, "bias")
    if not _f32(x, w):
        return NotImplemented
    y = product("linear", None, x, w)
    return y if bias is None else y + bias


def _conv(func, args, kwargs):
    x, w, bias = args[0], _arg(args, kwargs, 1, "weight"), _arg(args, kwargs, 2, "bias")
    padding = _arg(args, kwargs, 4, "padding", 0)
    if not _f32(x, w) or isinstance(padding, str):
        return NotImplemented
    n = w.dim() - 2
    spec = (_tuple(_arg(args, kwargs, 3, "stride", 1), n), _tuple(padding, n),
            _tuple(_arg(args, kwargs, 5, "dilation", 1), n), _arg(args, kwargs, 6, "groups", 1))
    y = product("conv", spec, x, w)
    return y if bias is None else y + bias.reshape(-1, *([1] * n))


def _matmul(func, args, kwargs):
    a, b = args[0], _arg(args, kwargs, 1, "other", kwargs.get("mat2"))
    if func is torch.Tensor.__rmatmul__:
        a, b = b, a
    if not _f32(a, b):
        return NotImplemented
    return product("matmul", None, a, b)


def _addmm(func, args, kwargs):
    inp, m1, m2 = args[:3]
    beta, alpha = kwargs.get("beta", 1), kwargs.get("alpha", 1)
    if not _f32(inp, m1, m2) or len(args) > 3:
        return NotImplemented
    return beta * inp + alpha * product("matmul", None, m1, m2)


def _einsum(func, args, kwargs):
    eq, ops = args[0], args[1:]
    if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
        ops = tuple(ops[0])
    if len(ops) != 2 or not _f32(*ops):
        return NotImplemented
    return product("einsum", eq, *ops)


_PRODUCTS = {
    F.linear: _linear, F.conv1d: _conv, F.conv2d: _conv,
    torch.matmul: _matmul, torch.Tensor.matmul: _matmul, torch.Tensor.__matmul__: _matmul,
    torch.Tensor.__rmatmul__: _matmul, torch.mm: _matmul, torch.Tensor.mm: _matmul,
    torch.bmm: _matmul, torch.Tensor.bmm: _matmul, torch.addmm: _addmm,
    torch.baddbmm: _addmm, torch.einsum: _einsum,
}


class Bf16Products(TorchFunctionMode):
    """One-pass bf16 products for the float32 products in its block
    (module docstring); other calls pass through untouched."""

    def __enter__(self):
        _stack().append(True)
        try:
            return super().__enter__()
        except BaseException:
            _stack().pop()
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _stack().pop()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        handler = _PRODUCTS.get(func)
        if handler is not None and active():
            out = handler(func, args, kwargs)
            if out is not NotImplemented:
                return out
        return func(*args, **kwargs)
