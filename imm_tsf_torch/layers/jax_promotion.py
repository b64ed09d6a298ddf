"""JAX's type promotion in torch, for the mixed-precision backbone
(compute_dtype="amp_bf16", training/trainer.make_forward).

Under amp the JAX package runs the backbone on bfloat16 copies of its
parameters and float inputs (imm_tsf_tpu/training/trainer.py:235-247)
and lets jnp's promotion set every later dtype. The f32 sinusoidal table
promotes the embeddings' bf16 output to f32 in PatchTST, Informer,
TimesNet, TimeMixer and TimeLLM, and from there flax's Dense, Conv and
LayerNorm widen their bf16 parameters to f32; DLinear and TTM stay bf16
end to end. Torch's elementwise ops promote tensors as jnp does, but its
products do not promote at all, and its bf16 kernels round differently
from XLA's op-by-op bf16 arithmetic.

`JaxPromotion` is a TorchFunctionMode that applies JAX's rules in its
block, in this one place (no module is edited for them):

  - a product (`F.linear`, `F.conv1d`/`conv2d`, `F.layer_norm`, `matmul`,
    `einsum`, `bmm`, `mm`, `addmm`, `baddbmm`) widens its floating
    operands to their promoted dtype: a bf16 weight meets f32 activations
    as f32;
  - a bf16 `F.linear` or conv with a bias is the product, rounded to
    bf16, plus the bias, as flax's Dense and Conv add it after the dot;
  - a Python number in bf16 arithmetic is rounded to bf16 first (jnp's
    weak type): `x / keep_prob` divides by bf16(keep_prob);
  - a bf16 softmax is jax.nn.softmax's chain, exp(x - max) / sum, and a
    bf16 tanh-GELU jax.nn.gelu's, each op rounded to bf16 as XLA rounds
    it, where torch's fused bf16 kernels round once;
  - a bf16 `avg_pool1d` is `lax.reduce_window(add) / k`, the moving
    average of the JAX package's decomposition and TimeMixer's
    downsampling: the window summed in bf16, one rounding an addition, in
    window order, as XLA's CPU reduce_window sums (torch's kernel sums in
    float32).

Float32 arithmetic passes through untouched. The mode is Python only,
so it holds in a captured CUDA graph (what it does is what the capture
records) and under torch.export (which records the casts it inserts).

`amp_call(model, inputs, kwargs)` runs a backbone the JAX package's
amp way: its parameters cast to bf16 at the call, from the live f32
masters (autograd through the cast gives f32 gradients, rounded
through bf16 as JAX's astype VJP rounds them), its buffers (BatchNorm's
running statistics) left f32, its float inputs cast, under `JaxPromotion`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

LOW = torch.bfloat16  # the one narrow float the JAX package computes in

_PRODUCTS = frozenset({
    F.linear, F.conv1d, F.conv2d, F.layer_norm, torch.matmul, torch.Tensor.matmul,
    torch.Tensor.__matmul__, torch.Tensor.__rmatmul__, torch.einsum, torch.bmm,
    torch.Tensor.bmm, torch.mm, torch.Tensor.mm, torch.addmm, torch.baddbmm,
})
_BIASED = {F.linear: "linear", F.conv1d: "conv", F.conv2d: "conv"}
_ARITH = frozenset({
    torch.add, torch.sub, torch.mul, torch.div, torch.true_divide, torch.rsub,
    torch.Tensor.add, torch.Tensor.sub, torch.Tensor.mul, torch.Tensor.div,
    torch.Tensor.__add__, torch.Tensor.__radd__, torch.Tensor.__sub__,
    torch.Tensor.__rsub__, torch.Tensor.__mul__, torch.Tensor.__rmul__,
    torch.Tensor.__truediv__, torch.Tensor.__rtruediv__,
})
_SOFTMAX = frozenset({torch.softmax, F.softmax, torch.Tensor.softmax})
_AVG_POOL = frozenset({F.avg_pool1d, torch.avg_pool1d})


def round_bf16(v: float) -> float:
    """The Python number v rounded to the nearest bfloat16 (ties to even),
    from its double value in one rounding, as jnp converts a weak scalar."""
    v = float(v)
    if v == 0.0 or not math.isfinite(v):
        return v
    m, e = math.frexp(v)  # v = m 2^e, 0.5 <= |m| < 1
    return math.ldexp(round(m * 256.0), e - 8)  # 8 significant bits; round() ties to even


def _promoted(tensors) -> torch.dtype | None:
    dt = None
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            dt = t.dtype if dt is None else torch.promote_types(dt, t.dtype)
    return dt


def _widen(a, dt):
    if isinstance(a, torch.Tensor) and a.is_floating_point() and a.dtype != dt:
        return a.to(dt)
    if isinstance(a, (list, tuple)):  # einsum's operand list
        return type(a)(_widen(x, dt) for x in a)
    return a


def _flat(args):
    for a in args:
        if isinstance(a, (list, tuple)):
            yield from a
        else:
            yield a


def _weak(a):
    """A Python number as jnp's weak scalar meeting bf16: rounded to bf16."""
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        return round_bf16(a)
    return a


def _arg(args, kwargs, i, name, default=None):
    return args[i] if len(args) > i else kwargs.get(name, default)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(x, approximate=True) op by op on a bf16 x, its constants
    bf16 as jax.nn.gelu casts them (inside the mode's handler nothing is
    intercepted, so they are rounded here)."""
    c, k = round_bf16(math.sqrt(2.0 / math.pi)), round_bf16(0.044715)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x ** 3)))))


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """jax.nn.softmax op by op: exp(x - max) / sum, in x's dtype."""
    e = torch.exp(x - x.amax(dim=dim, keepdim=True).detach())
    return e / e.sum(dim=dim, keepdim=True)


def window_sum_avg(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """lax.reduce_window(x, 0, add, k, stride, VALID) / k over the last
    axis of a bf16 x: the sum in bf16, one rounding an addition in window
    order, then the division by bf16(k)."""
    n = (x.shape[-1] - k) // stride + 1
    span = (n - 1) * stride + 1
    acc = x[..., 0:span:stride]
    for j in range(1, k):
        acc = acc + x[..., j:j + span:stride]
    return acc / round_bf16(k)


class JaxPromotion(TorchFunctionMode):
    """JAX's promotion for torch's products and bf16 arithmetic (module
    docstring)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            dt = _promoted(_flat((*args, *kwargs.values())))
            if dt is None:
                return func(*args, **kwargs)
            args = tuple(_widen(a, dt) for a in args)
            kwargs = {k: _widen(v, dt) for k, v in kwargs.items()}
            kind = _BIASED.get(func)
            if kind is not None and dt == LOW:
                bias = _arg(args, kwargs, 2, "bias")
                if bias is not None:
                    if len(args) > 2:
                        args = (*args[:2], None, *args[3:])
                    else:
                        kwargs = dict(kwargs, bias=None)
                    y = func(*args, **kwargs)
                    if kind == "conv":  # [B, C, *spatial]: the bias on the channels
                        bias = bias.reshape(-1, *([1] * (y.ndim - 2)))
                    return y + bias
            return func(*args, **kwargs)
        if func in _ARITH:
            if _promoted(a for a in (*args[:2], kwargs.get("other")) if a is not None) == LOW:
                args = tuple(_weak(a) for a in args[:2]) + tuple(args[2:])
                if "other" in kwargs:
                    kwargs = dict(kwargs, other=_weak(kwargs["other"]))
            return func(*args, **kwargs)
        if func in _SOFTMAX:
            x = args[0]
            if (isinstance(x, torch.Tensor) and x.dtype == LOW
                    and _arg(args, kwargs, 2, "dtype") is None):
                return softmax(x, _arg(args, kwargs, 1, "dim"))
            return func(*args, **kwargs)
        if func in _AVG_POOL:
            x = args[0]
            if isinstance(x, torch.Tensor) and x.dtype == LOW:
                k = _arg(args, kwargs, 1, "kernel_size")
                stride = _arg(args, kwargs, 2, "stride") or k
                k, stride = (v[0] if isinstance(v, (tuple, list)) else v for v in (k, stride))
                if _arg(args, kwargs, 3, "padding", 0) in (0, (0,)) and not _arg(
                        args, kwargs, 4, "ceil_mode", False):
                    return window_sum_avg(x, int(k), int(stride))
            return func(*args, **kwargs)
        if func is F.gelu:
            x = args[0]
            if (isinstance(x, torch.Tensor) and x.dtype == LOW
                    and _arg(args, kwargs, 1, "approximate", "none") == "tanh"):
                return gelu_tanh(x)
        return func(*args, **kwargs)


def cast_floats(t):
    """t in bf16 when it is a floating tensor, else t."""
    return t.to(LOW) if isinstance(t, torch.Tensor) and t.is_floating_point() else t


def amp_call(model: torch.nn.Module, inputs: tuple, kwargs: dict | None = None):
    """model(*inputs, **kwargs) as the JAX package's amp_bf16 runs its
    backbone: each floating parameter cast to bf16 here (inside a
    captured step, so every replay casts the live masters), the buffers as
    they are, the floating inputs cast, under JaxPromotion."""
    params = {name: cast_floats(p) for name, p in model.named_parameters()}
    inputs = tuple(cast_floats(t) for t in inputs)
    kwargs = {k: cast_floats(v) for k, v in (kwargs or {}).items()}
    with JaxPromotion():
        return torch.func.functional_call(model, params, inputs, kwargs, strict=False)
