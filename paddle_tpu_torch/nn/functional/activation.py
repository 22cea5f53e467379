"""Activations — the counterpart of
``paddle_tpu/nn/functional/activation.py``. Each runs through the op
layer (``ops.apply_like``) under the JAX package's op name, so AMP casts
it by name, and returns the kind it is given (a Tensor for a Tensor, a
torch tensor for a torch tensor). The formulas are JAX's (``jax.nn``);
the in-place forms rebind the Tensor they are given."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...framework import dtype as _dt
from ...framework.random import default_generator
from ...ops import apply_like

__all__ = [
    "relu", "relu_", "relu6", "elu", "elu_", "selu", "celu", "gelu", "silu",
    "swish", "sigmoid", "hardsigmoid", "hardswish", "hardtanh", "hardshrink",
    "softshrink", "tanhshrink", "leaky_relu", "log_sigmoid", "log_softmax",
    "softmax", "softmax_", "softplus", "softsign", "mish", "prelu", "rrelu",
    "maxout", "glu", "gumbel_softmax", "tanh", "thresholded_relu",
]


def _zero(v):
    return torch.zeros((), dtype=v.dtype, device=v.device)


def _inplace(x, out):
    """``x`` (a Tensor) takes ``out``'s value and graph."""
    return x._assign(out._value)


def relu(x, name=None):
    return apply_like(torch.relu, "relu", x)


def relu_(x, name=None):
    return _inplace(x, relu(x))


def relu6(x, name=None):
    return apply_like(lambda v: torch.clamp(v, 0.0, 6.0), "relu6", x)


def elu(x, alpha=1.0, name=None):
    return apply_like(
        lambda v: torch.where(v > 0, v, alpha * torch.expm1(v)), "elu", x)


def elu_(x, alpha=1.0, name=None):
    return _inplace(x, elu(x, alpha))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply_like(
        lambda v: scale * torch.where(v > 0, v, alpha * torch.expm1(v)),
        "selu", x)


def celu(x, alpha=1.0, name=None):
    return apply_like(lambda v: tF.celu(v, alpha), "celu", x)


def gelu(x, approximate=False, name=None):
    """x * Phi(x) with the exact erf (``jax.nn.gelu(approximate=False)``),
    or its tanh approximation with ``approximate=True``."""
    return apply_like(
        lambda v: tF.gelu(v, approximate="tanh" if approximate else "none"),
        "gelu", x)


def silu(x, name=None):
    """x * sigmoid(x)."""
    return apply_like(tF.silu, "silu", x)


def swish(x, name=None):
    return silu(x)


def sigmoid(x, name=None):
    return apply_like(torch.sigmoid, "sigmoid", x)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return apply_like(lambda v: torch.clamp(slope * v + offset, 0.0, 1.0),
                      "hardsigmoid", x)


def hardswish(x, name=None):
    return apply_like(lambda v: v * torch.clamp(v + 3.0, 0.0, 6.0) / 6.0,
                      "hardswish", x)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply_like(lambda v: torch.clamp(v, min, max), "hardtanh", x)


def hardshrink(x, threshold=0.5, name=None):
    return apply_like(
        lambda v: torch.where(v.abs() > threshold, v, _zero(v)),
        "hardshrink", x)


def softshrink(x, threshold=0.5, name=None):
    return apply_like(
        lambda v: torch.where(v > threshold, v - threshold, torch.where(
            v < -threshold, v + threshold, _zero(v))), "softshrink", x)


def tanhshrink(x, name=None):
    return apply_like(lambda v: v - torch.tanh(v), "tanhshrink", x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply_like(lambda v: torch.where(v >= 0, v, negative_slope * v),
                      "leaky_relu", x)


def log_sigmoid(x, name=None):
    return apply_like(tF.logsigmoid, "log_sigmoid", x)


def _cast(v, dtype):
    return v if dtype is None else v.to(_dt.convert_dtype(dtype))


def log_softmax(x, axis=-1, dtype=None, name=None):
    return apply_like(lambda v: torch.log_softmax(_cast(v, dtype), axis),
                      "log_softmax", x)


def softmax(x, axis=-1, dtype=None, name=None):
    return apply_like(lambda v: torch.softmax(_cast(v, dtype), axis),
                      "softmax", x)


def softmax_(x, axis=-1, dtype=None, name=None):
    return _inplace(x, softmax(x, axis, dtype))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return apply_like(
        lambda v: torch.where(beta * v > threshold, v,
                              torch.log1p(torch.exp(beta * v)) / beta),
        "softplus", x)


def softsign(x, name=None):
    return apply_like(lambda v: v / (1 + v.abs()), "softsign", x)


def mish(x, name=None):
    """x * tanh(softplus(x)), softplus as ``jax.nn.softplus``
    (log(1 + e^x) = logaddexp(x, 0), with no threshold)."""
    return apply_like(
        lambda v: v * torch.tanh(torch.logaddexp(v, _zero(v))), "mish", x)


def prelu(x, weight, data_format="NCHW", name=None):
    """max(x, 0) + w min(x, 0): one slope, or one per channel (axis 1 of an
    NC... input, the last axis otherwise)."""
    def f(v, w):
        if w.numel() == 1:
            wb = w.reshape(())
        else:
            nd = v.dim()
            ch = 1 if data_format.startswith("NC") and nd > 1 else nd - 1
            shape = [1] * nd
            shape[ch] = w.numel()
            wb = w.reshape(shape)
        return torch.where(v > 0, v, wb * v)

    return apply_like(f, "prelu", x, weight)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None):
    """Negative inputs scaled by a slope drawn from U(lower, upper) per
    element in training (the device's default generator), by their mean in
    inference."""
    if training:
        def f(v):
            a = torch.empty(v.shape, dtype=torch.float32, device=v.device)
            a.uniform_(lower, upper, generator=default_generator(v.device))
            return torch.where(v >= 0, v, a.to(v.dtype) * v)

        return apply_like(f, "rrelu", x)
    mid = (lower + upper) / 2.0
    return apply_like(lambda v: torch.where(v >= 0, v, mid * v), "rrelu", x)


def maxout(x, groups, axis=1, name=None):
    def f(v):
        ax = axis % v.dim()
        c = v.shape[ax]
        shape = list(v.shape[:ax]) + [c // groups, groups] + list(
            v.shape[ax + 1:])
        return torch.amax(v.reshape(shape), dim=ax + 1)

    return apply_like(f, "maxout", x)


def glu(x, axis=-1, name=None):
    """a * sigmoid(b) of the two halves along ``axis``."""
    def f(v):
        a, b = torch.chunk(v, 2, dim=axis)
        return a * torch.sigmoid(b)

    return apply_like(f, "glu", x)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature), g Gumbel(0, 1) from the device's
    default generator; ``hard``: the one-hot of the argmax, with the soft
    gradient (straight through)."""
    def f(v):
        e = torch.empty_like(v).exponential_(
            generator=default_generator(v.device))
        y = torch.softmax((v - torch.log(e)) / temperature, axis)
        if hard:
            idx = torch.argmax(y, dim=axis, keepdim=True)
            hard_y = torch.zeros_like(y).scatter_(axis, idx, 1.0)
            y = hard_y + y - y.detach()
        return y

    return apply_like(f, "gumbel_softmax", x)


def tanh(x, name=None):
    return apply_like(torch.tanh, "tanh", x)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return apply_like(
        lambda v: torch.where(v > threshold, v,
                              torch.full((), value, dtype=v.dtype,
                                         device=v.device)),
        "thresholded_relu", x)
