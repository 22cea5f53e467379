"""Elementwise and scalar math ops — the counterpart of
``paddle_tpu/ops/math.py``.

Dtypes follow the JAX package (x64 on): a float-valued op takes an integer
input to float64 (int64) or float32 (smaller integers, bool); a binary op
keeps a tensor's dtype beside a Python scalar but takes an integer tensor
to the default dtype beside a Python float (``_promote``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import dtype as _dt
from ..tensor import Tensor
from . import _inexact, _promote, apply_op, unary_op

__all__ = [
    "trace", "take", "vander", "sigmoid", "numel", "is_floating_point",
    "is_integer", "is_complex",
    # unary
    "abs", "acos", "acosh", "asin", "asinh", "atan", "atanh", "ceil", "cos",
    "cosh", "deg2rad", "rad2deg", "digamma", "erf", "erfinv", "exp", "expm1",
    "floor", "frac", "i0", "lgamma", "log", "log10", "log1p", "log2",
    "logit", "neg", "reciprocal", "round", "rsqrt", "sign", "sgn", "sin",
    "sinh", "sqrt", "square", "tan", "tanh", "trunc", "angle", "conj",
    "real", "imag", "isfinite", "isinf", "isnan", "nan_to_num",
    # binary
    "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "remainder", "pow", "maximum", "minimum", "fmax", "fmin", "atan2",
    "logaddexp", "heaviside", "hypot", "nextafter", "copysign", "gcd", "lcm",
    "ldexp", "inner", "outer", "kron", "lerp", "trapezoid",
    "cumulative_trapezoid", "diff",
    # scalar-ish / misc
    "scale", "clip", "stanh", "multiplex", "addmm",
    "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp",
    "isclose", "allclose", "equal_all",
    "increment", "count_nonzero", "broadcast_shape",
]


# ------------------------------------------------------------------ unary
def _float_unary(tfn, name):
    """An op whose result is inexact: integer inputs are made float first."""
    return unary_op(lambda v: tfn(_inexact(v)), name)


def _keep_int(tfn):
    """Rounding ops leave integer tensors as they are."""
    return lambda v: tfn(v) if v.is_floating_point() else v.clone()


abs = unary_op(torch.abs, "abs")
acos = _float_unary(torch.acos, "acos")
acosh = _float_unary(torch.acosh, "acosh")
asin = _float_unary(torch.asin, "asin")
asinh = _float_unary(torch.asinh, "asinh")
atan = _float_unary(torch.atan, "atan")
atanh = _float_unary(torch.atanh, "atanh")
ceil = unary_op(_keep_int(torch.ceil), "ceil")
cos = _float_unary(torch.cos, "cos")
cosh = _float_unary(torch.cosh, "cosh")
deg2rad = _float_unary(torch.deg2rad, "deg2rad")
rad2deg = _float_unary(torch.rad2deg, "rad2deg")
digamma = _float_unary(torch.digamma, "digamma")
erf = _float_unary(torch.erf, "erf")
erfinv = _float_unary(torch.erfinv, "erfinv")
exp = _float_unary(torch.exp, "exp")
expm1 = _float_unary(torch.expm1, "expm1")
floor = unary_op(_keep_int(torch.floor), "floor")
i0 = _float_unary(torch.i0, "i0")
lgamma = _float_unary(torch.lgamma, "lgamma")
log = _float_unary(torch.log, "log")
log10 = _float_unary(torch.log10, "log10")
log1p = _float_unary(torch.log1p, "log1p")
log2 = _float_unary(torch.log2, "log2")
neg = unary_op(torch.neg, "neg")
reciprocal = _float_unary(torch.reciprocal, "reciprocal")
round = unary_op(_keep_int(torch.round), "round")
rsqrt = _float_unary(torch.rsqrt, "rsqrt")
sign = unary_op(torch.sign, "sign")
sgn = unary_op(torch.sgn, "sgn")
sin = _float_unary(torch.sin, "sin")
sinh = _float_unary(torch.sinh, "sinh")
sqrt = _float_unary(torch.sqrt, "sqrt")
square = unary_op(torch.square, "square")
tan = _float_unary(torch.tan, "tan")
tanh = _float_unary(torch.tanh, "tanh")
trunc = unary_op(_keep_int(torch.trunc), "trunc")
angle = _float_unary(torch.angle, "angle")
conj = unary_op(torch.conj_physical, "conj")
real = unary_op(torch.real, "real")
imag = unary_op(torch.imag, "imag")
isfinite = unary_op(torch.isfinite, "isfinite")
isinf = unary_op(torch.isinf, "isinf")
isnan = unary_op(torch.isnan, "isnan")
sigmoid = _float_unary(torch.sigmoid, "sigmoid")


def frac(x, name=None):
    return apply_op(lambda v: v - torch.trunc(v), "frac", x)


def logit(x, eps=None, name=None):
    def f(v):
        u = _inexact(v)
        if eps is not None:
            u = u.clamp(eps, 1.0 - eps)
        return torch.log(u / (1.0 - u))

    return apply_op(f, "logit", x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply_op(lambda v: torch.nan_to_num(v, nan, posinf, neginf),
                    "nan_to_num", x)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply_op(lambda v: scale_b * torch.tanh(scale_a * v), "stanh", x)


# ------------------------------------------------------------------ binary
def _binop(tfn, name, inexact=False):
    """A binary op over ``_promote``d operands (``inexact``: made float
    first, for ops with a float result)."""
    def f(a, b):
        a, b = _promote(a, b)
        if inexact:
            a, b = _inexact(a), _inexact(b)
        return tfn(a, b)

    def op(x, y, name=None):
        return apply_op(f, op.__name__, x, y)

    op.__name__ = op.__qualname__ = name
    return op


add = _binop(torch.add, "add")
subtract = _binop(torch.sub, "subtract")
multiply = _binop(torch.mul, "multiply")
mod = _binop(torch.remainder, "mod")
remainder = mod
floor_divide = _binop(torch.floor_divide, "floor_divide")
maximum = _binop(torch.maximum, "maximum")
minimum = _binop(torch.minimum, "minimum")
fmax = _binop(torch.fmax, "fmax")
fmin = _binop(torch.fmin, "fmin")
atan2 = _binop(torch.atan2, "atan2", inexact=True)
logaddexp = _binop(torch.logaddexp, "logaddexp", inexact=True)
heaviside = _binop(torch.heaviside, "heaviside")
hypot = _binop(torch.hypot, "hypot", inexact=True)
nextafter = _binop(torch.nextafter, "nextafter")
copysign = _binop(torch.copysign, "copysign", inexact=True)
gcd = _binop(torch.gcd, "gcd")
lcm = _binop(torch.lcm, "lcm")


def ldexp(x, y, name=None):
    return apply_op(lambda a, b: torch.ldexp(_inexact(a), b), "ldexp", x, y)


def divide(x, y, name=None):
    """True division; integer / integer gives the default dtype (paddle)."""
    def f(a, b):
        a, b = _promote(a, b)
        if not (a.is_floating_point() or a.is_complex()):
            a, b = (t.to(_dt.get_default_dtype()) for t in (a, b))
        return torch.true_divide(a, b)

    return apply_op(f, "divide", x, y)


def pow(x, y, name=None):
    """A float exponent takes an integer base to float (int64: float64);
    an integer one keeps it."""
    def f(a, b):
        if not isinstance(a, torch.Tensor):     # a scalar base: 2 ** x
            a, b = _promote(a, b)
            return torch.pow(a.item(), b)
        if isinstance(b, float):
            a = _inexact(a)
        if isinstance(b, (int, float)):
            return torch.pow(a, b)
        a, b = _promote(a, b)
        return torch.pow(a, b)

    return apply_op(f, "pow", x, y)


def inner(x, y, name=None):
    return apply_op(lambda a, b: torch.inner(*_promote(a, b)), "inner", x, y)


def outer(x, y, name=None):
    return apply_op(lambda a, b: torch.outer(*_promote(a, b)), "outer", x, y)


def kron(x, y, name=None):
    return apply_op(lambda a, b: torch.kron(*_promote(a, b)), "kron", x, y)


def lerp(x, y, weight, name=None):
    def f(a, b, w):
        a, b = _promote(a, b)
        return a + w * (b - a)

    return apply_op(f, "lerp", x, y, weight)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    def f(yv, xv):
        if xv is not None:
            return torch.trapezoid(yv, xv, dim=axis)
        return torch.trapezoid(yv, dx=1.0 if dx is None else dx, dim=axis)

    return apply_op(f, "trapezoid", y, x)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    def f(yv, xv):
        if xv is not None:
            return torch.cumulative_trapezoid(yv, xv, dim=axis)
        return torch.cumulative_trapezoid(yv, dx=1.0 if dx is None else dx,
                                          dim=axis)

    return apply_op(f, "cumulative_trapezoid", y, x)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return apply_op(lambda v, p, a: torch.diff(v, n, axis, p, a), "diff",
                    x, prepend, append)


# ------------------------------------------------------------------ misc
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    def f(v, sv):
        s = scale if sv is None else sv
        out = v * s + bias if bias_after_scale else (v + bias) * s
        return out if v.is_floating_point() else out.to(v.dtype)

    return apply_op(f, "scale", x, scale if isinstance(scale, Tensor)
                    else None)


def clip(x, min=None, max=None, name=None):
    return apply_op(lambda v, lo, hi: torch.clamp(v, lo, hi), "clip",
                    x, min, max)


def multiplex(inputs, index, name=None):
    def f(idx, *ins):
        stacked = torch.stack(ins, 0)
        rows = torch.arange(stacked.shape[1], device=stacked.device)
        return stacked[idx.reshape(-1).long(), rows]

    return apply_op(f, "multiplex", index, *inputs)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply_op(lambda i, a, b: beta * i + alpha * (a @ b), "addmm",
                    input, x, y)


def _scan_dtype(v, dtype):
    """cumsum / cumprod keep an integer dtype (bool counts in int64), as
    JAX does; torch would widen every integer to int64."""
    d = _dt.convert_dtype(dtype)
    if d is not None:
        return d
    if v.dtype == torch.bool:
        return torch.int64
    return v.dtype


def _flat_axis(v, axis):
    return (v.reshape(-1), 0) if axis is None else (v, axis)


def cumsum(x, axis=None, dtype=None, name=None):
    def f(v):
        v, ax = _flat_axis(v, axis)
        return torch.cumsum(v, ax, dtype=_scan_dtype(v, dtype))

    return apply_op(f, "cumsum", x)


def cumprod(x, dim=None, dtype=None, name=None):
    def f(v):
        v, ax = _flat_axis(v, dim)
        return torch.cumprod(v, ax, dtype=_scan_dtype(v, dtype))

    return apply_op(f, "cumprod", x)


def _cum_extreme(tfn, name, x, axis, dtype):
    def f(v):
        v, ax = _flat_axis(v, axis)
        vals, idx = tfn(v, ax)
        return vals, idx.to(_dt.convert_dtype(dtype))

    return apply_op(f, name, x)


def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(torch.cummax, "cummax", x, axis, dtype)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(torch.cummin, "cummin", x, axis, dtype)


def logcumsumexp(x, axis=None, dtype=None, name=None):
    def f(v):
        v, ax = _flat_axis(v, axis)
        return torch.logcumsumexp(v, ax)

    return apply_op(f, "logcumsumexp", x)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply_op(lambda a, b: torch.isclose(*_promote(a, b), rtol, atol,
                                               equal_nan), "isclose", x, y)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply_op(lambda a, b: torch.isclose(*_promote(a, b), rtol, atol,
                                               equal_nan).all(),
                    "allclose", x, y)


def equal_all(x, y, name=None):
    def f(a, b):
        same = a.shape == b.shape
        return (torch.eq(a, b).all() if same
                else torch.tensor(False, device=a.device))

    return apply_op(f, "equal_all", x, y)


def increment(x, value=1.0, name=None):
    return x._assign(x._value + value)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    def f(v):
        out = torch.count_nonzero(v, axis)
        if keepdim:
            axes = range(v.dim()) if axis is None else (
                axis if isinstance(axis, (list, tuple)) else [axis])
            for a in sorted(a % v.dim() for a in axes):
                out = out.unsqueeze(a)
        return out.to(torch.int64)

    return apply_op(f, "count_nonzero", x)


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op(lambda v: torch.diagonal(v, offset, axis1, axis2).sum(-1),
                    "trace", x)


def take(x, index, mode="raise", name=None):
    """Flat-index gather; out-of-range indices clip ("raise", "clip") or
    wrap, as JAX's ``jnp.take`` modes."""
    def f(v, i):
        flat = v.reshape(-1)
        n = flat.numel()
        i = i.long()
        i = torch.remainder(i, n) if mode == "wrap" else i.clamp(-n, n - 1)
        return flat[torch.where(i < 0, i + n, i)]

    return apply_op(f, "take", x, index)


def vander(x, n=None, increasing=False, name=None):
    return apply_op(lambda v: torch.vander(v, n, increasing), "vander", x)


def numel(x, name=None):
    return Tensor(torch.tensor(x.size, dtype=torch.int64,
                               device=x._value.device))


def _dtype_of(x):
    return x.dtype if isinstance(x, (Tensor, torch.Tensor)) else \
        _dt.convert_dtype(np.asarray(x).dtype)


def is_floating_point(x):
    return _dtype_of(x).is_floating_point


def is_integer(x):
    d = _dtype_of(x)
    return not (d.is_floating_point or d.is_complex or d == torch.bool)


def is_complex(x):
    return _dtype_of(x).is_complex

