"""The op surface bound onto Tensor as methods and operators — the
counterpart of ``paddle_tpu/ops/patch_methods.py`` (and of the in-place
variants ``paddle_tpu/ops/__init__.py`` makes).

Every public op of the op modules becomes a method (``x.sum(1).sqrt()``).
In-place variants (``x.add_(y)``, ``paddle.tanh_(x)``) run the op out of
place and give the result to the tensor (``Tensor._assign``): with grad on
the graph runs on through it, under ``no_grad`` a leaf is written in its
own storage. A reflected operator (``2.0 - x``) passes its Python scalar
on to the op, which types it as JAX's ``_rhs_dtype`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..tensor import Tensor
from . import (
    creation,
    einsum as _einsum,
    indexing,
    linalg,
    logic,
    manipulation,
    math,
    parity,
    random as _random,
    reduction,
    search,
)

_MODULES = [math, manipulation, logic, reduction, search, linalg, creation]

_SKIP = {"to_tensor", "meshgrid", "broadcast_shape", "assign"}

for _mod in _MODULES:
    for _name in getattr(_mod, "__all__", []):
        if _name in _SKIP or hasattr(Tensor, _name):
            continue
        setattr(Tensor, _name, getattr(_mod, _name))

# explicit extras / renames
Tensor.astype = lambda self, dtype: manipulation.cast(self, dtype)
Tensor.cast = Tensor.astype
Tensor.type_as = lambda self, other: manipulation.cast(self, other.dtype)
Tensor.reshape = manipulation.reshape
Tensor.reshape_ = manipulation.reshape_
Tensor.numel = lambda self: math.numel(self)
Tensor.element_size = lambda self: self._value.element_size()
Tensor.rank = lambda self: Tensor(torch.tensor(self.ndim,
                                               device=self._value.device))
Tensor.mm = linalg.mm
Tensor.matmul = linalg.matmul
Tensor.dot = linalg.dot
Tensor.norm = linalg.norm
Tensor.unique = search.unique
Tensor.einsum = lambda self, eq, *others: _einsum.einsum(eq, self, *others)
Tensor.fill_ = lambda self, v: self._assign(torch.full_like(self._value, v))
Tensor.zero_ = lambda self: self._assign(torch.zeros_like(self._value))
Tensor.uniform_ = _random.uniform_
Tensor.normal_ = _random.normal_
Tensor.exponential_ = _random.exponential_


def _make_inplace(base, name):
    """``base``'s in-place variant: the op out of place, its result given
    to the tensor."""
    def inplace(self, *args, **kwargs):
        return self._assign(base(self, *args, **kwargs)._value)

    inplace.__name__ = inplace.__qualname__ = name
    inplace.__doc__ = (f"In-place variant of `{name[:-1]}`: mutates and "
                       f"returns the input tensor.")
    return inplace


# the reference's in-place set (JAX ``_INPLACE_BASES`` and the method set)
_INPLACE_BASES = [
    "abs", "acos", "addmm", "atan", "bitwise_and", "bitwise_left_shift",
    "bitwise_not", "bitwise_or", "bitwise_right_shift", "bitwise_xor",
    "cast", "copysign", "cos", "cumprod", "cumsum", "digamma", "divide",
    "equal", "erf", "expm1", "floor_divide", "frac", "gcd", "greater_equal",
    "greater_than", "hypot", "i0", "index_add", "index_put", "lcm", "ldexp",
    "less_equal", "less_than", "lgamma", "log10", "log2", "log",
    "logical_and", "logical_not", "logical_or", "logit", "masked_fill",
    "masked_scatter", "mod", "multiply", "nan_to_num", "neg", "pow",
    "remainder", "scatter", "sin", "sinh", "square", "t", "tan", "tanh",
    "transpose", "tril", "triu", "trunc", "where", "add", "subtract",
    "scale", "clip", "floor", "ceil", "round", "sqrt", "rsqrt", "exp",
    "gammaln", "gammainc", "gammaincc", "multigammaln", "polygamma",
    "renorm", "sinc", "floor_mod", "less",
]
_MOD_OF = {n: m for m in _MODULES + [parity]
           for n in getattr(m, "__all__", [])}
INPLACE = {}
for _base in _INPLACE_BASES:
    _fn = getattr(_MOD_OF[_base], _base)
    INPLACE[_base + "_"] = _make_inplace(_fn, _base + "_")
INPLACE["bitwise_invert_"] = INPLACE["bitwise_not_"]
INPLACE["index_fill_"] = parity.index_fill_
for _name, _fn in INPLACE.items():
    if not hasattr(Tensor, _name):
        setattr(Tensor, _name, _fn)


# ------------------------------------------------------------------ operators
def _is_bool(t):
    return t.dtype == torch.bool


def _lhs(s, o):
    """``o`` as the left operand of a reflected operator on ``s``: a Python
    or numpy scalar stays a scalar (``ops._as_operand`` gives it its dtype,
    JAX's ``_rhs_dtype``), anything else becomes a Tensor on ``s``'s
    device."""
    if isinstance(o, (Tensor, int, float, complex, np.generic)):
        return o
    return Tensor(torch.as_tensor(np.asarray(o), device=s._value.device))


Tensor.__getitem__ = indexing.getitem
Tensor.__setitem__ = indexing.setitem

Tensor.__add__ = lambda s, o: math.add(s, o)
Tensor.__radd__ = lambda s, o: math.add(_lhs(s, o), s)
Tensor.__sub__ = lambda s, o: math.subtract(s, o)
Tensor.__rsub__ = lambda s, o: math.subtract(_lhs(s, o), s)
Tensor.__mul__ = lambda s, o: math.multiply(s, o)
Tensor.__rmul__ = lambda s, o: math.multiply(_lhs(s, o), s)
Tensor.__truediv__ = lambda s, o: math.divide(s, o)
Tensor.__rtruediv__ = lambda s, o: math.divide(_lhs(s, o), s)
Tensor.__floordiv__ = lambda s, o: math.floor_divide(s, o)
Tensor.__rfloordiv__ = lambda s, o: math.floor_divide(_lhs(s, o), s)
Tensor.__mod__ = lambda s, o: math.mod(s, o)
Tensor.__rmod__ = lambda s, o: math.mod(_lhs(s, o), s)
Tensor.__pow__ = lambda s, o: math.pow(s, o)
Tensor.__rpow__ = lambda s, o: math.pow(_lhs(s, o), s)
Tensor.__neg__ = lambda s: math.neg(s)
Tensor.__abs__ = lambda s: math.abs(s)
Tensor.__matmul__ = lambda s, o: linalg.matmul(s, o)
Tensor.__rmatmul__ = lambda s, o: linalg.matmul(_lhs(s, o), s)

Tensor.__eq__ = lambda s, o: logic.equal(s, o)
Tensor.__ne__ = lambda s, o: logic.not_equal(s, o)
Tensor.__lt__ = lambda s, o: logic.less_than(s, o)
Tensor.__le__ = lambda s, o: logic.less_equal(s, o)
Tensor.__gt__ = lambda s, o: logic.greater_than(s, o)
Tensor.__ge__ = lambda s, o: logic.greater_equal(s, o)

Tensor.__and__ = lambda s, o: (logic.logical_and(s, o) if _is_bool(s)
                               else logic.bitwise_and(s, o))
Tensor.__or__ = lambda s, o: (logic.logical_or(s, o) if _is_bool(s)
                              else logic.bitwise_or(s, o))
Tensor.__xor__ = lambda s, o: (logic.logical_xor(s, o) if _is_bool(s)
                               else logic.bitwise_xor(s, o))
Tensor.__invert__ = lambda s: (logic.logical_not(s) if _is_bool(s)
                               else logic.bitwise_not(s))
Tensor.__lshift__ = lambda s, o: logic.bitwise_left_shift(s, o)
Tensor.__rshift__ = lambda s, o: logic.bitwise_right_shift(s, o)

Tensor.T = property(lambda s: manipulation.transpose(s))
Tensor.mT = property(lambda s: manipulation.swapaxes(s, -1, -2))
