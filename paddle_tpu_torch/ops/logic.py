"""Comparison and logical ops — the counterpart of
``paddle_tpu/ops/logic.py``."""
from __future__ import annotations

import torch

from ..tensor import Tensor
from . import _promote, apply_op

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift", "is_empty", "is_tensor",
    "isreal", "iscomplex",
]


def _cmp(tfn, name):
    def op(x, y, name=None):
        return apply_op(lambda a, b: tfn(*_promote(a, b)), op.__name__, x, y)

    op.__name__ = op.__qualname__ = name
    return op


equal = _cmp(torch.eq, "equal")
not_equal = _cmp(torch.ne, "not_equal")
greater_than = _cmp(torch.gt, "greater_than")
greater_equal = _cmp(torch.ge, "greater_equal")
less_than = _cmp(torch.lt, "less_than")
less_equal = _cmp(torch.le, "less_equal")
logical_and = _cmp(torch.logical_and, "logical_and")
logical_or = _cmp(torch.logical_or, "logical_or")
logical_xor = _cmp(torch.logical_xor, "logical_xor")
bitwise_and = _cmp(torch.bitwise_and, "bitwise_and")
bitwise_or = _cmp(torch.bitwise_or, "bitwise_or")
bitwise_xor = _cmp(torch.bitwise_xor, "bitwise_xor")
bitwise_left_shift = _cmp(torch.bitwise_left_shift, "bitwise_left_shift")
bitwise_right_shift = _cmp(torch.bitwise_right_shift, "bitwise_right_shift")


def logical_not(x, name=None):
    return apply_op(torch.logical_not, "logical_not", x)


def bitwise_not(x, name=None):
    return apply_op(torch.bitwise_not, "bitwise_not", x)


def is_empty(x, name=None):
    return Tensor(torch.tensor(x.size == 0, device=x._value.device))


def is_tensor(x):
    return isinstance(x, Tensor)


def isreal(x, name=None):
    return apply_op(torch.isreal, "isreal", x)


def iscomplex(x):
    return x.dtype.is_complex
