"""Dtypes — the counterpart of ``paddle_tpu/framework/dtype.py``.

Paddle names its dtypes ``paddle.float32``, ``paddle.int64``, ... with a
``get_default_dtype`` / ``set_default_dtype`` pair. In the JAX package the
dtypes are numpy dtypes; here they ARE ``torch.dtype`` objects, so the op
layer hands them to torch as they are. ``convert_dtype`` takes any spelling
a user writes (a paddle name, a numpy dtype or type, a torch dtype) and
``dtype_to_str`` gives the paddle name back, which is how the tests compare
a port dtype with a JAX one.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "convert_dtype", "dtype_to_str", "set_default_dtype",
           "get_default_dtype", "is_floating_dtype", "is_integer_dtype",
           "is_complex_dtype", "finfo", "iinfo"]

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_STR_ALIASES = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16,
    "bfloat16": bfloat16, "bf16": bfloat16, "float32": float32,
    "float64": float64, "complex64": complex64, "complex128": complex128,
    "fp16": float16, "fp32": float32, "fp64": float64,
}
_NAMES = {d: n for n, d in _STR_ALIASES.items()
          if not n.startswith(("fp", "bf1"))}


def convert_dtype(dtype):
    """Any user-facing dtype spec (str, numpy dtype or type, python type,
    torch dtype) as a ``torch.dtype``; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in _STR_ALIASES:
            return _STR_ALIASES[key]
        dtype = np.dtype(key)
    name = np.dtype(dtype).name
    if name not in _STR_ALIASES:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _STR_ALIASES[name]


def dtype_to_str(dtype) -> str:
    """The paddle name of ``dtype`` ("float32", "int64", "bool", ...)."""
    d = convert_dtype(dtype)
    return "None" if d is None else _NAMES[d]


_default = {"dtype": float32}


def set_default_dtype(d):
    """``paddle.set_default_dtype``: floating types only, as in paddle."""
    d = convert_dtype(d)
    if d not in (float16, bfloat16, float32, float64):
        raise TypeError("set_default_dtype only supports float16/bfloat16/"
                        f"float32/float64, got {d}")
    _default["dtype"] = d


def get_default_dtype():
    return _default["dtype"]


def is_floating_dtype(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer_dtype(dtype) -> bool:
    d = convert_dtype(dtype)
    return not (d.is_floating_point or d.is_complex or d == bool_)


def is_complex_dtype(dtype) -> bool:
    return convert_dtype(dtype).is_complex


def finfo(dtype):
    return torch.finfo(convert_dtype(dtype))


def iinfo(dtype):
    return torch.iinfo(convert_dtype(dtype))
