"""Creation ops — the counterpart of ``paddle_tpu/ops/creation.py``. New
tensors go on the current place (``framework.device``); ``*_like`` ops on
their input's device."""
from __future__ import annotations

import numpy as np
import torch

from ..framework import dtype as _dt
from ..tensor import Tensor, to_tensor  # noqa: F401 (re-exported)
from . import _place, apply_op

__all__ = ["to_tensor", "zeros", "ones", "full", "zeros_like", "ones_like",
           "full_like", "empty", "empty_like", "arange", "linspace",
           "logspace", "eye", "diag", "diagflat", "tril", "triu", "meshgrid",
           "assign", "clone", "complex", "tril_indices", "triu_indices",
           "one_hot"]


def _shape_list(shape):
    if isinstance(shape, Tensor):
        return [int(s) for s in shape.tolist()]
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(s.item()) if isinstance(s, Tensor) else int(s) for s in shape]


def _scalar(v):
    return v.item() if isinstance(v, Tensor) else v


def zeros(shape, dtype=None, name=None):
    dtype = _dt.convert_dtype(dtype) or _dt.get_default_dtype()
    return Tensor(torch.zeros(_shape_list(shape), dtype=dtype,
                              device=_place()))


def ones(shape, dtype=None, name=None):
    dtype = _dt.convert_dtype(dtype) or _dt.get_default_dtype()
    return Tensor(torch.ones(_shape_list(shape), dtype=dtype,
                             device=_place()))


def full(shape, fill_value, dtype=None, name=None):
    """Bool fill values give bool; every other fill the default dtype
    (paddle's ``full`` defaults to float)."""
    dtype = _dt.convert_dtype(dtype)
    fill_value = _scalar(fill_value)
    if dtype is None:
        dtype = (torch.bool if isinstance(fill_value, bool)
                 else _dt.get_default_dtype())
    return Tensor(torch.full(_shape_list(shape), fill_value, dtype=dtype,
                             device=_place()))


def _like(x, fn, dtype, *args):
    v = x._value if isinstance(x, Tensor) else torch.as_tensor(x)
    return Tensor(fn(v, *args, dtype=_dt.convert_dtype(dtype) or v.dtype))


def zeros_like(x, dtype=None, name=None):
    return _like(x, torch.zeros_like, dtype)


def ones_like(x, dtype=None, name=None):
    return _like(x, torch.ones_like, dtype)


def full_like(x, fill_value, dtype=None, name=None):
    return _like(x, torch.full_like, dtype, _scalar(fill_value))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    """int64 for integer arguments, the default dtype for float ones."""
    if end is None:
        start, end = 0, start
    s, e, st = _scalar(start), _scalar(end), _scalar(step)
    dtype = _dt.convert_dtype(dtype)
    if dtype is None:
        dtype = (_dt.get_default_dtype()
                 if any(isinstance(v, float) for v in (s, e, st))
                 else torch.int64)
    return Tensor(torch.arange(s, e, st, dtype=dtype, device=_place()))


def linspace(start, stop, num, dtype=None, name=None):
    dtype = _dt.convert_dtype(dtype) or _dt.get_default_dtype()
    return Tensor(torch.linspace(float(_scalar(start)), float(_scalar(stop)),
                                 int(_scalar(num)), dtype=dtype,
                                 device=_place()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    dtype = _dt.convert_dtype(dtype) or _dt.get_default_dtype()
    return Tensor(torch.logspace(float(_scalar(start)), float(_scalar(stop)),
                                 int(_scalar(num)), base=float(base),
                                 dtype=dtype, device=_place()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    dtype = _dt.convert_dtype(dtype) or _dt.get_default_dtype()
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return Tensor(torch.eye(n, m, dtype=dtype, device=_place()))


def diag(x, offset=0, padding_value=0, name=None):
    def f(v):
        out = torch.diag(v, offset)
        if padding_value != 0 and v.dim() == 1:
            on = torch.diag(torch.ones_like(v, dtype=torch.bool), offset)
            out = torch.where(on, out, torch.full_like(out, padding_value))
        return out

    return apply_op(f, "diag", x)


def diagflat(x, offset=0, name=None):
    return apply_op(lambda v: torch.diagflat(v, offset), "diagflat", x)


def tril(x, diagonal=0, name=None):
    return apply_op(lambda v: torch.tril(v, diagonal), "tril", x)


def triu(x, diagonal=0, name=None):
    return apply_op(lambda v: torch.triu(v, diagonal), "triu", x)


def tril_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return Tensor(torch.tril_indices(row, col, offset, device=_place())
                  .to(_dt.convert_dtype(dtype)))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return Tensor(torch.triu_indices(row, col, offset, device=_place())
                  .to(_dt.convert_dtype(dtype)))


def meshgrid(*args, **kwargs):
    tensors = (args[0] if len(args) == 1 and isinstance(args[0], (list, tuple))
               else args)
    return apply_op(lambda *vs: list(torch.meshgrid(*vs, indexing="ij")),
                    "meshgrid", *tensors)


def assign(x, output=None):
    src = x if isinstance(x, Tensor) else to_tensor(np.asarray(x))
    out = apply_op(torch.clone, "assign", src)
    if output is not None:
        output._assign(out._value)
        return output
    return out


def clone(x, name=None):
    return x.clone()


def complex(real, imag, name=None):
    return apply_op(torch.complex, "complex", real, imag)


def one_hot(x, num_classes, name=None):
    return apply_op(
        lambda v: torch.nn.functional.one_hot(v.long(), num_classes)
        .to(_dt.get_default_dtype()), "one_hot", x)
