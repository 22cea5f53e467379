"""``x[i]`` and ``x[i] = v`` — the counterpart of
``paddle_tpu/ops/indexing.py``.

Reads go through ``apply_op``, so they are differentiable. A write is the
JAX package's ``.at[i].set(v)``: it is computed out of place (a copy of
the value with the slice written, ``index_put`` for index tensors) and
rebound into the tensor (``Tensor._assign``), so a leaf that needs a
gradient can be written and the graph runs on through the new value. A
boolean mask has a data-dependent count; torch reads it back to the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..tensor import Tensor
from . import apply_op


def _convert_one(i, device):
    if isinstance(i, Tensor):
        i = i._value
    if isinstance(i, torch.Tensor):
        return i.to(device) if i.dtype == torch.bool else i.long().to(device)
    if isinstance(i, (list, np.ndarray)):
        arr = np.asarray(i)
        t = torch.as_tensor(arr, device=device)
        return t if t.dtype == torch.bool else t.long()
    return i        # int / slice / None / Ellipsis


def _convert_index(item, device):
    if isinstance(item, tuple):
        return tuple(_convert_one(i, device) for i in item)
    return _convert_one(item, device)


def getitem(x, item):
    idx = _convert_index(item, x._value.device)
    return apply_op(lambda v: v[idx], "getitem", x)


def setitem(x, item, value):
    v = x._value
    idx = _convert_index(item, v.device)
    if isinstance(value, Tensor):
        val = value._value.to(v.dtype)
    elif isinstance(value, torch.Tensor):
        val = value.to(v.device, v.dtype)
    elif isinstance(value, (int, float, bool)):
        val = value
    else:
        val = torch.as_tensor(np.asarray(value), device=v.device).to(v.dtype)
    out = v.clone()
    out[idx] = val
    return x._assign(out)
