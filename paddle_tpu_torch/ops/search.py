"""Search and sort ops — the counterpart of ``paddle_tpu/ops/search.py``.
``nonzero``, ``unique`` and ``unique_consecutive`` have outputs whose size
depends on the values: they read it back to the host."""
from __future__ import annotations

import torch

from ..framework import dtype as _dt
from ..tensor import Tensor
from . import _promote, apply_op

__all__ = [
    "argmax", "argmin", "argsort", "sort", "topk", "where", "nonzero",
    "searchsorted", "bucketize", "index_of_max", "unique",
    "unique_consecutive",
]


def _arg(tfn, name, x, axis, keepdim, dtype):
    d = _dt.convert_dtype(dtype)

    def f(v):
        if axis is None:
            return tfn(v.reshape(-1)).to(d)
        return tfn(v, axis, keepdim).to(d)

    return apply_op(f, name, x)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, "argmax", x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, "argmin", x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return apply_op(lambda v: torch.argsort(v, dim=axis, descending=descending,
                                            stable=True), "argsort", x)


def sort(x, axis=-1, descending=False, stable=False, name=None):
    return apply_op(lambda v: torch.sort(v, dim=axis, descending=descending,
                                         stable=True)[0], "sort", x)


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    kk = int(k.item()) if isinstance(k, Tensor) else int(k)

    def f(v):
        ax = v.dim() - 1 if axis is None else axis
        vals, idx = torch.topk(v, kk, ax, largest=largest, sorted=True)
        return vals, idx

    return apply_op(f, "topk", x)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)

    def f(c, a, b):
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            a, b = _promote(a, b)
        return torch.where(c.bool(), a, b)

    return apply_op(f, "where", condition, x, y)


def nonzero(x, as_tuple=False):
    """Reads the count back to the host (a data-dependent shape)."""
    def f(v):
        nz = torch.nonzero(v)
        if as_tuple:
            return tuple(nz[:, j:j + 1] for j in range(nz.shape[1]))
        return nz

    return apply_op(f, "nonzero", x)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    d = torch.int32 if out_int32 else torch.int64

    def f(s, v):
        s, v = _promote(s, v)
        if s.dim() > 1:
            v = v.contiguous()
        return torch.searchsorted(s.contiguous(), v, right=right).to(d)

    return apply_op(f, "searchsorted", sorted_sequence, values)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def index_of_max(x, axis=None):
    return argmax(x, axis)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """Sorted unique values (and first indices, inverse, counts, in
    ``dtype``); reads the count back to the host."""
    d = _dt.convert_dtype(dtype)

    def f(v):
        flat = v.reshape(-1) if axis is None else v
        vals, inv, counts = torch.unique(flat, sorted=True,
                                         return_inverse=True,
                                         return_counts=True, dim=axis)
        out = [vals]
        if return_index:
            n = inv.shape[0]
            pos = torch.arange(n, device=v.device)
            first = torch.full((vals.shape[0 if axis is None else axis],), n,
                               dtype=torch.long, device=v.device)
            out.append(first.scatter_reduce(0, inv, pos, "amin").to(d))
        if return_inverse:
            out.append(inv.to(d))
        if return_counts:
            out.append(counts.to(d))
        return out[0] if len(out) == 1 else tuple(out)

    return apply_op(f, "unique", x)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    d = _dt.convert_dtype(dtype)

    def f(v):
        vals, inv, counts = torch.unique_consecutive(
            v, return_inverse=True, return_counts=True, dim=axis)
        out = [vals]
        if return_inverse:
            out.append(inv.reshape(-1).to(d) if axis is None else inv.to(d))
        if return_counts:
            out.append(counts.to(d))
        return out[0] if len(out) == 1 else tuple(out)

    return apply_op(f, "unique_consecutive", x)
