"""Reductions — the counterpart of ``paddle_tpu/ops/reduction.py``.

Integer inputs follow the JAX package: ``sum`` / ``prod`` of integers or
bool give int64, ``mean`` / ``std`` / ``var`` / ``logsumexp`` / ``median``
make them inexact first (``_inexact``).
"""
from __future__ import annotations

import torch

from ..framework import dtype as _dt
from ..tensor import Tensor
from . import _inexact, apply_op

__all__ = [
    "sum", "mean", "max", "min", "prod", "amax", "amin", "all", "any", "std",
    "var", "median", "nanmedian", "nansum", "nanmean", "quantile",
    "nanquantile", "logsumexp", "mode", "kthvalue",
]


def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        vals = axis.tolist()
        return tuple(vals) if isinstance(vals, list) else int(vals)
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(v, ax):
    """A torch ``dim`` argument for axis ``ax`` (None: every dim)."""
    return tuple(range(v.dim())) if ax is None else ax


def _int_sum_dtype(v, d):
    if d is None and not (v.is_floating_point() or v.is_complex()):
        return torch.int64
    return d


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    ax, d = _norm_axis(axis), _dt.convert_dtype(dtype)
    return apply_op(lambda v: torch.sum(v, _dims(v, ax), keepdim,
                                        dtype=_int_sum_dtype(v, d)), "sum", x)


def mean(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op(lambda v: torch.mean(_inexact(v), _dims(v, ax), keepdim),
                    "mean", x)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    ax, d = _norm_axis(axis), _dt.convert_dtype(dtype)

    def f(v):
        d2 = _int_sum_dtype(v, d)
        if ax is None:
            out = torch.prod(v.reshape(-1), dtype=d2)
            return out.reshape([1] * v.dim()) if keepdim else out
        out = v.to(d2) if d2 is not None else v
        for a in sorted(((ax,) if isinstance(ax, int) else ax),
                        key=lambda a: -(a % v.dim())):
            out = torch.prod(out, a % v.dim(), keepdim)
        return out

    return apply_op(f, "prod", x)


def _extreme(tfn, name, x, axis, keepdim):
    ax = _norm_axis(axis)
    return apply_op(lambda v: tfn(v, _dims(v, ax), keepdim), name, x)


def max(x, axis=None, keepdim=False, name=None):
    return _extreme(torch.amax, "max", x, axis, keepdim)


def min(x, axis=None, keepdim=False, name=None):
    return _extreme(torch.amin, "min", x, axis, keepdim)


amax = max
amin = min


def all(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op(lambda v: torch.all(v.bool(), _dims(v, ax), keepdim)
                    if v.dim() else v.bool(), "all", x)


def any(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op(lambda v: torch.any(v.bool(), _dims(v, ax), keepdim)
                    if v.dim() else v.bool(), "any", x)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op(lambda v: torch.std(_inexact(v), _dims(v, ax),
                                        correction=int(unbiased),
                                        keepdim=keepdim), "std", x)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op(lambda v: torch.var(_inexact(v), _dims(v, ax),
                                        correction=int(unbiased),
                                        keepdim=keepdim), "var", x)


def _flat(v, ax):
    return (v.reshape(-1), 0) if ax is None else (v, ax)


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    """mode "avg": the mean of the two middle values (numpy's median);
    mode "min": the lower one and its index."""
    ax = _norm_axis(axis)

    def f(v):
        u, a = _flat(_inexact(v), ax)
        if mode == "avg":
            out = torch.quantile(u, 0.5, dim=a, keepdim=keepdim)
            if ax is None and keepdim:
                out = out.reshape([1] * v.dim())
            return out
        vals, idx = torch.sort(u, dim=a, stable=True)
        k = (u.shape[a] - 1) // 2
        vals, idx = vals.narrow(a, k, 1), idx.narrow(a, k, 1)
        if not keepdim:
            vals, idx = vals.squeeze(a), idx.squeeze(a)
        return vals, idx

    return apply_op(f, "median", x)


def nanmedian(x, axis=None, keepdim=False, mode="avg", name=None):
    ax = _norm_axis(axis)

    def f(v):
        u, a = _flat(_inexact(v), ax)
        return torch.nanquantile(u, 0.5, dim=a, keepdim=keepdim)

    return apply_op(f, "nanmedian", x)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    ax, d = _norm_axis(axis), _dt.convert_dtype(dtype)
    return apply_op(lambda v: torch.nansum(v, _dims(v, ax), keepdim,
                                           dtype=_int_sum_dtype(v, d)),
                    "nansum", x)


def nanmean(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op(lambda v: torch.nanmean(_inexact(v), _dims(v, ax),
                                            keepdim), "nanmean", x)


def _quantile(tfn, name, x, q, axis, keepdim, interpolation):
    ax = _norm_axis(axis)

    def f(v):
        u = v if v.dtype == torch.float64 else v.to(torch.float32)
        qq = (q._value.to(u) if isinstance(q, Tensor)
              else torch.as_tensor(q, dtype=u.dtype, device=u.device))
        if isinstance(ax, tuple):       # several axes: move them last
            rest = [d for d in range(u.dim()) if d not in
                    [a % u.dim() for a in ax]]
            u2 = u.permute(rest + [a % u.dim() for a in ax]).reshape(
                [u.shape[d] for d in rest] + [-1])
            out = tfn(u2, qq, dim=-1, interpolation=interpolation)
            if keepdim:
                for a in sorted(a % u.dim() for a in ax):
                    out = out.unsqueeze(a + (out.dim() - len(rest)))
            return out
        u2, a = _flat(u, ax)
        out = tfn(u2, qq, dim=a, keepdim=keepdim, interpolation=interpolation)
        if ax is None and keepdim:
            out = out.reshape(list(out.shape[:-1] if qq.dim() else [])
                              + [1] * v.dim())
        return out

    return apply_op(f, name, x)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return _quantile(torch.quantile, "quantile", x, q, axis, keepdim,
                     interpolation)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    return _quantile(torch.nanquantile, "nanquantile", x, q, axis, keepdim,
                     interpolation)


def logsumexp(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op(lambda v: torch.logsumexp(_inexact(v), _dims(v, ax),
                                              keepdim), "logsumexp", x)


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` and an index of it; ties go
    to the largest value, as in the JAX package."""
    def f(v):
        a = axis % v.dim()
        vals, idx = torch.sort(v, dim=a, stable=True)
        moved = vals.movedim(a, -1)
        midx = idx.movedim(a, -1)
        n = moved.shape[-1]
        same = torch.cat([torch.zeros_like(moved[..., :1], dtype=torch.bool),
                          moved[..., 1:] == moved[..., :-1]], -1)
        run_id = torch.cumsum((~same).long(), -1)
        counts = torch.nn.functional.one_hot(run_id, n + 1).sum(-2)
        run_len = torch.gather(counts, -1, run_id)
        best = (n - 1) - torch.argmax(torch.flip(run_len, [-1]), -1)
        mv = torch.gather(moved, -1, best[..., None])[..., 0]
        mi = torch.gather(midx, -1, best[..., None])[..., 0]
        if keepdim:
            mv, mi = mv.unsqueeze(a), mi.unsqueeze(a)
        return mv, mi

    return apply_op(f, "mode", x)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def f(v):
        vals, idx = torch.sort(v, dim=axis, stable=True)
        sel = vals.narrow(axis, k - 1, 1)
        seli = idx.narrow(axis, k - 1, 1)
        if not keepdim:
            sel, seli = sel.squeeze(axis), seli.squeeze(axis)
        return sel, seli

    return apply_op(f, "kthvalue", x)
