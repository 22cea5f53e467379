"""Export-parity fill-ins: the rest of the ``paddle.*`` op surface — the
counterpart of ``paddle_tpu/ops/parity.py``.

Three groups, as there:

1. small ops (stacking and splitting variants, scatter-into-view ops,
   special functions, dlpack, constants);
2. in-place variants: ``patch_methods`` makes them (``ops.INPLACE``),
   running the op out of place and giving the result to the tensor;
3. environment shims (print options, ``LazyGuard``, the signal handler)
   that are thin state.

``pdist`` / ``cdist`` are computed here with torch's kernels of the same
definitions; ``create_parameter`` needs the nn surface and raises until it
is ported (ROADMAP A6).
"""
from __future__ import annotations

import math as _math

import numpy as np
import torch

from ..tensor import Tensor, to_tensor
from . import _inexact, _promote, _promote_all, apply_op

__all__ = [
    # stacking / splitting
    "add_n", "block_diag", "column_stack", "row_stack", "hstack", "vstack",
    "dstack", "hsplit", "vsplit", "dsplit", "tensor_split", "cartesian_prod",
    "combinations", "unflatten", "as_strided", "matrix_transpose", "reverse",
    # scatter-into-view family
    "diagonal_scatter", "select_scatter", "slice_scatter", "index_fill",
    "index_fill_",
    # special functions / math
    "gammaln", "gammainc", "gammaincc", "multigammaln", "polygamma", "i0e",
    "i1", "i1e", "sinc", "polar", "frexp", "signbit", "isin", "isneginf",
    "isposinf", "histogram_bin_edges", "renorm", "reduce_as",
    "negative", "positive", "less", "floor_mod", "pdist", "cdist",
    # dlpack + misc env
    "from_dlpack", "to_dlpack", "set_printoptions", "disable_signal_handler",
    "check_shape", "LazyGuard", "create_parameter", "rank", "shape",
    "get_cuda_rng_state", "set_cuda_rng_state",
    # constants / dtypes
    "pi", "e", "inf", "nan", "newaxis", "float8_e4m3fn", "float8_e5m2",
]


# ------------------------------------------------------------ stacks/splits
def add_n(inputs, name=None):
    items = inputs if isinstance(inputs, (list, tuple)) else [inputs]

    def f(*vals):
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out

    return apply_op(f, "add_n", *items)


def block_diag(inputs, name=None):
    return apply_op(lambda *vs: torch.block_diag(*_promote_all(vs)),
                    "block_diag", *inputs)


def column_stack(x, name=None):
    return apply_op(lambda *vs: torch.column_stack(_promote_all(vs)),
                    "column_stack", *x)


def row_stack(x, name=None):
    return apply_op(lambda *vs: torch.vstack(_promote_all(vs)), "row_stack",
                    *x)


def hstack(x, name=None):
    return apply_op(lambda *vs: torch.hstack(_promote_all(vs)), "hstack", *x)


def vstack(x, name=None):
    return apply_op(lambda *vs: torch.vstack(_promote_all(vs)), "vstack", *x)


def dstack(x, name=None):
    return apply_op(lambda *vs: torch.dstack(_promote_all(vs)), "dstack", *x)


def _split_like(fn_name, tfn):
    def f(x, num_or_indices, name=None):
        n = (list(num_or_indices) if isinstance(num_or_indices, (list, tuple))
             else num_or_indices)
        return apply_op(lambda v: list(tfn(v, n)), fn_name, x)

    f.__name__ = f.__qualname__ = fn_name
    return f


hsplit = _split_like("hsplit", torch.hsplit)
vsplit = _split_like("vsplit", torch.vsplit)
dsplit = _split_like("dsplit", torch.dsplit)


def tensor_split(x, num_or_indices, axis=0, name=None):
    n = (list(num_or_indices) if isinstance(num_or_indices, (list, tuple))
         else num_or_indices)
    return apply_op(lambda v: list(torch.tensor_split(v, n, axis)),
                    "tensor_split", x)


def cartesian_prod(x, name=None):
    return apply_op(lambda *vs: torch.cartesian_prod(*_promote_all(vs)),
                    "cartesian_prod", *x)


def combinations(x, r=2, with_replacement=False, name=None):
    return apply_op(lambda v: torch.combinations(v, r, with_replacement),
                    "combinations", x)


def unflatten(x, axis, shape, name=None):
    return apply_op(lambda v: torch.unflatten(v, axis, tuple(shape)),
                    "unflatten", x)


def as_strided(x, shape, stride, offset=0, name=None):
    """Elements of x's flat order at ``offset + sum_i k_i stride_i``: a
    gather, as in JAX (the result does not alias x)."""
    def f(v):
        flat = v.reshape(-1)
        grids = torch.meshgrid(*[torch.arange(s, device=v.device)
                                 for s in shape], indexing="ij")
        lin = sum(g * st for g, st in zip(grids, stride))
        return flat[offset + lin]

    return apply_op(f, "as_strided", x)


def matrix_transpose(x, name=None):
    return apply_op(lambda v: v.mT, "matrix_transpose", x)


def reverse(x, axis, name=None):
    ax = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    return apply_op(lambda v: torch.flip(v, ax), "reverse", x)


# --------------------------------------------------------- scatter-into-view
def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    return apply_op(lambda v, s: torch.diagonal_scatter(
        v, s.to(v.dtype), offset, axis1, axis2), "diagonal_scatter", x, y)


def select_scatter(x, values, axis, index, name=None):
    return apply_op(lambda v, s: torch.select_scatter(v, s.to(v.dtype), axis,
                                                      index),
                    "select_scatter", x, values)


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    def f(v, src):
        idx = [slice(None)] * v.dim()
        for ax, st, en, sd in zip(axes, starts, ends, strides):
            idx[ax] = slice(st, en, sd)
        out = v.clone()
        out[tuple(idx)] = src.to(v.dtype)
        return out

    return apply_op(f, "slice_scatter", x, value)


def index_fill(x, index, axis, fill_value, name=None):
    return apply_op(lambda v, i: v.index_fill(axis, i.reshape(-1).long(),
                                              fill_value),
                    "index_fill", x, index)


def index_fill_(x, index, axis, fill_value, name=None):
    return x._assign(index_fill(x, index, axis, fill_value)._value)


# ------------------------------------------------------------------ special
def gammaln(x, name=None):
    return apply_op(lambda v: torch.special.gammaln(_inexact(v)), "gammaln",
                    x)


def gammainc(x, y, name=None):
    return apply_op(lambda a, b: torch.special.gammainc(*_promote(a, b)),
                    "gammainc", x, y)


def gammaincc(x, y, name=None):
    return apply_op(lambda a, b: torch.special.gammaincc(*_promote(a, b)),
                    "gammaincc", x, y)


def multigammaln(x, p, name=None):
    return apply_op(lambda v: torch.special.multigammaln(_inexact(v), p),
                    "multigammaln", x)


def polygamma(x, n, name=None):
    return apply_op(lambda v: torch.special.polygamma(n, _inexact(v)),
                    "polygamma", x)


def i0e(x, name=None):
    return apply_op(lambda v: torch.special.i0e(_inexact(v)), "i0e", x)


def i1(x, name=None):
    return apply_op(lambda v: torch.special.i1(_inexact(v)), "i1", x)


def i1e(x, name=None):
    return apply_op(lambda v: torch.special.i1e(_inexact(v)), "i1e", x)


def sinc(x, name=None):
    return apply_op(lambda v: torch.sinc(_inexact(v)), "sinc", x)


def polar(abs, angle, name=None):
    """complex64, as JAX's."""
    return apply_op(lambda r, t: torch.polar(r.float(), t.float()), "polar",
                    abs, angle)


def frexp(x, name=None):
    def f(v):
        m, e = torch.frexp(v)
        return m, e.to(torch.int32)

    return apply_op(f, "frexp", x)


def signbit(x, name=None):
    return apply_op(torch.signbit, "signbit", x)


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return apply_op(lambda v, t: torch.isin(v, t, assume_unique=assume_unique,
                                            invert=invert), "isin", x, test_x)


def isneginf(x, name=None):
    return apply_op(torch.isneginf, "isneginf", x)


def isposinf(x, name=None):
    return apply_op(torch.isposinf, "isposinf", x)


def histogram_bin_edges(input, bins=100, min=0, max=0, name=None):
    """float32 edges; min = max = 0 takes the data's range on the
    device."""
    def f(v):
        u = _inexact(v)
        if min == 0 and max == 0:
            lo, hi = u.min(), u.max()
        else:
            lo = torch.tensor(float(min), dtype=u.dtype, device=u.device)
            hi = torch.tensor(float(max), dtype=u.dtype, device=u.device)
        steps = torch.arange(bins + 1, device=u.device, dtype=u.dtype) / bins
        return (lo + (hi - lo) * steps).to(torch.float32)

    return apply_op(f, "histogram_bin_edges", input)


def renorm(x, p, axis, max_norm, name=None):
    """Each slice along ``axis`` whose p-norm exceeds ``max_norm`` scaled
    to it (with JAX's 1e-7 guard)."""
    def f(v):
        moved = v.movedim(axis, 0)
        flat = moved.reshape(moved.shape[0], -1)
        norms = (flat.abs() ** p).sum(1) ** (1.0 / p)
        scale = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                            torch.ones_like(norms))
        return (flat * scale[:, None]).reshape(moved.shape).movedim(0, axis)

    return apply_op(f, "renorm", x)


def reduce_as(x, target, name=None):
    """``x`` summed down to ``target``'s shape."""
    tgt = tuple(target.shape)

    def f(v):
        out = v
        while out.dim() > len(tgt):
            out = out.sum(0)
        for i, (a, b) in enumerate(zip(out.shape, tgt)):
            if a != b:
                out = out.sum(i, keepdim=True)
        return out

    return apply_op(f, "reduce_as", x)


def less(x, y, name=None):
    """Alias of ``less_than`` (the reference exports both)."""
    from .logic import less_than

    return less_than(x, y)


def floor_mod(x, y, name=None):
    """Alias of ``mod`` (the reference exports both)."""
    from .math import mod

    return mod(x, y)


def negative(x, name=None):
    return apply_op(torch.neg, "negative", x)


def positive(x, name=None):
    return apply_op(torch.positive, "positive", x)


def pdist(x, p=2.0, name=None):
    """Pairwise p-distances between the rows of x [N, M], the upper
    triangle in row order."""
    return apply_op(lambda v: torch.pdist(v, p), "pdist", x)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    return apply_op(lambda a, b: torch.cdist(a, b, p,
                                             compute_mode=compute_mode),
                    "cdist", x, y)


# ----------------------------------------------------------------- env shims
def from_dlpack(dlpack):
    return Tensor(torch.utils.dlpack.from_dlpack(dlpack))


def to_dlpack(x):
    return torch.utils.dlpack.to_dlpack(x._value if isinstance(x, Tensor)
                                        else x)


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """numpy's print options (Tensor reprs print through numpy)."""
    kw = {}
    if precision is not None:
        kw["precision"] = precision
    if threshold is not None:
        kw["threshold"] = threshold
    if edgeitems is not None:
        kw["edgeitems"] = edgeitems
    if linewidth is not None:
        kw["linewidth"] = linewidth
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


def disable_signal_handler():
    """The only handler installed here is faulthandler's SIGUSR1 dump:
    unregister it."""
    import faulthandler
    import signal as _signal

    try:
        faulthandler.unregister(_signal.SIGUSR1)
    except (AttributeError, ValueError, RuntimeError):
        pass


def check_shape(x):
    return list(x.shape)


class LazyGuard:
    """Parameters are created eagerly; kept as a no-op context for API
    compatibility."""

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A new ``nn.Parameter`` on the current place, made as
    ``Layer.create_parameter`` makes one (JAX :440-447)."""
    from ..nn.layer import make_parameter

    return make_parameter(list(shape), attr, dtype, is_bias,
                          default_initializer)


def rank(input):
    return to_tensor(np.asarray(input.ndim, np.int32),
                     place=input._value.device)


def shape(input):
    return to_tensor(np.asarray(input.shape, np.int64),
                     place=input._value.device)


def get_cuda_rng_state():
    from ..framework.random import get_rng_state

    return get_rng_state("cuda")


def set_cuda_rng_state(state):
    from ..framework.random import set_rng_state

    return set_rng_state(state, "cuda")


# ------------------------------------------------------------------ constants
pi = _math.pi
e = _math.e
inf = float("inf")
nan = float("nan")
newaxis = None
float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2
