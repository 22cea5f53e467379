"""Shape and layout ops — the counterpart of
``paddle_tpu/ops/manipulation.py``. Gathers and scatters are computed out
of place (``index_put``, ``scatter``), as the JAX package's ``.at[]``
updates are, so they are differentiable and leave their inputs alone.
``masked_select`` and ``masked_scatter`` need their output's size from the
mask's values: they read it back to the host, the one kind of op here that
does."""
from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as tF

from ..framework import dtype as _dt
from ..tensor import Tensor
from . import _promote, _promote_all, apply_op

__all__ = [
    "reshape", "reshape_", "flatten", "transpose", "moveaxis", "swapaxes",
    "squeeze", "squeeze_", "unsqueeze", "unsqueeze_", "concat", "stack",
    "split", "chunk", "unbind", "unstack", "tile", "expand", "expand_as",
    "broadcast_to", "broadcast_tensors", "flip", "rot90", "roll",
    "repeat_interleave", "cast", "slice", "strided_slice", "crop", "pad",
    "gather", "gather_nd", "scatter", "scatter_nd", "scatter_nd_add",
    "index_select", "index_sample", "index_add", "index_put",
    "masked_select", "masked_fill", "masked_scatter", "take_along_axis",
    "put_along_axis", "tensordot", "as_complex", "as_real", "view",
    "view_as", "tolist", "atleast_1d", "atleast_2d", "atleast_3d",
    "diagonal", "diag_embed", "flatten_", "shard_index", "unfold",
    "split_sections",
]

_slice = builtins.slice


def _ints(seq):
    if isinstance(seq, Tensor):
        return [int(v) for v in seq.tolist()]
    return [int(s.item()) if isinstance(s, Tensor) else int(s) for s in seq]


def _int(v):
    return int(v.item()) if isinstance(v, Tensor) else int(v)


def _graft(x, out):
    """``x`` takes ``out``'s value (and graph): the in-place shape ops."""
    return x._assign(out._value)


def reshape(x, shape, name=None):
    shape = _ints(shape)
    return apply_op(lambda v: torch.reshape(v, shape), "reshape", x)


def reshape_(x, shape, name=None):
    return _graft(x, reshape(x, shape))


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return cast(x, shape_or_dtype)


def view_as(x, other, name=None):
    return reshape(x, other.shape)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def f(v):
        if v.dim() == 0:
            return v.reshape(1)
        return torch.flatten(v, start_axis, stop_axis)

    return apply_op(f, "flatten", x)


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return _graft(x, flatten(x, start_axis, stop_axis))


def transpose(x, perm=None, name=None):
    def f(v):
        p = list(range(v.dim()))[::-1] if perm is None else _ints(perm)
        return v.permute(p)

    return apply_op(f, "transpose", x)


def moveaxis(x, source, destination, name=None):
    return apply_op(lambda v: torch.movedim(v, source, destination),
                    "moveaxis", x)


def swapaxes(x, axis0, axis1, name=None):
    return apply_op(lambda v: torch.swapaxes(v, axis0, axis1), "swapaxes", x)


def squeeze(x, axis=None, name=None):
    def f(v):
        if axis is None:
            return torch.squeeze(v)
        ax = [axis] if isinstance(axis, int) else _ints(axis)
        ax = tuple(a % v.dim() for a in ax if v.shape[a % v.dim()] == 1)
        return torch.squeeze(v, ax) if ax else v

    return apply_op(f, "squeeze", x)


def squeeze_(x, axis=None, name=None):
    return _graft(x, squeeze(x, axis))


def unsqueeze(x, axis, name=None):
    ax = [axis] if isinstance(axis, int) else _ints(
        axis if isinstance(axis, (list, tuple, Tensor)) else [axis])

    def f(v):
        out = v
        for a in sorted(a % (out.dim() + 1) for a in ax):
            out = out.unsqueeze(a)
        return out

    return apply_op(f, "unsqueeze", x)


def unsqueeze_(x, axis, name=None):
    return _graft(x, unsqueeze(x, axis))


def concat(x, axis=0, name=None):
    ax = _int(axis)
    return apply_op(lambda *vs: torch.cat(_promote_all(vs), ax), "concat", *x)


def stack(x, axis=0, name=None):
    return apply_op(lambda *vs: torch.stack(_promote_all(vs), axis),
                    "stack", *x)


def split(x, num_or_sections, axis=0, name=None):
    ax = _int(axis)

    def f(v):
        a = ax % v.dim()
        total = v.shape[a]
        if isinstance(num_or_sections, int):
            if total % num_or_sections:
                raise ValueError(f"split: {total} rows do not divide into "
                                 f"{num_or_sections} equal parts")
            return list(torch.split(v, total // num_or_sections, a))
        secs = _ints(num_or_sections)
        known = builtins.sum(s for s in secs if s >= 0)
        secs = [s if s >= 0 else total - known for s in secs]
        return list(torch.split(v, secs, a))

    return apply_op(f, "split", x)


split_sections = split


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    return apply_op(lambda v: list(torch.unbind(v, axis)), "unbind", x)


unstack = unbind


def tile(x, repeat_times, name=None):
    reps = _ints(repeat_times)
    return apply_op(lambda v: torch.tile(v, reps), "tile", x)


def expand(x, shape, name=None):
    shape = _ints(shape)

    def f(v):
        vshape = (1,) * (len(shape) - v.dim()) + tuple(v.shape)
        tgt = [vs if t == -1 else t for t, vs in zip(shape, vshape)]
        return v.reshape(vshape).expand(tgt)

    return apply_op(f, "expand", x)


def expand_as(x, y, name=None):
    return expand(x, y.shape)


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    out_shape = list(np.broadcast_shapes(*[tuple(t.shape) for t in inputs]))
    return [expand(t, out_shape) for t in inputs]


def flip(x, axis, name=None):
    ax = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    return apply_op(lambda v: torch.flip(v, ax), "flip", x)


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply_op(lambda v: torch.rot90(v, k, list(axes)), "rot90", x)


def roll(x, shifts, axis=None, name=None):
    return apply_op(lambda v: torch.roll(v, shifts, axis), "roll", x)


def repeat_interleave(x, repeats, axis=None, name=None):
    return apply_op(lambda v, r: torch.repeat_interleave(v, r, axis),
                    "repeat_interleave", x, repeats)


def cast(x, dtype):
    d = _dt.convert_dtype(dtype)
    return apply_op(lambda v: v.to(d), "cast", x)


def slice(input, axes, starts, ends):
    def f(v):
        idx = [_slice(None)] * v.dim()
        for ax, s, e in zip(axes, starts, ends):
            idx[ax] = _slice(_int(s), _int(e))
        return v[tuple(idx)]

    return apply_op(f, "slice", input)


def strided_slice(x, axes, starts, ends, strides, name=None):
    def f(v):
        idx = [_slice(None)] * v.dim()
        for ax, s, e, st in zip(axes, starts, ends, strides):
            st = _int(st)
            if st < 0:      # torch has no negative step: flip, then slice
                raise ValueError("strided_slice: negative strides are not "
                                 "supported")
            idx[ax] = _slice(_int(s), _int(e), st)
        return v[tuple(idx)]

    return apply_op(f, "strided_slice", x)


def crop(x, shape=None, offsets=None, name=None):
    shp = _ints(shape or x.shape)
    offs = _ints(offsets or [0] * len(shp))
    return apply_op(lambda v: v[tuple(_slice(o, o + s)
                                      for o, s in zip(offs, shp))],
                    "crop", x)


_PAD_MODES = {"constant": "constant", "reflect": "reflect",
              "replicate": "replicate", "circular": "circular"}


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``paddle.nn.functional.pad``: ``pad`` is [lo, hi] per dim in order,
    or, shorter, per spatial dim of ``data_format`` from the last one
    outward."""
    pad = _ints(pad)

    def f(v):
        nd = v.dim()
        if len(pad) == 2 * nd:
            widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
        else:
            widths = [(0, 0)] * nd
            n_spatial = len(pad) // 2
            spatial = (list(range(1, 1 + n_spatial))
                       if data_format.endswith("C")
                       else list(range(nd - n_spatial, nd)))
            for i, d in enumerate(reversed(spatial)):
                widths[d] = (pad[2 * i], pad[2 * i + 1])
        flat = [w for lo_hi in reversed(widths) for w in lo_hi]
        if mode == "constant":
            return tF.pad(v, flat, "constant", value)
        # torch pads the last 1-3 dims in these modes: drop the unpadded
        # leading dims' pairs
        while len(flat) > 2 and flat[-2:] == [0, 0]:
            flat = flat[:-2]
        return tF.pad(v, flat, _PAD_MODES[mode])

    return apply_op(f, "pad", x)


def gather(x, index, axis=0, name=None):
    ax = _int(axis)
    def f(v, i):
        out = torch.index_select(v, ax, i.reshape(-1).long())
        return out if i.dim() else out.squeeze(ax)

    return apply_op(f, "gather", x, index)


def _index_tuple(idx):
    """[..., k] integer indices as a tuple of k index tensors."""
    idx = idx.long()
    return tuple(idx[..., j] for j in range(idx.shape[-1]))


def gather_nd(x, index, name=None):
    return apply_op(lambda v, i: v[_index_tuple(i)], "gather_nd", x, index)


def scatter(x, index, updates, overwrite=True, name=None):
    def f(v, i, u):
        i = i.reshape(-1).long()
        u = u.to(v.dtype)
        if overwrite:
            return v.index_put((i,), u)
        return v.index_put((i,), torch.zeros_like(u)).index_put(
            (i,), u, accumulate=True)

    return apply_op(f, "scatter", x, index, updates)


def scatter_nd(index, updates, shape, name=None):
    def f(i, u):
        z = torch.zeros(_ints(shape), dtype=u.dtype, device=u.device)
        return z.index_put(_index_tuple(i), u, accumulate=True)

    return apply_op(f, "scatter_nd", index, updates)


def scatter_nd_add(x, index, updates, name=None):
    return apply_op(lambda v, i, u: v.index_put(_index_tuple(i), u.to(v.dtype),
                                                accumulate=True),
                    "scatter_nd_add", x, index, updates)


def index_select(x, index, axis=0, name=None):
    return apply_op(lambda v, i: torch.index_select(v, axis,
                                                    i.reshape(-1).long()),
                    "index_select", x, index)


def index_sample(x, index):
    return apply_op(lambda v, i: torch.gather(v, 1, i.long()),
                    "index_sample", x, index)


def index_add(x, index, axis, value, name=None):
    return apply_op(lambda v, i, u: torch.index_add(v, axis, i.long(),
                                                    u.to(v.dtype)),
                    "index_add", x, index, value)


def index_put(x, indices, value, accumulate=False, name=None):
    def f(v, u, *idx):
        idx = tuple(i if i.dtype == torch.bool else i.long() for i in idx)
        u = (u.to(v.dtype) if isinstance(u, torch.Tensor)
             else torch.full((), u, dtype=v.dtype, device=v.device))
        return v.index_put(idx, u, accumulate=accumulate)

    return apply_op(f, "index_put", x, value, *indices)


def masked_select(x, mask, name=None):
    """Reads the mask's count back to the host (a data-dependent shape)."""
    return apply_op(lambda v, m: torch.masked_select(v, m.bool()),
                    "masked_select", x, mask)


def masked_fill(x, mask, value, name=None):
    def f(v, m, val):
        if val is None:
            return v.masked_fill(m.bool(), value)
        return torch.where(m.bool(), val.to(v.dtype), v)

    return apply_op(f, "masked_fill", x, mask,
                    value if isinstance(value, Tensor) else None)


def masked_scatter(x, mask, value, name=None):
    """Reads the mask's count back to the host (a data-dependent shape)."""
    def f(v, m, src):
        m = m.bool().broadcast_to(v.shape)
        return v.masked_scatter(m, src.reshape(-1)[:int(m.sum())].to(v.dtype))

    return apply_op(f, "masked_scatter", x, mask, value)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    def f(v, i):
        i = i.long()
        if broadcast:
            ax = axis % v.dim()
            shape = list(np.broadcast_shapes(
                tuple(s for d, s in enumerate(v.shape) if d != ax),
                tuple(s for d, s in enumerate(i.shape) if d != ax)))
            shape.insert(ax, i.shape[axis])
            i = i.expand(shape)
            vshape = list(shape)
            vshape[ax] = v.shape[axis]
            v = v.expand(vshape)
        return torch.gather(v, axis, i)

    return apply_op(f, "take_along_axis", arr, indices)


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    def f(v, i, u):
        i = i.long()
        u = (u.to(v.dtype) if isinstance(u, torch.Tensor)
             else torch.full((), u, dtype=v.dtype, device=v.device))
        u = u.expand(i.shape)
        if reduce == "assign":
            return torch.scatter(v, axis, i, u)
        if reduce in ("add", "sum"):
            return torch.scatter_add(v, axis, i, u)
        if reduce in ("mul", "multiply"):
            return torch.scatter_reduce(v, axis, i, u, "prod")
        raise ValueError(f"unsupported reduce {reduce}")

    return apply_op(f, "put_along_axis", arr, indices, values)


def tensordot(x, y, axes=2, name=None):
    def norm_axes(a):
        if isinstance(a, Tensor):
            a = a.tolist()
        if isinstance(a, (list, tuple)):
            return [list(t) if isinstance(t, (list, tuple)) else t for t in a]
        return a

    return apply_op(lambda a, b: torch.tensordot(*_promote(a, b),
                                                 dims=norm_axes(axes)),
                    "tensordot", x, y)


def as_complex(x, name=None):
    return apply_op(torch.view_as_complex, "as_complex", x)


def as_real(x, name=None):
    return apply_op(torch.view_as_real, "as_real", x)


def tolist(x):
    return x.tolist()


def _atleast(tfn, name, inputs):
    outs = [apply_op(tfn, name, t) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*inputs, name=None):
    return _atleast(torch.atleast_1d, "atleast_1d", inputs)


def atleast_2d(*inputs, name=None):
    return _atleast(torch.atleast_2d, "atleast_2d", inputs)


def atleast_3d(*inputs, name=None):
    return _atleast(torch.atleast_3d, "atleast_3d", inputs)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op(lambda v: torch.diagonal(v, offset, axis1, axis2),
                    "diagonal", x)


def diag_embed(input, offset=0, dim1=-2, dim2=-1):
    return apply_op(lambda v: torch.diag_embed(v, offset, dim1, dim2),
                    "diag_embed", input)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    def f(v):
        size = (index_num + nshards - 1) // nshards
        lo = shard_id * size
        inside = (v >= lo) & (v < lo + size)
        return torch.where(inside, v - lo, torch.full_like(v, ignore_value))

    return apply_op(f, "shard_index", input)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col (``paddle.nn.functional.unfold``): [N, C, H, W] to
    [N, C*kh*kw, L]."""
    if isinstance(paddings, int):
        pads = (paddings, paddings)
        asym = None
    elif len(paddings) == 2:
        pads, asym = tuple(paddings), None
    else:
        pads, asym = (0, 0), list(paddings)     # top, left, bottom, right

    def f(v):
        if asym is not None:
            pt, pl, pb, pr = asym
            v = tF.pad(v, [pl, pr, pt, pb])
        return tF.unfold(v, kernel_sizes, dilations, pads, strides)

    return apply_op(f, "unfold", x)
