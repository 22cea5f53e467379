"""Pooling — the counterpart of ``paddle_tpu/nn/functional/pooling.py``
(JAX's are ``lax.reduce_window``; the port's are torch's pools).

Where paddle and torch differ, paddle's meaning is kept: max pooling pads
with -inf; average pooling's ``exclusive`` (the default) divides by the
count of real elements in each window, torch's ``count_include_pad``
negated; ``ceil_mode`` extends the high pad until the last partial window
is included (JAX :61-71), and padding may differ at the two ends or be
"SAME" / "VALID". Symmetric pads within half a window go to torch's own
padding; any other is applied explicitly first. Channels-last inputs go
in and out as permuted views, as the convolutions do.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ...ops import apply_like

__all__ = [
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d", "max_pool2d",
    "max_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d",
]


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _pairs(padding, n, in_sizes, k, s):
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * n
        pairs = []
        for i in range(n):
            total = max((math.ceil(in_sizes[i] / s[i]) - 1) * s[i] + k[i]
                        - in_sizes[i], 0)
            pairs.append((total // 2, total - total // 2))
        return pairs
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    return [tuple(p) for p in padding]


_MAX = {1: tF.max_pool1d, 2: tF.max_pool2d, 3: tF.max_pool3d}
_AVG = {1: tF.avg_pool1d, 2: tF.avg_pool2d, 3: tF.avg_pool3d}


def _chan_last(data_format):
    return data_format.endswith("C") and len(data_format) > 2


def _pool(x, kernel, stride, padding, n, data_format, op, ceil_mode=False,
          exclusive=True):
    k = _tuple(kernel, n)
    s = _tuple(stride if stride is not None else kernel, n)
    chan_last = _chan_last(data_format)

    def f(v):
        if chan_last:
            v = v.movedim(-1, 1)
        pairs = _pairs(padding, n, v.shape[2:], k, s)
        if ceil_mode and not isinstance(padding, str):
            widened = []
            for i, (lo, hi) in enumerate(pairs):
                rem = (v.shape[2 + i] + lo + hi - k[i]) % s[i]
                widened.append((lo, hi + ((s[i] - rem) % s[i] if rem
                                          else 0)))
            pairs = widened
        native = all(lo == hi and 2 * lo <= kk
                     for (lo, hi), kk in zip(pairs, k))
        pad = [lo for lo, _ in pairs] if native else 0
        flat = [w for lo_hi in reversed(pairs) for w in lo_hi]
        if op == "max":
            if not native:
                low = (-math.inf if v.is_floating_point()
                       else torch.iinfo(v.dtype).min)
                v = tF.pad(v, flat, value=low)
            out = _MAX[n](v, k, s, pad)
        elif native:     # XLA's SAME pads count as zeros (JAX :80-82)
            out = _AVG[n](v, k, s, pad, count_include_pad=not exclusive
                          or isinstance(padding, str))
        else:
            summed = _AVG[n](tF.pad(v, flat), k, s, 0) * math.prod(k)
            if isinstance(padding, str) or not exclusive:
                out = summed / math.prod(k)
            else:
                ones = torch.ones((1, 1) + tuple(v.shape[2:]),
                                  dtype=v.dtype, device=v.device)
                counts = _AVG[n](tF.pad(ones, flat), k, s, 0) * math.prod(k)
                out = summed / counts
        return out.movedim(1, -1) if chan_last else out

    return apply_like(f, f"{op}_pool{n}d", x)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool(x, kernel_size, stride, padding, 1, "NCW", "avg",
                 ceil_mode, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, data_format, "avg",
                 ceil_mode, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, data_format, "avg",
                 ceil_mode, exclusive)


def _max_pool_with_mask(x, kernel_size, stride, padding, n):
    """(values, int32 argmax indices into each sample's and channel's
    flattened unpadded plane), the convention ``max_unpool`` reads."""
    k = _tuple(kernel_size, n)
    s = _tuple(stride if stride is not None else kernel_size, n)
    p = _tuple(padding, n)

    def f(v):
        out, idx = _MAX[n](v, k, s, p, return_indices=True)
        return out, idx.to(torch.int32)

    return apply_like(f, "max_pool_with_mask", x)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    if return_mask:
        return _max_pool_with_mask(x, kernel_size, stride, padding, 1)
    return _pool(x, kernel_size, stride, padding, 1, "NCW", "max", ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        return _max_pool_with_mask(x, kernel_size, stride, padding, 2)
    return _pool(x, kernel_size, stride, padding, 2, data_format, "max",
                 ceil_mode)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if return_mask:
        return _max_pool_with_mask(x, kernel_size, stride, padding, 3)
    return _pool(x, kernel_size, stride, padding, 3, data_format, "max",
                 ceil_mode)


_ADAPTIVE = {("avg", 1): tF.adaptive_avg_pool1d,
             ("avg", 2): tF.adaptive_avg_pool2d,
             ("avg", 3): tF.adaptive_avg_pool3d,
             ("max", 1): tF.adaptive_max_pool1d,
             ("max", 2): tF.adaptive_max_pool2d,
             ("max", 3): tF.adaptive_max_pool3d}


def _adaptive(x, output_size, n, op, data_format):
    """Each output cell pools the input span [floor(i in / out), ceil((i +
    1) in / out)) of each axis (JAX :178-200, torch's adaptive pools);
    None keeps an axis."""
    sizes = (list(output_size) if isinstance(output_size, (list, tuple))
             else [output_size] * n)
    chan_last = _chan_last(data_format)

    def f(v):
        if chan_last:
            v = v.movedim(-1, 1)
        out = _ADAPTIVE[op, n](v, sizes if n > 1 else sizes[0])
        return out.movedim(1, -1) if chan_last else out

    return apply_like(f, f"adaptive_{op}_pool{n}d", x)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "avg", "NCW")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, "avg", data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, "max", "NCW")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, "max", "NCHW")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 3, "max", "NCDHW")
