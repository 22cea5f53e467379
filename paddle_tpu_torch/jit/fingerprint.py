"""Argument fingerprints — the counterpart of
``paddle_tpu/jit/fingerprint.py`` (``aval_fingerprint``).

A fingerprint is (structure, leaves): the nesting of tuples, lists and
dicts (with their keys) over the flattened (args, kwargs), and per leaf its
(shape, dtype). It is what would make a compiled step run again: a changed
shape, dtype, leaf type or structure changes it, a changed Python number
does not (JAX traces Python scalars as weakly typed arrays, and
``jit.TrainStep`` passes them to its step as 0-d tensors).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["aval_fingerprint", "flatten", "unflatten", "dtype_name"]


def dtype_name(dtype) -> str:
    """'float32', 'bfloat16', 'int64', ... for a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def _walk(x, leaves):
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, tuple(_walk(v, leaves) for v in x))
    if isinstance(x, dict):
        keys = tuple(sorted(x, key=str))     # as JAX orders them
        return ("dict", keys, tuple(_walk(x[k], leaves) for k in keys))
    if x is None:
        return ("None",)
    leaves.append(x)
    return ("leaf",)


def flatten(tree):
    """(leaves, structure): the leaves of nested tuples, lists and dicts in
    order (a dict's by sorted key), and a hashable description of the
    nesting that ``unflatten`` rebuilds it from. None is structure, not a
    leaf. (The walkers are module functions: a recursive closure is a
    reference cycle that would keep the leaves, and any autograd graph
    they hold, alive until the garbage collector runs.)"""
    leaves = []
    return leaves, _walk(tree, leaves)


def _build(s, it):
    kind = s[0]
    if kind == "leaf":
        return next(it)
    if kind == "None":
        return None
    if kind == "dict":
        return {k: _build(v, it) for k, v in zip(s[1], s[2])}
    seq = [_build(v, it) for v in s[1]]
    return tuple(seq) if kind == "tuple" else seq


def unflatten(structure, leaves):
    """The tree ``flatten`` described, with ``leaves`` in its leaves'
    places (tuples and lists as tuples and lists, dicts with their keys)."""
    return _build(structure, iter(leaves))


def _leaf_print(x):
    if isinstance(x, (torch.Tensor, np.ndarray, np.generic)):
        return tuple(x.shape), dtype_name(x.dtype)
    return None, type(x).__name__


def aval_fingerprint(args, kwargs=None):
    """(structure, ((shape, dtype), ...)) over the flattened (args,
    kwargs); a Python number fingerprints as (None, its type name)."""
    leaves, structure = flatten((tuple(args), dict(kwargs or {})))
    return structure, tuple(_leaf_print(x) for x in leaves)
