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


def flatten(tree):
    """(leaves, structure): the leaves of nested tuples, lists and dicts in
    order (a dict's by sorted key), and a hashable description of the
    nesting that ``unflatten`` rebuilds it from. None is structure, not a
    leaf."""
    leaves = []

    def walk(x):
        if isinstance(x, (tuple, list)):
            return (type(x).__name__, tuple(walk(v) for v in x))
        if isinstance(x, dict):
            keys = tuple(sorted(x, key=str))     # as JAX orders them
            return ("dict", keys, tuple(walk(x[k]) for k in keys))
        if x is None:
            return ("None",)
        leaves.append(x)
        return ("leaf",)

    return leaves, walk(tree)


def unflatten(structure, leaves):
    """The tree ``flatten`` described, with ``leaves`` in its leaves'
    places (tuples and lists as tuples and lists, dicts with their keys)."""
    it = iter(leaves)

    def build(s):
        kind = s[0]
        if kind == "leaf":
            return next(it)
        if kind == "None":
            return None
        if kind == "dict":
            return {k: build(v) for k, v in zip(s[1], s[2])}
        seq = [build(v) for v in s[1]]
        return tuple(seq) if kind == "tuple" else seq

    return build(structure)


def _leaf_print(x):
    if isinstance(x, (torch.Tensor, np.ndarray, np.generic)):
        return tuple(x.shape), dtype_name(x.dtype)
    return None, type(x).__name__


def aval_fingerprint(args, kwargs=None):
    """(structure, ((shape, dtype), ...)) over the flattened (args,
    kwargs); a Python number fingerprints as (None, its type name)."""
    leaves, structure = flatten((tuple(args), dict(kwargs or {})))
    return structure, tuple(_leaf_print(x) for x in leaves)
