"""The golden-table harness of the op layer, shared by the CPU tests
(``tests/test_torch_op_golden.py``) and ``chip_smoke.py``'s core phase.

The tables themselves live in the JAX package's tests
(``tests/test_op_golden.py``, ``tests/test_op_golden2.py``): the CPU test
imports them by name; ``load_tables`` reads the same sources with their
imports of the JAX package left out and their ``P`` / ``paddle`` / ``F``
bound to the port, for a machine that runs the port without JAX. The
checks follow ``tests/op_test.py``: outputs against the numpy reference
(``compare``), and gradients against central differences of the reference
in float64 under one fixed projection to a scalar (``check_grad``).
"""
from __future__ import annotations

import os
import re

import numpy as np

from .tensor import Tensor

__all__ = ["load_tables", "leaves", "to_numpy", "compare", "scalar_proj",
           "check_grad", "rand", "randpos", "randint", "randb"]

TABLES = {"test_op_golden.py": ("UNARY", "BINARY", "LOGIC", "REDUCTION",
                                "CREATION", "SEARCH"),
          "test_op_golden2.py": ("MANIP", "LINALG", "ACTIVATIONS", "LOSSES",
                                 "NN_SHAPE")}

# op_test's draws, from a generator of its own seed
_rng = {"gen": np.random.default_rng(2024)}


def rand(shape, dtype="float64", lo=-2.0, hi=2.0):
    return _rng["gen"].uniform(lo, hi, shape).astype(dtype)


def randpos(shape, dtype="float64", lo=0.1, hi=3.0):
    return _rng["gen"].uniform(lo, hi, shape).astype(dtype)


def randint(shape, lo=0, hi=10, dtype="int64"):
    return _rng["gen"].integers(lo, hi, shape).astype(dtype)


def randb(shape):
    return _rng["gen"].integers(0, 2, shape).astype(bool)


def _draws(gen):
    """op_test's draw functions over the numpy generator ``gen``."""
    return {
        "rand": lambda shape, dtype="float64", lo=-2.0, hi=2.0:
            gen.uniform(lo, hi, shape).astype(dtype),
        "randpos": lambda shape, dtype="float64", lo=0.1, hi=3.0:
            gen.uniform(lo, hi, shape).astype(dtype),
        "randint": lambda shape, lo=0, hi=10, dtype="int64":
            gen.integers(lo, hi, shape).astype(dtype),
        "randb": lambda shape: gen.integers(0, 2, shape).astype(bool),
    }


def load_tables(tests_dir, port, F, gen=None):
    """{table name: [case, ...]} from the two table files in ``tests_dir``,
    run over the port: their ``import paddle_tpu...`` and ``from op_test``
    lines are left out and the module body up to ``SPECS`` runs with
    ``P`` / ``paddle`` bound to ``port`` and ``F`` to ``F``. The cases'
    inputs draw from ``gen`` (a numpy generator), else from this module's
    own generator (``rand`` ...)."""
    draws = (dict(rand=rand, randpos=randpos, randint=randint, randb=randb)
             if gen is None else _draws(gen))
    out = {}
    for fname, names in TABLES.items():
        with open(os.path.join(tests_dir, fname)) as f:
            src = f.read()
        src = src[:src.index("\nSPECS = ")]
        src = re.sub(r"^(import paddle_tpu.*|from op_test import .*)$", "",
                     src, flags=re.M)
        g = {"__name__": "golden_tables", "paddle": port, "F": F, **draws}
        exec(compile(src, os.path.join(tests_dir, fname), "exec"), g)
        for n in names:
            out[n] = [c for c in g[n] if c is not None]
    return out


def leaves(x):
    if isinstance(x, (tuple, list)):
        return [e for item in x for e in leaves(item)]
    return [x]


def to_numpy(x):
    if isinstance(x, Tensor):
        return x.numpy()
    if hasattr(x, "_value"):        # another package's tensor
        return np.asarray(x._value)
    return np.asarray(x)


def compare(got, want, rtol, atol, where):
    """Elementwise, at ``rtol`` / ``atol`` (integers and bools exactly);
    returns the largest |got - want| / (atol + rtol |want|) over the float
    outputs (at most 1 where they agree)."""
    got_l, want_l = leaves(got), leaves(want)
    assert len(got_l) == len(want_l), (
        f"{where}: arity {len(got_l)} != {len(want_l)}")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        g, w = to_numpy(g), to_numpy(w)
        assert g.shape == w.shape, f"{where}[{i}]: {g.shape} != {w.shape}"
        if g.dtype == bool or np.issubdtype(g.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f"{where}[{i}]")
            continue
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"{where}[{i}]")
        if g.size:
            lim = atol + rtol * np.abs(w.astype(np.float64))
            err = np.abs(g.astype(np.float64) - w)
            worst = max(worst, float(np.nanmax(
                np.where(np.isnan(err), 0.0, err) / lim)))
    return worst


def _proj_weights(shape, salt):
    return np.random.default_rng(7 + salt).uniform(0.5, 1.5, shape)


def scalar_proj(out, to_tensor):
    """op_test's deterministic projection of the float outputs to one
    scalar (``to_tensor`` makes the weights a Tensor beside them)."""
    total = None
    for li, leaf in enumerate(leaves(out)):
        if not leaf.dtype.is_floating_point:
            continue
        w = to_tensor(_proj_weights(tuple(leaf.shape), li).astype(
            str(leaf.dtype).replace("torch.", "")))
        term = (leaf * w).sum()
        total = term if total is None else total + term
    return total


def check_grad(name, fn, ref, inputs, kwargs, idx, rtol, atol, eps, samples,
               to_tensor, ref_inputs=None):
    """Torch autograd through ``fn`` (on Tensors made by ``to_tensor``)
    against central differences of the numpy ``ref`` at ``ref_inputs``
    (default ``inputs``) in float64, at up to ``samples`` coordinates of
    each input in ``idx``. Returns the worst |numeric - analytic| /
    max(|numeric|, |analytic|, 1)."""
    ref_inputs = inputs if ref_inputs is None else ref_inputs
    tensors = [to_tensor(np.copy(a), stop_gradient=i not in idx)
               for i, a in enumerate(inputs)]
    proj = scalar_proj(fn(*tensors, **kwargs), to_tensor)
    assert proj is not None, f"{name}:grad — no float output"
    proj.backward()
    worst = 0.0
    for i in idx:
        assert tensors[i].grad is not None, f"{name}:grad — input {i}"
        analytic = tensors[i].grad.numpy().astype(np.float64).reshape(-1)
        base = np.asarray(ref_inputs[i], np.float64)
        flat = base.reshape(-1)
        coords = (np.arange(flat.size) if flat.size <= samples else
                  np.random.default_rng(13).choice(flat.size, samples,
                                                   replace=False))

        def loss_at(x_flat):
            arrs = [np.copy(a) for a in ref_inputs]
            arrs[i] = x_flat.reshape(base.shape).astype(
                np.asarray(ref_inputs[i]).dtype)
            total = 0.0
            for li, leaf in enumerate(leaves(ref(*arrs))):
                leaf = np.asarray(leaf)
                if np.issubdtype(leaf.dtype, np.floating):
                    total += float((leaf * _proj_weights(leaf.shape, li)
                                    ).sum())
            return total

        for c in coords:
            xp, xm = flat.copy(), flat.copy()
            xp[c] += eps
            xm[c] -= eps
            numeric = (loss_at(xp) - loss_at(xm)) / (2 * eps)
            a = analytic[c]
            dev = abs(numeric - a) / max(abs(numeric), abs(a), 1.0)
            worst = max(worst, dev)
            assert dev < rtol + atol, (
                f"{name}:grad input{i} coord{c}: numeric {numeric:.8g} vs "
                f"analytic {a:.8g}")
    return worst
