"""Helpers for test bodies that run on both packages: the JAX package
(``paddle_tpu``) and the PyTorch port (``paddle_tpu_torch``), on the CPU.

A body is a function of the package module; it asserts what it asserts on
either package and returns a dict of convention-free results (numpy
arrays, dtype names, Python numbers). ``run`` runs a body on one package;
on the port it also holds the results to the JAX package's, which are
computed once per body and process (``jax_results``).
"""
import functools

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.framework.dtype import dtype_to_str

PKGS = {"jax": paddle_tpu, "torch": paddle_tpu_torch}


@pytest.fixture
def on_cpu():
    """The port's tensors go to the CPU within the test; the place that
    was current comes back after it."""
    prev = port_device._current["place"]
    paddle_tpu_torch.set_device("cpu")
    yield
    port_device._current["place"] = prev


def dname(t) -> str:
    """A tensor's dtype as paddle names it, on either package."""
    if isinstance(t, paddle_tpu_torch.Tensor):
        return dtype_to_str(t.dtype)
    return np.dtype(t.dtype).name


def npy(t) -> np.ndarray:
    """A tensor's values as a numpy array, on either package."""
    if isinstance(t, paddle_tpu_torch.Tensor):
        return t.numpy()
    return np.asarray(t._value)


@functools.lru_cache(maxsize=None)
def jax_results(body):
    return body(paddle_tpu) or {}


def run(body, pkg, rtol=1e-5, atol=1e-6):
    """``body`` on package ``pkg`` ("jax" or "torch"); the port's results
    must equal the JAX package's (values at rtol/atol, everything else
    exactly)."""
    if pkg == "jax":
        return jax_results(body)
    got = body(paddle_tpu_torch) or {}
    want = jax_results(body)
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, np.ndarray) and w.dtype.kind in "fc":
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, (k, g, w)
    return got
