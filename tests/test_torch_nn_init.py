"""The port's initializers held by distribution pins (their draws cannot
equal ``jax.random``'s), on the CPU: 200 000 draws each, a sample mean
within 5 standard errors of the law's and a sample standard deviation
within 2% of it; bounds exact (uniform limits, truncation at a and b);
fans by paddle's layouts, equal to the JAX package's ``_fans``; the
constant and deterministic ones (Assign, Dirac, Bilinear, Orthogonal's
orthonormality) exactly, against the JAX package's where it has the same
value; and a draw from a given generator reproducible.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as port
from paddle_tpu.nn.initializer import _fans as jax_fans
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.initializer import _fans
from port_bodies import on_cpu  # noqa: F401

N = 200_000
SHAPE = [400, 500]     # a Linear weight: fan_in 400, fan_out 500


def _draw(init, shape=SHAPE, seed=0):
    g = torch.Generator().manual_seed(seed)
    return init(shape, "float32", "cpu", g).double().numpy()


def _moments(v, mean, std):
    n = v.size
    assert abs(v.mean() - mean) < 5 * std / math.sqrt(n), (v.mean(), mean)
    assert abs(v.std() / std - 1) < 0.02, (v.std(), std)


@pytest.mark.parametrize("shape", [[], [7], [4, 9], [8, 3, 5, 5],
                                   [6, 2, 3, 3, 3]])
def test_fans_follow_paddle_layouts(shape):
    assert _fans(shape) == jax_fans(shape)


def test_normal_and_truncated_normal():
    _moments(_draw(I.Normal(0.5, 2.0)), 0.5, 2.0)
    v = _draw(I.TruncatedNormal(1.0, 3.0, -2.0, 2.0))
    assert v.min() >= 1.0 - 6.0 and v.max() <= 1.0 + 6.0
    # N(0,1) truncated to [-2, 2]: std 0.8796
    _moments(v, 1.0, 3.0 * 0.87963)


def test_uniform_and_xavier_and_kaiming():
    v = _draw(I.Uniform(-0.5, 1.5))
    assert -0.5 <= v.min() and v.max() < 1.5
    _moments(v, 0.5, 2.0 / math.sqrt(12))
    fi, fo = 400, 500
    lim = math.sqrt(6.0 / (fi + fo))
    v = _draw(I.XavierUniform())
    assert -lim <= v.min() and v.max() < lim
    _moments(v, 0.0, lim / math.sqrt(3))
    _moments(_draw(I.XavierNormal()), 0.0, math.sqrt(2.0 / (fi + fo)))
    _moments(_draw(I.XavierNormal(gain=2.0)), 0.0,
             2.0 * math.sqrt(2.0 / (fi + fo)))
    _moments(_draw(I.KaimingNormal()), 0.0, math.sqrt(2.0 / fi))
    _moments(_draw(I.KaimingNormal(negative_slope=0.2,
                                   nonlinearity="leaky_relu")), 0.0,
             math.sqrt(2.0 / 1.04) / math.sqrt(fi))
    klim = math.sqrt(2.0) * math.sqrt(3.0 / fi)
    v = _draw(I.KaimingUniform())
    assert -klim <= v.min() and v.max() < klim
    _moments(v, 0.0, klim / math.sqrt(3))
    conv = _draw(I.KaimingNormal(), [64, 32, 3, 3])     # fan_in 32 * 9
    _moments(conv, 0.0, math.sqrt(2.0 / (32 * 9)))


def test_orthogonal_rows_or_columns_orthonormal():
    for shape in ([8, 20], [20, 8], [6, 2, 3]):
        w = _draw(I.Orthogonal(gain=1.5), shape).reshape(shape[0], -1)
        gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        np.testing.assert_allclose(gram, 2.25 * np.eye(len(gram)),
                                   atol=1e-5)


def test_deterministic_initializers_equal_jax(on_cpu):
    J = paddle_tpu.nn.initializer
    cases = [(I.Constant(0.25), J.Constant(0.25), [3, 4]),
             (I.Dirac(groups=2), J.Dirac(groups=2), [4, 3, 3, 3]),
             (I.Bilinear(), J.Bilinear(), [2, 2, 4, 4]),
             (I.Assign(np.arange(6.0)), J.Assign(np.arange(6.0)), [2, 3])]
    for mine, theirs, shape in cases:
        np.testing.assert_array_equal(
            mine(shape, "float32").numpy(),
            np.asarray(theirs(shape, paddle_tpu.float32)))
    assert I.calculate_gain("leaky_relu", 0.2) == \
        J.calculate_gain("leaky_relu", 0.2)
    assert I.calculate_gain("tanh") == J.calculate_gain("tanh")


def test_generator_draws_reproduce_and_default_follows_seed(on_cpu):
    np.testing.assert_array_equal(_draw(I.Normal(), [50], 7),
                                  _draw(I.Normal(), [50], 7))
    port.seed(11)
    a = I.XavierUniform()([5, 6]).numpy()
    port.seed(11)
    b = I.XavierUniform()([5, 6]).numpy()
    np.testing.assert_array_equal(a, b)
    assert I.Normal()([3], "bfloat16").dtype == torch.bfloat16
    assert I.Normal()([3], "int64").dtype == torch.float32
