"""The port's nn pieces for the other model families — ``gelu`` (exact and
tanh), ``silu``, ``layer_norm`` / ``LayerNorm`` and ``Embedding`` — held to
the JAX package's on the same numpy inputs, on the CPU in f32 (within
1e-6: another order of the same f32 operations), and their bf16 casts
(within one bf16 rounding, 2^-7 relative)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from port_bodies import on_cpu  # noqa: F401

F32 = dict(atol=1e-6, rtol=1e-6)


def _x(shape=(3, 5, 16), seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * scale)


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches_jax(approximate):
    x = _x()
    got = TF.gelu(torch.from_numpy(x), approximate=approximate).numpy()
    want = np.asarray(JF.gelu(paddle.to_tensor(x),
                              approximate=approximate)._value)
    np.testing.assert_allclose(got, want, **F32)
    other = TF.gelu(torch.from_numpy(x), approximate=not approximate)
    assert np.abs(other.numpy() - want).max() > 1e-5   # the forms differ


def test_silu_matches_jax():
    x = _x()
    np.testing.assert_allclose(
        TF.silu(torch.from_numpy(x)).numpy(),
        np.asarray(JF.silu(paddle.to_tensor(x))._value), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [16, [5, 16]])
def test_layer_norm_matches_jax(shape, dtype):
    x = _x() + 2.0
    n = shape if isinstance(shape, int) else int(np.prod(shape))
    rng = np.random.default_rng(1)
    w = rng.standard_normal(n).astype(np.float32).reshape(
        np.shape(np.zeros(shape)))
    b = rng.standard_normal(n).astype(np.float32).reshape(w.shape)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = TF.layer_norm(tx, shape, torch.from_numpy(w), torch.from_numpy(b),
                        1e-5)
    jx = paddle.to_tensor(x).astype(dtype)
    want = JF.layer_norm(jx, shape, paddle.to_tensor(w), paddle.to_tensor(b),
                         1e-5)
    assert got.dtype == tx.dtype
    tol = F32 if dtype == "float32" else dict(atol=2 ** -7, rtol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want._value.astype("float32")),
                               **tol)


def test_layer_norm_layer_defaults_and_o1_cast(on_cpu):
    """Weight 1, bias 0, epsilon 1e-5 as JAX's ``LayerNorm``; under O1 the
    op ``layer_norm`` is black-listed, so it runs and returns in f32."""
    ln = tnn.LayerNorm(16)
    assert ln.epsilon == 1e-5
    assert torch.equal(ln.weight._value, torch.ones(16))
    assert torch.equal(ln.bias._value, torch.zeros(16))
    x = _x()
    want = np.asarray(paddle.nn.LayerNorm(16)(paddle.to_tensor(x))._value)
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(),
                               want, **F32)
    with tamp.auto_cast(level="O1", dtype="bfloat16"):
        assert ln(torch.from_numpy(x).bfloat16()).dtype == torch.float32
    assert tnn.LayerNorm(16, weight_attr=False, bias_attr=False).weight is None


def test_embedding_matches_jax_lookup_and_padding_row(on_cpu):
    with paddle.utils.unique_name.guard():
        je = paddle.nn.Embedding(10, 6, padding_idx=-1)
    te = tnn.Embedding(10, 6, padding_idx=-1)
    assert te.padding_idx == 9
    with torch.no_grad():
        te.weight.copy_(torch.from_numpy(np.array(je.weight._value)))
    ids = np.array([[0, 9, 3], [9, 1, 2]])
    np.testing.assert_allclose(
        te(torch.from_numpy(ids)).detach().numpy(),
        np.asarray(je(paddle.to_tensor(ids))._value), **F32)
    assert float(np.abs(np.asarray(je.weight._value)[9]).max()) == 0.0


def test_embedding_init_is_xavier_normal_and_seeded(on_cpu):
    a, b = tnn.Embedding(400, 300), tnn.Embedding(400, 300)
    a.reset_parameters(torch.Generator().manual_seed(0))
    b.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(a.weight._value, b.weight._value)
    std = float(a.weight._value.detach().std())
    assert abs(std - (2.0 / 700) ** 0.5) < 0.02 * (2.0 / 700) ** 0.5
    with paddle.utils.unique_name.guard():
        jstd = float(np.asarray(paddle.nn.Embedding(400, 300)
                                .weight._value).std())
    assert abs(jstd - std) < 0.02 * std
