"""The bodies of ``tests/test_tensor_ops.py`` on both packages: the JAX
package and the PyTorch port's op layer (on the CPU), each body's results
on the port held to the JAX package's (``port_bodies.run``).

Dtypes are compared by paddle name (``dname``); inputs drawn at random are
drawn from a seeded numpy generator, so both packages see the same ones.
``random_reproducible`` is held within each package only: the two
frameworks give different numbers from one seed.
"""
import numpy as np
import pytest

from port_bodies import dname, npy, on_cpu, run  # noqa: F401

PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


def to_tensor_dtypes(paddle):
    names = [dname(paddle.to_tensor([1, 2, 3])),
             dname(paddle.to_tensor([1.0, 2.0])),
             dname(paddle.to_tensor(np.zeros((2, 2), np.float64))),
             dname(paddle.to_tensor([1, 2], dtype="float32"))]
    assert names == ["int64", "float32", "float64", "float32"]
    scalars = [(paddle.to_tensor(v).shape, dname(paddle.to_tensor(v)))
               for v in (1.5, 3, True, np.float64(2.0), np.int32(4))]
    return {"names": names, "scalars": scalars}


def basic_arithmetic(paddle):
    x = paddle.to_tensor([1.0, 2.0, 3.0])
    y = paddle.to_tensor([4.0, 5.0, 6.0])
    out = {"add": npy(x + y), "mul": npy(x * y), "div": npy(y / x),
           "sub": npy(x - y), "pow": npy(x ** 2), "rsub": npy(2.0 - x)}
    np.testing.assert_allclose(out["add"], [5, 7, 9])
    np.testing.assert_allclose(out["mul"], [4, 10, 18])
    np.testing.assert_allclose(out["div"], [4, 2.5, 2])
    np.testing.assert_allclose(out["sub"], [-3, -3, -3])
    np.testing.assert_allclose(out["pow"], [1, 4, 9])
    np.testing.assert_allclose(out["rsub"], [1, 0, -1])
    return out


def int_float_promotion(paddle):
    x = paddle.to_tensor([1, 2, 3])
    out = {"div": dname(x / 2), "mul": dname(x * 2.5),
           "rmul": dname(2.5 * x), "pow": dname(x ** 2),
           "int_add": dname(x + 1), "int32_i64": dname(
               x.astype("int32") + x),
           "div_vals": npy(x / 2), "mul_vals": npy(x * 2.5)}
    assert "float" in out["div"] and "float" in out["mul"]
    return out


def shape_is_list(paddle):
    x = paddle.zeros([2, 3])
    assert x.shape == [2, 3]
    assert isinstance(x.shape, list)
    return {"shape": x.shape}


def manipulation(paddle):
    x = paddle.arange(24).reshape([2, 3, 4])
    shapes = {"t": x.transpose([2, 0, 1]).shape,
              "cat": paddle.concat([x, x], axis=1).shape,
              "flat": paddle.flatten(x).shape,
              "sq": paddle.squeeze(paddle.unsqueeze(x, 0), 0).shape,
              "stack": paddle.stack([x, x]).shape,
              "tile": paddle.tile(x, [1, 2, 1]).shape}
    parts = paddle.split(x, 3, axis=1)
    assert len(parts) == 3 and parts[0].shape == [2, 1, 4]
    assert shapes == {"t": [4, 2, 3], "cat": [2, 6, 4], "flat": [24],
                      "sq": [2, 3, 4], "stack": [2, 2, 3, 4],
                      "tile": [2, 6, 4]}
    return {**shapes, "part1": npy(parts[1])}


def indexing(paddle):
    x = paddle.arange(12).reshape([3, 4])
    out = {"row": npy(x[1]), "col": npy(x[:, 1]), "step": npy(x[1:, ::2])}
    np.testing.assert_array_equal(out["row"], [4, 5, 6, 7])
    np.testing.assert_array_equal(out["col"], [1, 5, 9])
    np.testing.assert_array_equal(out["step"], [[4, 6], [8, 10]])
    x[0] = 0
    assert int(npy(x)[0].sum()) == 0
    sel = x[x > 5]
    np.testing.assert_array_equal(npy(sel), [6, 7, 8, 9, 10, 11])
    return {**out, "set": npy(x), "sel": npy(sel), "sel_dtype": dname(sel)}


def reductions(paddle):
    x = paddle.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
    out = {"sum": npy(x.sum()), "mean0": npy(x.mean(axis=0)),
           "max1": npy(x.max(axis=1)), "std": float(npy(x.std()))}
    np.testing.assert_allclose(out["sum"], 66.0)
    np.testing.assert_allclose(out["mean0"], [4, 5, 6, 7])
    np.testing.assert_allclose(out["max1"], [3, 7, 11])
    assert out["std"] == pytest.approx(np.arange(12).std(ddof=1), rel=1e-5)
    return out


def matmul(paddle):
    rng = np.random.default_rng(0)
    an = rng.standard_normal((3, 4)).astype(np.float32)
    bn = rng.standard_normal((4, 5)).astype(np.float32)
    a, b = paddle.to_tensor(an), paddle.to_tensor(bn)
    out = {"ab": npy(a @ b), "aat": npy(paddle.matmul(a, a, transpose_y=True))}
    np.testing.assert_allclose(out["ab"], an @ bn, rtol=1e-5)
    np.testing.assert_allclose(out["aat"], an @ an.T, rtol=1e-5)
    return out


def search_sort(paddle):
    x = paddle.to_tensor([[3.0, 1.0, 2.0], [6.0, 5.0, 4.0]])
    vals, idx = paddle.topk(x, 2, axis=1)
    out = {"argmax": npy(paddle.argmax(x, axis=1)), "topk": npy(vals),
           "topk_idx": npy(idx), "sort": npy(paddle.sort(x, axis=1)),
           "where": npy(paddle.where(x > 2.5, x, paddle.zeros_like(x)))}
    np.testing.assert_array_equal(out["argmax"], [0, 0])
    np.testing.assert_allclose(out["topk"], [[3, 2], [6, 5]])
    np.testing.assert_allclose(out["sort"], [[1, 2, 3], [4, 5, 6]])
    np.testing.assert_allclose(out["where"], [[3, 0, 0], [6, 5, 4]])
    return out


def einsum(paddle):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((2, 3)).astype(np.float32)
    b = rng.standard_normal((3, 4)).astype(np.float32)
    out = npy(paddle.einsum("ij,jk->ik", paddle.to_tensor(a),
                            paddle.to_tensor(b)))
    np.testing.assert_allclose(out, a @ b, rtol=1e-5)
    return {"out": out}


def creation(paddle):
    out = {"eye": paddle.eye(3).shape,
           "full": float(npy(paddle.full([2, 2], 7)).sum()),
           "full_dtype": dname(paddle.full([2, 2], 7)),
           "arange": paddle.arange(0, 10, 2).shape,
           "linspace": npy(paddle.linspace(0, 1, 5)),
           "tril": float(npy(paddle.tril(paddle.ones([3, 3]))).sum())}
    assert out["eye"] == [3, 3] and out["full"] == 28
    assert out["arange"] == [5] and out["linspace"].shape == (5,)
    assert out["tril"] == 6
    return out


def inplace_ops(paddle):
    x = paddle.to_tensor([1.0, 2.0])
    assert x.add_(paddle.to_tensor([1.0, 1.0])) is x
    np.testing.assert_allclose(npy(x), [2, 3])
    x.scale_(2.0)
    np.testing.assert_allclose(npy(x), [4, 6])
    return {"x": npy(x)}


def cast(paddle):
    x = paddle.to_tensor([1.5, 2.5])
    out = {"i32": dname(x.astype("int32")),
           "f64": dname(x.astype(paddle.float64)),
           "vals": npy(x.astype("int32"))}
    assert out["i32"] == "int32" and out["f64"] == "float64"
    return out


def random_reproducible(paddle):
    paddle.seed(42)
    a = paddle.rand([4])
    paddle.seed(42)
    b = paddle.rand([4])
    np.testing.assert_allclose(npy(a), npy(b))
    assert ((npy(a) >= 0) & (npy(a) < 1)).all()
    return {"dtype": dname(a), "shape": a.shape}


BODIES = [to_tensor_dtypes, basic_arithmetic, int_float_promotion,
          shape_is_list, manipulation, indexing, reductions, matmul,
          search_sort, einsum, creation, inplace_ops, cast,
          random_reproducible]


@PKG
@pytest.mark.parametrize("body", BODIES, ids=[b.__name__ for b in BODIES])
def test_tensor_ops_body(on_cpu, body, pkg):
    run(body, pkg)
