"""The export-parity fill-ins (``ops/parity.py``) and the in-place set on
the port, against the JAX package on the same numpy inputs (on the CPU):
values at 1e-10 (float64, the same arithmetic) unless a case says
otherwise, dtypes by paddle name, shapes exactly.
"""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch as port
from port_bodies import dname, npy, on_cpu  # noqa: F401

RNG = np.random.default_rng(5)
A = RNG.uniform(0.5, 2.0, (3, 4))
B = RNG.uniform(0.5, 2.0, (3, 4))
V = RNG.uniform(-2.0, 2.0, (6,))
M = RNG.uniform(-1.0, 1.0, (4, 4))
I = np.array([0, 2])

CASES = {
    "add_n": lambda P: P.add_n([P.to_tensor(A), P.to_tensor(B),
                                P.to_tensor(A)]),
    "block_diag": lambda P: P.block_diag([P.to_tensor(A), P.to_tensor(M)]),
    "column_stack": lambda P: P.column_stack([P.to_tensor(V),
                                              P.to_tensor(V * 2)]),
    "row_stack": lambda P: P.row_stack([P.to_tensor(A), P.to_tensor(B)]),
    "hstack": lambda P: P.hstack([P.to_tensor(A), P.to_tensor(B)]),
    "vstack": lambda P: P.vstack([P.to_tensor(A), P.to_tensor(B)]),
    "dstack": lambda P: P.dstack([P.to_tensor(A), P.to_tensor(B)]),
    "hsplit": lambda P: P.hsplit(P.to_tensor(A), 2),
    "vsplit": lambda P: P.vsplit(P.to_tensor(M), [1, 3]),
    "dsplit": lambda P: P.dsplit(P.to_tensor(A.reshape(3, 2, 2)), 2),
    "tensor_split": lambda P: P.tensor_split(P.to_tensor(V), 4),
    "cartesian_prod": lambda P: P.cartesian_prod([P.to_tensor(V[:2]),
                                                  P.to_tensor(V[2:5])]),
    "combinations": lambda P: P.combinations(P.to_tensor(V[:4]), 2),
    "unflatten": lambda P: P.unflatten(P.to_tensor(A), 1, [2, 2]),
    "as_strided": lambda P: P.as_strided(P.to_tensor(A), [2, 3], [4, 1], 1),
    "matrix_transpose": lambda P: P.matrix_transpose(P.to_tensor(A)),
    "reverse": lambda P: P.reverse(P.to_tensor(A), [0, 1]),
    "diagonal_scatter": lambda P: P.diagonal_scatter(P.to_tensor(M),
                                                     P.to_tensor(V[:3]), 1),
    "select_scatter": lambda P: P.select_scatter(P.to_tensor(A),
                                                 P.to_tensor(B[0]), 0, 1),
    "slice_scatter": lambda P: P.slice_scatter(
        P.to_tensor(M), P.to_tensor(M[:, :2] * 3), [1], [0], [4], [2]),
    "index_fill": lambda P: P.index_fill(P.to_tensor(A), P.to_tensor(I), 1,
                                         -1.0),
    "gammaln": lambda P: P.gammaln(P.to_tensor(A)),
    "gammainc": lambda P: P.gammainc(P.to_tensor(A), P.to_tensor(B)),
    "gammaincc": lambda P: P.gammaincc(P.to_tensor(A), P.to_tensor(B)),
    "multigammaln": lambda P: P.multigammaln(P.to_tensor(A + 1), 2),
    "polygamma": lambda P: P.polygamma(P.to_tensor(A), 1),
    "i0e": lambda P: P.i0e(P.to_tensor(V)),
    "i1": lambda P: P.i1(P.to_tensor(V)),
    "i1e": lambda P: P.i1e(P.to_tensor(V)),
    "sinc": lambda P: P.sinc(P.to_tensor(V)),
    "frexp": lambda P: P.frexp(P.to_tensor(V)),
    "signbit": lambda P: P.signbit(P.to_tensor(V)),
    "isin": lambda P: P.isin(P.to_tensor(np.arange(6)),
                             P.to_tensor(np.array([1, 4, 9]))),
    "isneginf": lambda P: P.isneginf(P.to_tensor(np.array([1.0, -np.inf]))),
    "isposinf": lambda P: P.isposinf(P.to_tensor(np.array([np.inf, 1.0]))),
    "histogram_bin_edges": lambda P: P.histogram_bin_edges(P.to_tensor(V),
                                                           bins=4),
    "renorm": lambda P: P.renorm(P.to_tensor(A), 2.0, 0, 1.5),
    "reduce_as": lambda P: P.reduce_as(P.to_tensor(A),
                                       P.to_tensor(np.zeros((1, 4)))),
    "negative": lambda P: P.negative(P.to_tensor(V)),
    "positive": lambda P: P.positive(P.to_tensor(V)),
    "less": lambda P: P.less(P.to_tensor(A), P.to_tensor(B)),
    "floor_mod": lambda P: P.floor_mod(P.to_tensor(A * 3), P.to_tensor(B)),
    "rank": lambda P: P.rank(P.to_tensor(A)),
    "shape": lambda P: P.shape(P.to_tensor(A)),
    "check_shape": lambda P: P.check_shape(P.to_tensor(A)),
    "tanh_": lambda P: P.tanh_(P.to_tensor(A)),
    "multiply_": lambda P: P.to_tensor(A).multiply_(P.to_tensor(B)),
    "clip_": lambda P: P.to_tensor(V).clip_(-0.5, 0.5),
    "index_fill_": lambda P: P.index_fill_(P.to_tensor(A), P.to_tensor(I), 1,
                                           2.0),
    "less_": lambda P: P.to_tensor(A).less_(P.to_tensor(B)),
    "bitwise_invert_": lambda P: P.bitwise_invert_(
        P.to_tensor(np.arange(4, dtype=np.int32))),
}
# JAX's own special functions and histogram edges are float32 inside:
# polygamma and the Bessel forms agree with torch's to ~1e-6
TOL = {"polygamma": 1e-6, "i0e": 1e-6, "i1": 1e-6, "i1e": 1e-6,
       "gammainc": 1e-8, "gammaincc": 1e-8, "histogram_bin_edges": 1e-6}


def leaves(x):
    if isinstance(x, (list, tuple)):
        return [e for item in x for e in leaves(item)]
    return [x]


@pytest.mark.parametrize("name", sorted(CASES))
def test_parity_op_matches_jax(on_cpu, name):
    got, want = CASES[name](port), CASES[name](paddle_tpu)
    got_l, want_l = leaves(got), leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        if not hasattr(w, "_value"):            # a Python value
            assert g == w
            continue
        assert dname(g) == dname(w), (dname(g), dname(w))
        gn, wn = npy(g), npy(w)
        assert gn.shape == wn.shape
        if gn.dtype.kind in "fc":
            np.testing.assert_allclose(gn, wn, rtol=TOL.get(name, 1e-10),
                                       atol=TOL.get(name, 1e-10))
        else:
            np.testing.assert_array_equal(gn, wn)


def test_constants_and_shims(on_cpu):
    assert (port.pi, port.e, port.inf) == (paddle_tpu.pi, paddle_tpu.e,
                                           paddle_tpu.inf)
    assert port.newaxis is None
    with port.LazyGuard():
        pass
    t = port.to_tensor(A)
    back = port.from_dlpack(port.to_dlpack(t))
    np.testing.assert_array_equal(back.numpy(), A)
    made = port.create_parameter([2, 2], "float32")
    want = paddle_tpu.create_parameter([2, 2], "float32")
    assert isinstance(made, port.nn.Parameter)
    assert (made.shape, dname(made)) == (want.shape, dname(want))
    assert made.stop_gradient is want.stop_gradient is False
    assert made.optimize_attr == want.optimize_attr == {"learning_rate": 1.0}
    assert made.place.is_cpu_place()
    pdist = port.pdist(port.to_tensor(M))
    want = [np.linalg.norm(M[i] - M[j]) for i in range(4)
            for j in range(i + 1, 4)]
    np.testing.assert_allclose(pdist.numpy(), want, rtol=1e-12)
    cd = port.cdist(port.to_tensor(A), port.to_tensor(B))
    np.testing.assert_allclose(
        cd.numpy(), np.linalg.norm(A[:, None] - B[None], axis=-1),
        rtol=1e-12)
