"""The bodies of ``tests/test_linalg_decompositions.py`` on both packages:
the JAX package and the PyTorch port's ``paddle.linalg`` (on the CPU).
Decompositions are checked by property (reconstruction, orthogonality),
since sign and permutation conventions differ across backends, and the
results held across the two packages are the convention-free ones
(singular values, eigenvalues, reconstructions, solutions).
``default_program_raises_clearly`` is ``paddle.static``, which the port
does not have.
"""
import numpy as np
import pytest

from port_bodies import npy, on_cpu, run  # noqa: F401

PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


def _rand(n, m=None, seed=0):
    return np.random.default_rng(seed).standard_normal((n, m or n))


def _spd(n, seed=0):
    a = _rand(n, seed=seed)
    return a @ a.T + n * np.eye(n)


def svd_reconstruction_and_orthogonality(paddle):
    a = _rand(5, 3)
    u, s, vh = (npy(t) for t in paddle.linalg.svd(paddle.to_tensor(a),
                                                    full_matrices=False))
    np.testing.assert_allclose(u @ np.diag(s) @ vh, a, atol=1e-10)
    np.testing.assert_allclose(u.T @ u, np.eye(3), atol=1e-10)
    np.testing.assert_allclose(vh @ vh.T, np.eye(3), atol=1e-10)
    assert np.all(np.diff(s) <= 1e-12)
    return {"s": s}


def qr_reconstruction(paddle):
    a = _rand(6, 4)
    q, r = (npy(t) for t in paddle.linalg.qr(paddle.to_tensor(a)))
    np.testing.assert_allclose(q @ r, a, atol=1e-10)
    np.testing.assert_allclose(q.T @ q, np.eye(q.shape[1]), atol=1e-10)
    np.testing.assert_allclose(r, np.triu(r), atol=1e-12)
    return {"abs_diag_r": np.abs(np.diag(r))}


def eigh_spectral_decomposition(paddle):
    a = _spd(4)
    w, v = (npy(t) for t in paddle.linalg.eigh(paddle.to_tensor(a)))
    np.testing.assert_allclose(v @ np.diag(w) @ v.T, a, atol=1e-9)
    np.testing.assert_allclose(v.T @ v, np.eye(4), atol=1e-10)
    assert np.all(w > 0)
    return {"w": w}


def lu_reconstruction(paddle):
    a = _rand(4)
    out = paddle.linalg.lu(paddle.to_tensor(a))
    lu, piv = npy(out[0]), npy(out[1]).astype(int)   # 1-based swaps
    rec = (np.tril(lu, -1) + np.eye(4)) @ np.triu(lu)
    ap = a.copy()
    for i, p in enumerate(piv - 1):
        if p != i:
            ap[[i, p]] = ap[[p, i]]
    np.testing.assert_allclose(rec, ap, atol=1e-4)
    return {"rec": rec}


def lstsq_minimizes_residual(paddle):
    a, b = _rand(8, 3, seed=1), _rand(8, 1, seed=2)
    out = paddle.linalg.lstsq(paddle.to_tensor(a), paddle.to_tensor(b))
    x = npy(out[0] if isinstance(out, (tuple, list)) else out)
    want, *_ = np.linalg.lstsq(a, b, rcond=None)
    np.testing.assert_allclose(x, want, atol=1e-8)
    return {"x": x}


def matrix_rank_and_cond(paddle):
    full = _spd(4)
    lowrank = np.outer(np.arange(1.0, 5.0), np.arange(1.0, 5.0))
    r_full = int(npy(paddle.linalg.matrix_rank(paddle.to_tensor(full))))
    r_low = int(npy(paddle.linalg.matrix_rank(paddle.to_tensor(lowrank))))
    c = float(npy(paddle.linalg.cond(paddle.to_tensor(full))))
    assert (r_full, r_low) == (4, 1)
    assert c == pytest.approx(np.linalg.cond(full), rel=1e-6)
    return {"ranks": (r_full, r_low), "cond": np.array(c)}


def cov_corrcoef(paddle):
    x = _rand(3, 50, seed=3)
    cov = npy(paddle.linalg.cov(paddle.to_tensor(x)))
    corr = npy(paddle.linalg.corrcoef(paddle.to_tensor(x)))
    np.testing.assert_allclose(cov, np.cov(x), rtol=1e-8)
    np.testing.assert_allclose(corr, np.corrcoef(x), rtol=1e-8)
    return {"cov": cov, "corr": corr}


def triangular_and_cholesky_solve(paddle):
    a, b = _spd(4, seed=5), _rand(4, 2, seed=6)
    lo = np.linalg.cholesky(a)
    x = npy(paddle.linalg.triangular_solve(paddle.to_tensor(lo),
                                           paddle.to_tensor(b), upper=False))
    np.testing.assert_allclose(lo @ x, b, atol=1e-9)
    xc = npy(paddle.linalg.cholesky_solve(paddle.to_tensor(b),
                                          paddle.to_tensor(lo), upper=False))
    np.testing.assert_allclose(a @ xc, b, atol=1e-8)
    return {"x": x, "xc": xc}


def vector_norm_semantics(paddle):
    a = np.random.RandomState(0).randn(3, 4).astype("float32")
    t = paddle.to_tensor(a)
    L = paddle.linalg
    out = {"p1": float(npy(L.vector_norm(t, p=1))),
           "inf": float(npy(L.vector_norm(t, p=float("inf")))),
           "ax1": npy(L.vector_norm(t, p=2, axis=1))}
    np.testing.assert_allclose(out["p1"], np.abs(a).sum(), rtol=1e-5)
    np.testing.assert_allclose(out["inf"], np.abs(a).max(), rtol=1e-6)
    np.testing.assert_allclose(out["ax1"], np.linalg.norm(a, axis=1),
                               rtol=1e-5)
    return {k: np.asarray(v) for k, v in out.items()}


def matrix_norm_semantics(paddle):
    a = np.random.RandomState(1).randn(2, 3, 4).astype("float32")
    t = paddle.to_tensor(a)
    out = {}
    for p in ("fro", 1, np.inf, 2, "nuc", -1, -2):
        got = npy(paddle.linalg.matrix_norm(t, p=p))
        want = np.stack([np.linalg.norm(a[i], ord=p) for i in range(2)])
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
        out[str(p)] = got
    assert paddle.linalg.matrix_norm(t, p="fro", keepdim=True).shape == \
        [2, 1, 1]
    return out


BODIES = [svd_reconstruction_and_orthogonality, qr_reconstruction,
          eigh_spectral_decomposition, lu_reconstruction,
          lstsq_minimizes_residual, matrix_rank_and_cond, cov_corrcoef,
          triangular_and_cholesky_solve, vector_norm_semantics,
          matrix_norm_semantics]


@PKG
@pytest.mark.parametrize("body", BODIES, ids=[b.__name__ for b in BODIES])
def test_linalg_body(on_cpu, body, pkg):
    run(body, pkg, rtol=1e-4, atol=1e-6)
