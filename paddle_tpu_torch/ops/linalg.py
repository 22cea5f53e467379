"""Linear algebra — the counterpart of ``paddle_tpu/ops/linalg.py``, on
``torch.linalg``. ``cholesky``, ``inverse`` and ``solve`` take the ``_ex``
forms without the host check of the factorisation's status: as in JAX, a
singular or indefinite input gives NaNs instead of raising, and the call
can be captured in a CUDA graph. ``matmul`` is the product the models run
through; on the card a float32 product runs in full float32 unless
``FLAGS_matmul_precision`` allows TF32. Every op computes on its input's
device: ``bincount``'s size and a histogram's range taken from the data
are read back to the host, nothing else is."""
from __future__ import annotations

import numpy as np
import torch

from . import _inexact, _promote, apply_op

__all__ = [
    "matmul", "mm", "bmm", "dot", "t", "norm", "dist", "cross", "cholesky",
    "cholesky_solve", "bincount", "mv", "histogram", "histogramdd",
    "matrix_power", "qr", "lu", "eig", "eigh", "eigvals", "eigvalsh", "svd",
    "pinv", "solve", "triangular_solve", "lstsq", "slogdet", "det",
    "inverse", "matrix_rank", "cov", "corrcoef", "cond", "vecdot",
    "multi_dot", "householder_product", "matrix_exp", "matrix_norm",
    "vector_norm", "cholesky_inverse", "diagonal", "matrix_transpose",
    "svdvals", "lu_unpack", "ormqr", "svd_lowrank", "pca_lowrank",
]

_INF = float("inf")


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def f(a, b):
        a, b = _promote(a, b)
        if transpose_x and a.dim() >= 2:
            a = a.mT
        if transpose_y and b.dim() >= 2:
            b = b.mT
        return torch.matmul(a, b)

    return apply_op(f, "matmul", x, y)


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def bmm(x, y, name=None):
    return apply_op(lambda a, b: torch.matmul(*_promote(a, b)), "bmm", x, y)


def dot(x, y, name=None):
    return apply_op(lambda a, b: (lambda p, q: (p * q).sum(-1))(
        *_promote(a, b)), "dot", x, y)


def mv(x, vec, name=None):
    return apply_op(lambda a, b: torch.matmul(*_promote(a, b)), "mv", x, vec)


def t(input, name=None):
    return apply_op(lambda v: v.mT if v.dim() >= 2 else v, "t", input)


def _axes(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def norm(x, p=None, axis=None, keepdim=False, name=None):
    def f(v):
        pp = p
        ax = _axes(axis)
        if pp is None:
            pp = "fro" if (ax is None or isinstance(ax, tuple)) else 2
        a = v.abs()
        if ax is None and pp in ("fro", 2):
            return torch.sqrt(torch.sum(a * a))
        dims = tuple(range(v.dim())) if ax is None else ax
        if pp == "fro":
            return torch.sqrt(torch.sum(a * a, dims, keepdim))
        if pp == "nuc":
            return torch.linalg.svdvals(v).sum(-1, keepdim)
        if pp == _INF:
            return torch.amax(a, dims, keepdim)
        if pp == -_INF:
            return torch.amin(a, dims, keepdim)
        if pp == 0:
            return torch.sum((v != 0).to(v.dtype), dims, keepdim)
        return torch.pow(torch.sum(torch.pow(a, pp), dims, keepdim), 1.0 / pp)

    return apply_op(f, "norm", x)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    """Every axis when ``axis`` is None (not the Frobenius default of
    ``norm``)."""
    def f(v):
        ax = _axes(axis)
        dims = tuple(range(v.dim())) if ax is None else ax
        a = v.abs()
        if p == _INF:
            return torch.amax(a, dims, keepdim)
        if p == -_INF:
            return torch.amin(a, dims, keepdim)
        if p == 0:
            return torch.sum((v != 0).to(v.dtype), dims, keepdim)
        if p == 2:
            return torch.sqrt(torch.sum(a * a, dims, keepdim))
        return torch.pow(torch.sum(torch.pow(a, p), dims, keepdim), 1.0 / p)

    return apply_op(f, "vector_norm", x)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    if not (isinstance(axis, (list, tuple)) and len(axis) == 2):
        raise ValueError(f"matrix_norm axis must be 2 axes, got {axis!r}")
    if p not in ("fro", "nuc", 1, -1, 2, -2, _INF, -_INF):
        raise ValueError(f"matrix_norm: unsupported p={p!r}")
    return apply_op(lambda v: torch.linalg.matrix_norm(
        v, p, tuple(axis), keepdim), "matrix_norm", x)


def vecdot(x, y, axis=-1, name=None):
    return apply_op(lambda a, b: (lambda p, q: (p * q).sum(axis))(
        *_promote(a, b)), "vecdot", x, y)


def dist(x, y, p=2, name=None):
    def f(a, b):
        d = (a - b).abs()
        if p == 0:
            return torch.sum((d != 0).to(a.dtype))
        if p == _INF:
            return torch.amax(d)
        if p == -_INF:
            return torch.amin(d)
        return torch.pow(torch.sum(torch.pow(d, p)), 1.0 / p)

    return apply_op(f, "dist", x, y)


def cross(x, y, axis=9, name=None):
    def f(a, b):
        ax = axis
        if ax == 9:     # paddle's default: the first axis of size 3
            ax = next((i for i, s in enumerate(a.shape) if s == 3), -1)
        return torch.linalg.cross(*_promote(a, b), dim=ax)

    return apply_op(f, "cross", x, y)


def cholesky(x, upper=False, name=None):
    return apply_op(lambda v: torch.linalg.cholesky_ex(
        v, upper=upper, check_errors=False)[0], "cholesky", x)


def cholesky_solve(x, y, upper=False, name=None):
    return apply_op(lambda b, c: torch.cholesky_solve(b, c, upper),
                    "cholesky_solve", x, y)


def bincount(x, weights=None, minlength=0, name=None):
    """Reads the largest value back to the host (a data-dependent size)."""
    return apply_op(lambda v, w: torch.bincount(v, w, minlength),
                    "bincount", x, weights)


def _bin_index(u, lo, hi, bins):
    """The bin of each value of ``u`` among ``bins`` equal bins over
    [lo, hi] (the last one closed), and whether it lies inside."""
    inside = (u >= lo) & (u <= hi)
    idx = ((u - lo) * (bins / (hi - lo))).floor().long().clamp(0, bins - 1)
    return idx, inside


def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    """Counts (int64, as JAX casts them) or densities over ``bins`` equal
    bins of [min, max], on the input's device; min = max = 0 takes the
    data's range, which reads it back to the host."""
    def f(v, w):
        lo, hi = float(min), float(max)
        if lo == 0 and hi == 0:
            lo, hi = float(v.min()), float(v.max())
        u = _inexact(v).reshape(-1)
        idx, inside = _bin_index(u, lo, hi, bins)
        wt = inside.to(u.dtype) * (1 if w is None
                                   else w.reshape(-1).to(u.dtype))
        h = torch.zeros(bins, dtype=u.dtype, device=u.device).index_add(
            0, idx, wt)
        if density:
            return h / (h.sum() * (hi - lo) / bins)
        return h.to(torch.int64)

    return apply_op(f, "histogram", input, weight)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """The joint histogram of the rows of x [N, D] over ``bins`` equal
    bins per dimension (``ranges``: [lo0, hi0, lo1, hi1, ...]; None takes
    the data's range, read back to the host); returns (hist, edges), on
    the input's device."""
    def f(v, w):
        n, d = v.shape
        nb = [bins] * d if isinstance(bins, int) else list(bins)
        u = v.to(torch.float64)
        if ranges is None:
            lohi = [(float(u[:, k].min()), float(u[:, k].max()))
                    for k in range(d)]
        else:
            lohi = [(float(ranges[2 * k]), float(ranges[2 * k + 1]))
                    for k in range(d)]
        flat = torch.zeros(n, dtype=torch.long, device=u.device)
        keep = torch.ones(n, dtype=torch.bool, device=u.device)
        for k in range(d):
            idx, inside = _bin_index(u[:, k], *lohi[k], nb[k])
            flat = flat * nb[k] + idx
            keep &= inside
        wt = keep.to(u.dtype) * (1 if w is None else w.to(u.dtype))
        h = torch.zeros(int(np.prod(nb)), dtype=u.dtype,
                        device=u.device).index_add(0, flat, wt).reshape(nb)
        edges = [torch.linspace(lo, hi, b + 1, dtype=u.dtype,
                                device=u.device)
                 for (lo, hi), b in zip(lohi, nb)]
        if density:
            cell = 1.0
            for (lo, hi), b in zip(lohi, nb):
                cell *= (hi - lo) / b
            h = h / (h.sum() * cell)
        return h, edges

    return apply_op(f, "histogramdd", x, weights)


def matrix_power(x, n, name=None):
    return apply_op(lambda v: torch.linalg.matrix_power(v, n),
                    "matrix_power", x)


def matrix_exp(x, name=None):
    return apply_op(torch.linalg.matrix_exp, "matrix_exp", x)


def qr(x, mode="reduced", name=None):
    if mode == "r":
        return apply_op(lambda v: torch.linalg.qr(v, "r")[1], "qr", x)
    return apply_op(lambda v: tuple(torch.linalg.qr(v, mode)), "qr", x)


def lu(x, pivot=True, get_infos=False, name=None):
    """(packed LU, 1-based int32 pivots[, info]), LAPACK's layout."""
    def f(v):
        lu_, piv, info = torch.linalg.lu_factor_ex(v, pivot=pivot)
        piv = piv.to(torch.int32)
        if get_infos:
            return lu_, piv, info.to(torch.int32)
        return lu_, piv

    return apply_op(f, "lu", x)


def eig(x, name=None):
    return apply_op(lambda v: tuple(torch.linalg.eig(v)), "eig", x)


def eigh(x, UPLO="L", name=None):
    return apply_op(lambda v: tuple(torch.linalg.eigh(v, UPLO)), "eigh", x)


def eigvals(x, name=None):
    return apply_op(torch.linalg.eigvals, "eigvals", x)


def eigvalsh(x, UPLO="L", name=None):
    return apply_op(lambda v: torch.linalg.eigvalsh(v, UPLO), "eigvalsh", x)


def svd(x, full_matrices=False, name=None):
    return apply_op(lambda v: tuple(torch.linalg.svd(v, full_matrices)),
                    "svd", x)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    """JAX's pseudo-inverse: singular values at or below ``rcond`` times
    the largest are dropped."""
    def f(v):
        u, s, vh = torch.linalg.svd(v, full_matrices=False)
        cut = rcond * s.amax(-1, keepdim=True)
        s_inv = torch.where(s > cut, 1.0 / s, torch.zeros_like(s))
        return (vh.mT * s_inv.unsqueeze(-2)) @ u.mT

    return apply_op(f, "pinv", x)


def solve(x, y, name=None):
    def f(a, b):
        if b.dim() == a.dim() - 1:
            return torch.linalg.solve_ex(a, b.unsqueeze(-1),
                                         check_errors=False)[0].squeeze(-1)
        return torch.linalg.solve_ex(a, b, check_errors=False)[0]

    return apply_op(f, "solve", x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def f(a, b):
        if transpose:
            a, upper_ = a.mT, not upper
        else:
            upper_ = upper
        return torch.linalg.solve_triangular(a, b, upper=upper_,
                                             unitriangular=unitriangular)

    return apply_op(f, "triangular_solve", x, y)


def lstsq(x, y, rcond=None, driver=None, name=None):
    def f(a, b):
        drv = driver or ("gelsd" if a.device.type == "cpu" else "gels")
        r = torch.linalg.lstsq(a, b, rcond=rcond, driver=drv)
        return r.solution, r.residuals, r.rank.to(torch.int64), \
            r.singular_values

    return apply_op(f, "lstsq", x, y)


def slogdet(x, name=None):
    return apply_op(lambda v: torch.stack(torch.linalg.slogdet(v)),
                    "slogdet", x)


def det(x, name=None):
    return apply_op(torch.linalg.det, "det", x)


def inverse(x, name=None):
    return apply_op(lambda v: torch.linalg.inv_ex(v, check_errors=False)[0],
                    "inverse", x)


def matrix_rank(x, tol=None, hermitian=False, atol=None, rtol=None,
                name=None):
    return apply_op(lambda v: torch.linalg.matrix_rank(
        v, atol=atol, rtol=tol if tol is not None else rtol,
        hermitian=hermitian).to(torch.int64), "matrix_rank", x)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    def f(v, fw, aw):
        v = v if rowvar else v.mT
        return torch.cov(_inexact(v), correction=int(bool(ddof)),
                         fweights=fw, aweights=aw)

    return apply_op(f, "cov", x, fweights, aweights)


def corrcoef(x, rowvar=True, name=None):
    return apply_op(lambda v: torch.corrcoef(_inexact(v if rowvar else v.mT)),
                    "corrcoef", x)


def cond(x, p=None, name=None):
    return apply_op(lambda v: torch.linalg.cond(v, p), "cond", x)


def multi_dot(x, name=None):
    return apply_op(lambda *vs: torch.linalg.multi_dot(vs), "multi_dot", *x)


def householder_product(x, tau, name=None):
    return apply_op(torch.linalg.householder_product, "householder_product",
                    x, tau)


def cholesky_inverse(x, upper=False, name=None):
    return apply_op(lambda u: torch.cholesky_inverse(u, upper),
                    "cholesky_inverse", x)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op(lambda v: torch.diagonal(v, offset, axis1, axis2),
                    "diagonal", x)


def matrix_transpose(x, name=None):
    return apply_op(lambda v: v.mT, "matrix_transpose", x)


def svdvals(x, name=None):
    return apply_op(torch.linalg.svdvals, "svdvals", x)


def lu_unpack(lu_data, lu_pivots, unpack_ludata=True, unpack_pivots=True,
              name=None):
    """Packed LU and 1-based pivots as (P, L, U), A = P L U."""
    return apply_op(lambda a, piv: tuple(torch.lu_unpack(a, piv.to(
        torch.int32), unpack_ludata, unpack_pivots)), "lu_unpack",
        lu_data, lu_pivots)


def ormqr(x, tau, y, left=True, transpose=False, name=None):
    return apply_op(lambda a, t_, b: torch.ormqr(a, t_, b, left, transpose),
                    "ormqr", x, tau, y)


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """Halko's randomized range finder, as the JAX package: a Gaussian
    sketch (from the port's default generator of the input's device),
    ``niter`` power iterations, one small SVD."""
    from ..framework.random import default_generator

    def f(a, mm):
        if mm is not None:
            a = a - mm
        m, n = a.shape[-2], a.shape[-1]
        rank = min(q, m, n)
        omega = torch.randn(a.shape[:-2] + (n, rank), dtype=a.dtype,
                            device=a.device,
                            generator=default_generator(a.device))
        y = a @ omega
        for _ in range(niter):
            y = a @ (a.mT @ y)
        qm, _ = torch.linalg.qr(y)
        u_b, s, vh = torch.linalg.svd(qm.mT @ a, full_matrices=False)
        return qm @ u_b, s, vh.mT

    return apply_op(f, "svd_lowrank", x, M)


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    if center:
        x = apply_op(lambda v: v - v.mean(-2, keepdim=True), "center", x)
    return svd_lowrank(x, q=q or 6, niter=niter)
