"""Vision functionals — the counterpart of
``paddle_tpu/nn/functional/vision.py``: ``affine_grid`` and ``grid_sample``
(bilinear or nearest; padding ``zeros``, ``border`` or ``reflection``;
either ``align_corners``), JAX's formulas through ``ops.apply_like``
under JAX's op names. No kernel stands behind them in JAX (XLA gathers),
nor here (torch's indexing).
"""
from __future__ import annotations

import torch

from ...ops import apply_like

__all__ = ["affine_grid", "grid_sample"]


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """theta [N, 2, 3] -> the sampling grid [N, H, W, 2] of the (x, y)
    points theta maps the output's normalised coordinates to."""
    n, c, h, w = (int(s) for s in out_shape)

    def f(th):
        # the base grid in f64, as JAX (x64) builds it, then th's dtype
        kw = dict(dtype=torch.float64, device=th.device)
        if align_corners:
            ys = torch.linspace(-1.0, 1.0, h, **kw)
            xs = torch.linspace(-1.0, 1.0, w, **kw)
        else:
            ys = (torch.arange(h, **kw) + 0.5) * 2.0 / h - 1.0
            xs = (torch.arange(w, **kw) + 0.5) * 2.0 / w - 1.0
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        base = torch.stack([gx, gy, torch.ones_like(gx)], -1)   # [H, W, 3]
        return torch.einsum("hwk,nrk->nhwr", base.to(th.dtype), th)

    return apply_like(f, "affine_grid", theta)


def _reflect(i, size, align_corners):
    if align_corners:
        span = 2 * (size - 1)
        if span <= 0:
            return i * 0
        i = i.abs() % span
        return torch.where(i >= size, span - i, i)
    span = 2 * size
    i = torch.remainder(i.abs(), span)
    return torch.where(i >= size, span - 1 - i, i)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """x [N, C, H, W] sampled at grid [N, Hg, Wg, 2] ((x, y) in [-1, 1])
    -> [N, C, Hg, Wg]."""
    def f(v, g):
        n, _, h, w = v.shape
        gx, gy = g[..., 0], g[..., 1]
        if align_corners:
            fx, fy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
        else:
            fx, fy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2

        def sample(ix, iy):
            if padding_mode == "reflection":
                ix = _reflect(ix, w, align_corners)
                iy = _reflect(iy, h, align_corners)
            valid = ((ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
                     if padding_mode == "zeros" else None)
            ix, iy = ix.clamp(0, w - 1), iy.clamp(0, h - 1)
            batch = torch.arange(n, device=v.device).reshape(n, 1, 1)
            vals = v[batch, :, iy.long(), ix.long()]       # [N, Hg, Wg, C]
            if valid is None:
                return vals
            return torch.where(valid[..., None], vals,
                               torch.zeros((), dtype=vals.dtype,
                                           device=vals.device))

        if mode == "nearest":
            out = sample(torch.round(fx), torch.round(fy))
        else:
            x0, y0 = torch.floor(fx), torch.floor(fy)
            x1, y1 = x0 + 1, y0 + 1
            out = (sample(x0, y0) * ((x1 - fx) * (y1 - fy))[..., None]
                   + sample(x0, y1) * ((x1 - fx) * (fy - y0))[..., None]
                   + sample(x1, y0) * ((fx - x0) * (y1 - fy))[..., None]
                   + sample(x1, y1) * ((fx - x0) * (fy - y0))[..., None])
        return out.movedim(-1, 1)

    return apply_like(f, "grid_sample", x, grid)
