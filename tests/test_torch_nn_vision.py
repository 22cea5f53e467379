"""``affine_grid`` and ``grid_sample`` of the port on both packages
(``port_bodies.run``: within 1e-5 relative and absolute of the JAX
package's): every mode (bilinear, nearest), ``padding_mode`` (zeros,
border, reflection) and ``align_corners`` JAX takes, with the gradients
of the input and of the grid (bilinear) and of theta. Where JAX's
formulas are torch's (zeros and border padding), the values are held to
``torch.nn.functional.grid_sample`` / ``affine_grid`` too.
"""
import numpy as np
import pytest
import torch

from port_bodies import npy, on_cpu, run  # noqa: F401

PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


def _r(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _grid():
    # points inside, on the border and past it (to 1.4), so every padding
    # rule acts
    return _r((2, 5, 6, 2), 1, -1.4, 1.4)


def affine(paddle):
    F = paddle.nn.functional
    theta = _r((2, 2, 3), 0)
    res = {}
    for align in (True, False):
        th = paddle.to_tensor(theta, stop_gradient=False)
        g = F.affine_grid(th, [2, 3, 5, 7], align_corners=align)
        np.testing.assert_allclose(npy(g), torch.nn.functional.affine_grid(
            torch.from_numpy(theta), [2, 3, 5, 7],
            align_corners=align).numpy(), rtol=1e-5, atol=1e-6)
        (g * paddle.to_tensor(_r(g.shape, 9))).sum().backward()
        res[f"grid{align}"] = npy(g)
        res[f"gtheta{align}"] = npy(th.grad)
    return res


def _sample_body(mode, padding):
    def body(paddle):
        F = paddle.nn.functional
        x = _r((2, 3, 4, 5), 2)
        res = {}
        for align in (True, False):
            xt = paddle.to_tensor(x, stop_gradient=False)
            gt = paddle.to_tensor(_grid(), stop_gradient=False)
            out = F.grid_sample(xt, gt, mode=mode, padding_mode=padding,
                                align_corners=align)
            if padding != "reflection":
                np.testing.assert_allclose(
                    npy(out), torch.nn.functional.grid_sample(
                        torch.from_numpy(x), torch.from_numpy(_grid()),
                        mode=mode, padding_mode=padding,
                        align_corners=align).numpy(), rtol=1e-5, atol=1e-5)
            (out * paddle.to_tensor(_r(out.shape, 8))).sum().backward()
            res[f"out{align}"] = npy(out)
            res[f"gx{align}"] = npy(xt.grad)
            if mode == "bilinear":
                res[f"ggrid{align}"] = npy(gt.grad)
        return res

    body.__name__ = f"grid_sample_{mode}_{padding}"
    return body


BODIES = [affine] + [_sample_body(m, p) for m in ("bilinear", "nearest")
                     for p in ("zeros", "border", "reflection")]


@PKG
@pytest.mark.parametrize("body", BODIES, ids=[b.__name__ for b in BODIES])
def test_vision_body(on_cpu, body, pkg):
    run(body, pkg, rtol=1e-5, atol=1e-5)


def test_grid_sample_keeps_the_kind_and_f64(on_cpu):
    """A bare torch tensor in, a torch tensor out; f64 in, f64 out (the
    grid's integer parts taken exactly)."""
    import paddle_tpu_torch as tp

    x = torch.from_numpy(_r((1, 2, 4, 4), 3)).double()
    g = torch.from_numpy(_grid()[:1]).double()
    out = tp.nn.functional.grid_sample(x, g)
    assert type(out) is torch.Tensor and out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), torch.nn.functional.grid_sample(
        x, g, align_corners=True).numpy(), rtol=1e-12, atol=1e-12)


# ----------------------------------------------- interpolate (bicubic, linear)
_RESIZE = {   # (input shape NC..., output size, mode): grow and shrink
    "linear_1d_shrink": ((2, 3, 9), [5], "linear"),
    "linear_1d_grow": ((2, 3, 9), [17], "linear"),
    "bicubic_1d_shrink": ((2, 3, 9), [4], "bicubic"),
    "bicubic_1d_grow": ((2, 3, 9), [20], "bicubic"),
    "bilinear_shrink": ((2, 3, 9, 7), [4, 3], "bilinear"),
    "bicubic_2d_grow": ((2, 3, 9, 7), [13, 15], "bicubic"),
    "bicubic_2d_shrink": ((2, 3, 9, 7), [4, 5], "bicubic"),
    "bicubic_2d_mixed": ((2, 3, 9, 7), [20, 3], "bicubic"),
    "trilinear_shrink": ((1, 2, 6, 7, 8), [3, 3, 4], "trilinear"),
    "trilinear_grow": ((1, 2, 6, 7, 8), [12, 9, 16], "trilinear"),
    "bicubic_3d_mixed": ((1, 2, 6, 7, 8), [3, 9, 4], "bicubic"),
    "area_shrink": ((2, 3, 9, 7), [3, 2], "area"),
}


def _resize_body(name):
    shape, size, mode = _RESIZE[name]

    def body(paddle):
        F = paddle.nn.functional
        x = paddle.to_tensor(_r(shape, 11), stop_gradient=False)
        out = F.interpolate(x, size=size, mode=mode)
        (out * paddle.to_tensor(_r(out.shape, 12))).sum().backward()
        res = {"out": npy(out), "gx": npy(x.grad)}
        if len(shape) == 4:     # channels last, the same resize
            xl = paddle.to_tensor(np.moveaxis(_r(shape, 11), 1, -1))
            res["nhwc"] = npy(F.interpolate(xl, size=size, mode=mode,
                                            data_format="NHWC"))
        return res

    body.__name__ = f"interpolate_{name}"
    return body


RESIZE_BODIES = [_resize_body(n) for n in _RESIZE]


@PKG
@pytest.mark.parametrize("body", RESIZE_BODIES,
                         ids=[b.__name__ for b in RESIZE_BODIES])
def test_interpolate_body(on_cpu, body, pkg):
    """JAX's ``jax.image.resize``: Keys' cubic (a = -0.5) and the linear
    kernel, half-pixel centres, widened by the scale when shrinking, in any
    number of dims (values and input gradients)."""
    run(body, pkg, rtol=1e-5, atol=1e-6)


def test_bicubic_is_not_torchs_kernel(on_cpu):
    """torch's bicubic (a = -0.75) gives other values: the port does not
    call it."""
    import paddle_tpu_torch as tp

    x = torch.from_numpy(_r((1, 1, 6, 6), 13))
    ours = tp.nn.functional.interpolate(x, size=[12, 12], mode="bicubic")
    theirs = torch.nn.functional.interpolate(x, size=[12, 12],
                                             mode="bicubic",
                                             align_corners=False)
    assert float((ours - theirs).abs().max()) > 1e-3
