"""Batch norm on both packages: the four bodies of
``tests/test_batch_norm_vjp.py`` (the fused residual-add + relu form
against the composed one, gradients and running statistics; the exact
two-pass variance of a large-mean input; ``act`` validation; a bf16 input
with an f32 residual keeping each gradient's dtype), each held to the JAX
package's results (``port_bodies.run``, f32 within 1e-5 relative and
1e-5 absolute: the absolute bound of the JAX test's own fused-against-
composed check, since without ``act`` the loss sum(bn(x)^2) is constant
in x up to rounding and x's gradient is f32 cancellation noise of that
size), and the port's running statistics, eval path, channels-last layout
and in-place updates.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as port
from port_bodies import dname, npy, on_cpu, run  # noqa: F401

PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


def _grads(fn, *tensors):
    loss = fn()
    loss.backward()
    out = [npy(t.grad) for t in tensors]
    for t in tensors:
        t.clear_grad()
    return npy(loss), out


def _vjp_body(with_residual, act):
    def body(paddle):
        nn, F = paddle.nn, paddle.nn.functional
        bn = nn.BatchNorm2D(6)
        bn.train()
        rs = np.random.RandomState(0)
        x = paddle.to_tensor(rs.randn(4, 6, 5, 5).astype("float32"),
                             stop_gradient=False)
        res = (paddle.to_tensor(rs.randn(4, 6, 5, 5).astype("float32"),
                                stop_gradient=False)
               if with_residual else None)

        def fused():
            out = bn.forward_fused(x, residual=res, act=act)
            return paddle.sum(out * out)

        tensors = [x] + ([res] if res is not None else []) + [bn.weight,
                                                               bn.bias]
        loss_f, grads_f = _grads(fused, *tensors)
        bn2 = nn.BatchNorm2D(6)
        bn2.train()

        def composed():
            out = bn2(x)
            if res is not None:
                out = out + res
            if act == "relu":
                out = F.relu(out)
            return paddle.sum(out * out)

        tensors2 = [x] + ([res] if res is not None else []) + [bn2.weight,
                                                                bn2.bias]
        loss_c, grads_c = _grads(composed, *tensors2)
        np.testing.assert_allclose(loss_f, loss_c, rtol=1e-5)
        for gf, gc in zip(grads_f, grads_c):
            np.testing.assert_allclose(gf, gc, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(npy(bn._mean), npy(bn2._mean), rtol=1e-5)
        np.testing.assert_allclose(npy(bn._variance), npy(bn2._variance),
                                   rtol=1e-4)
        return {"loss": loss_f, "mean": npy(bn._mean),
                "var": npy(bn._variance),
                **{f"g{i}": g for i, g in enumerate(grads_f)}}

    body.__name__ = f"vjp_residual{int(with_residual)}_{act}"
    return body


def large_mean_no_cancellation(paddle):
    bn = paddle.nn.BatchNorm2D(3)
    bn.train()
    rs = np.random.RandomState(0)
    x = paddle.to_tensor(
        (1000.0 + 0.01 * rs.randn(64, 3, 8, 8)).astype("float32"))
    out = npy(bn(x))
    np.testing.assert_allclose(out.std(), 1.0, rtol=0.05)
    rv = npy(bn._variance)
    assert (rv > 1e-6).all(), rv
    return {"std": np.asarray(out.std()), "var": rv}


def act_validation(paddle):
    bn = paddle.nn.BatchNorm2D(3)
    bn.train()
    x = paddle.to_tensor(np.ones((2, 3, 4, 4), "float32"))
    with pytest.raises(ValueError, match="act"):
        bn.forward_fused(x, act="relu6")
    return {}


def residual_grad_dtype_preserved(paddle):
    bn = paddle.nn.BatchNorm2D(3)
    bn.train()
    rs = np.random.RandomState(0)
    x = paddle.to_tensor(rs.randn(2, 3, 4, 4).astype("float32"),
                         stop_gradient=False).astype("bfloat16")
    x = x.detach()
    x.stop_gradient = False
    res = paddle.to_tensor(rs.randn(2, 3, 4, 4).astype("float32"),
                           stop_gradient=False)
    out = bn.forward_fused(x, residual=res, act="relu")
    paddle.sum(paddle.cast(out, "float32")).backward()
    return {"res": dname(res.grad), "x": dname(x.grad), "out": dname(out)}


def running_stats_and_eval(paddle):
    """Three training steps at momentum 0.8, channels-last and first, then
    the eval forward on the running statistics."""
    rs = np.random.RandomState(3)
    out = {}
    for fmt in ("NCHW", "NHWC"):
        bn = paddle.nn.BatchNorm2D(5, momentum=0.8, data_format=fmt)
        bn.train()
        for _ in range(3):
            x = rs.randn(4, 5, 3, 3).astype("float32") * 2 + 1
            x = x if fmt == "NCHW" else x.transpose(0, 2, 3, 1)
            bn(paddle.to_tensor(np.ascontiguousarray(x)))
        bn.eval()
        y = npy(bn(paddle.to_tensor(np.ascontiguousarray(x))))
        out.update({f"{fmt}_mean": npy(bn._mean),
                    f"{fmt}_var": npy(bn._variance), f"{fmt}_eval": y})
    return out


BODIES = ([_vjp_body(r, a) for r, a in ((False, None), (False, "relu"),
                                        (True, "relu"), (True, None))]
          + [large_mean_no_cancellation, act_validation,
             residual_grad_dtype_preserved, running_stats_and_eval])


@PKG
@pytest.mark.parametrize("body", BODIES, ids=[b.__name__ for b in BODIES])
def test_batch_norm_body(on_cpu, body, pkg):
    run(body, pkg, atol=1e-5)


def test_running_stats_written_in_place_in_their_dtype(on_cpu):
    """The update lands in the buffers' own storage (what a captured step
    replays into), f32 under a bf16 input, and paddle's momentum keeps:
    0.9 * old + 0.1 * batch, the variance unbiased by n / (n - 1)."""
    bn = port.nn.BatchNorm2D(2)
    mean_t, var_t = bn._buffers["_mean"], bn._buffers["_variance"]
    ptrs = (mean_t.data_ptr(), var_t.data_ptr())
    x = np.random.default_rng(0).standard_normal((3, 2, 4, 4)).astype(
        np.float32)
    bn(port.to_tensor(x).astype("bfloat16"))
    assert (mean_t.data_ptr(), var_t.data_ptr()) == ptrs
    assert mean_t.dtype == var_t.dtype == torch.float32
    xb = torch.from_numpy(x).bfloat16().float().numpy()
    n = 3 * 4 * 4
    np.testing.assert_allclose(mean_t.numpy(), 0.1 * xb.mean((0, 2, 3)),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        var_t.numpy(), 0.9 + 0.1 * xb.var((0, 2, 3)) * n / (n - 1),
        rtol=1e-5)
    assert bn._mean._value is mean_t


def test_torch_tensors_in_torch_tensors_out(on_cpu):
    bn = port.nn.BatchNorm2D(2)
    x = torch.randn(2, 2, 3, 3, requires_grad=True)
    y = bn(x)
    assert type(y) is torch.Tensor
    y.sum().backward()
    assert x.grad is not None and bn.weight.grad is not None
