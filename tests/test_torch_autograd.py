"""The bodies of ``tests/test_autograd.py`` on both packages: the JAX
package's tape and the PyTorch port, whose autograd is torch's behind the
paddle-style Tensor (on the CPU); each body's results on the port held to
the JAX package's (``port_bodies.run``).

``softmax_ce_grad_matches_numeric`` writes the cross entropy with the op
layer (log-sum-exp less the label's logit): ``nn.functional
.cross_entropy`` joins the port with the nn surface (ROADMAP A6). The
seam test holds ``F.flash_attention`` / ``F.flashmask_attention`` called
on Tensors to ``jax.grad`` of the JAX package's ``_sdpa_core`` (the
reference the flash tests use) at ``gpt_tiny`` width, and ``PyLayer`` to
``test_pylayer``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu_torch as port
from paddle_tpu.nn.functional.flash_attention import _sdpa_core
from port_bodies import npy, on_cpu, run  # noqa: F401

PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


def numeric_grad(fn, x, eps=1e-3):
    x = np.asarray(x, np.float64)
    g = np.zeros_like(x)
    for i in np.ndindex(x.shape):
        xp = x.copy()
        xp[i] += eps
        xm = x.copy()
        xm[i] -= eps
        g[i] = (fn(xp) - fn(xm)) / (2 * eps)
    return g


def simple_backward(paddle):
    x = paddle.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    (x * x).sum().backward()
    np.testing.assert_allclose(npy(x.grad), [2, 4, 6])
    return {"g": npy(x.grad)}


def chain(paddle):
    x = paddle.to_tensor([0.5, 1.0], stop_gradient=False)
    paddle.exp(paddle.sin(x)).sum().backward()
    want = np.cos([0.5, 1.0]) * np.exp(np.sin([0.5, 1.0]))
    np.testing.assert_allclose(npy(x.grad), want, rtol=1e-5)
    return {"g": npy(x.grad)}


def branching_graph(paddle):
    x = paddle.to_tensor([2.0], stop_gradient=False)
    (x * 3.0 + x * 5.0).sum().backward()
    np.testing.assert_allclose(npy(x.grad), [8.0])
    return {"g": npy(x.grad)}


def matmul_grad(paddle):
    rng = np.random.default_rng(2)
    a_np = rng.standard_normal((3, 4)).astype(np.float32)
    b_np = rng.standard_normal((4, 2)).astype(np.float32)
    a = paddle.to_tensor(a_np, stop_gradient=False)
    b = paddle.to_tensor(b_np, stop_gradient=False)
    (a @ b).sum().backward()
    np.testing.assert_allclose(npy(a.grad), np.ones((3, 2)) @ b_np.T,
                               rtol=1e-5)
    np.testing.assert_allclose(npy(b.grad), a_np.T @ np.ones((3, 2)),
                               rtol=1e-5)
    return {"ga": npy(a.grad), "gb": npy(b.grad)}


def grad_accumulation(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    (x * 2).sum().backward()
    (x * 3).sum().backward()
    g = npy(x.grad)
    np.testing.assert_allclose(g, [5.0])
    x.clear_grad()
    assert x.grad is None
    return {"g": g}


def no_grad(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    with paddle.no_grad():
        y = x * 2
    assert y.stop_gradient and not x.stop_gradient
    return {"y": npy(y)}


def detach(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    assert (x * 2).detach().stop_gradient
    z = x * 2
    (z + z.detach()).sum().backward()
    np.testing.assert_allclose(npy(x.grad), [2.0])
    return {"g": npy(x.grad)}


def paddle_grad_api(paddle):
    x = paddle.to_tensor([3.0], stop_gradient=False)
    (gx,) = paddle.grad(x * x, x)
    np.testing.assert_allclose(npy(gx), [6.0])
    assert x.grad is None
    return {"g": npy(gx)}


def multi_output_op_grad(paddle):
    x = paddle.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3),
                         stop_gradient=False)
    parts = paddle.split(x, 3, axis=1)
    (parts[0] * 1 + parts[2] * 3).sum().backward()
    np.testing.assert_allclose(npy(x.grad), [[1, 0, 3], [1, 0, 3]])
    return {"g": npy(x.grad)}


def softmax_ce_grad_matches_numeric(paddle):
    logits_np = np.random.default_rng(3).standard_normal((4, 5))
    labels_np = np.array([0, 2, 1, 4])

    def f(v):
        e = np.exp(v - v.max(-1, keepdims=True))
        p = e / e.sum(-1, keepdims=True)
        return -np.log(p[np.arange(4), labels_np]).mean()

    x = paddle.to_tensor(logits_np.astype(np.float32), stop_gradient=False)
    picked = paddle.take_along_axis(
        x, paddle.to_tensor(labels_np.reshape(4, 1)), axis=1)
    loss = (paddle.logsumexp(x, axis=1) - picked.reshape([4])).mean()
    loss.backward()
    np.testing.assert_allclose(npy(x.grad), numeric_grad(f, logits_np),
                               atol=1e-3)
    return {"loss": npy(loss), "g": npy(x.grad)}


def register_hook(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    x.register_hook(lambda g: g * 10)
    (x * 2).sum().backward()
    np.testing.assert_allclose(npy(x.grad), [20.0])
    return {"g": npy(x.grad)}


def pylayer(paddle):
    class Double(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2

        @staticmethod
        def backward(ctx, grad):
            (x,) = ctx.saved_tensor()
            return grad * 2 + x * 0

    x = paddle.to_tensor([3.0], stop_gradient=False)
    y = Double.apply(x)
    y.sum().backward()
    np.testing.assert_allclose(npy(y), [6.0])
    np.testing.assert_allclose(npy(x.grad), [2.0])
    return {"y": npy(y), "g": npy(x.grad)}


def backward_twice_raises(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    y = (x * x).sum()
    y.backward()
    with pytest.raises(RuntimeError):
        y.backward()
    return {"g": npy(x.grad)}


def retain_graph(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    y = (x * x).sum()
    y.backward(retain_graph=True)
    y.backward()
    np.testing.assert_allclose(npy(x.grad), [4.0])
    return {"g": npy(x.grad)}


BODIES = [simple_backward, chain, branching_graph, matmul_grad,
          grad_accumulation, no_grad, detach, paddle_grad_api,
          multi_output_op_grad, softmax_ce_grad_matches_numeric,
          register_hook, pylayer, backward_twice_raises, retain_graph]


@PKG
@pytest.mark.parametrize("body", BODIES, ids=[b.__name__ for b in BODIES])
def test_autograd_body(on_cpu, body, pkg):
    run(body, pkg)


def test_stop_gradient_on_an_intermediate_cuts_the_graph(on_cpu):
    """Setting stop_gradient on an intermediate cuts the graph there, as
    the JAX tape does; an in-place op on a leaf that needs a gradient runs
    out of place and the graph runs on through it."""
    x = port.to_tensor([2.0], stop_gradient=False)
    y = x * 3
    y.stop_gradient = True
    (y * x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [6.0])     # only through x
    w = port.to_tensor([1.0, 2.0], stop_gradient=False)
    w.add_(port.to_tensor([1.0, 1.0]))
    (w * w).sum().backward()
    assert not w.stop_gradient and w.grad is None        # w is not a leaf
    leaf = port.to_tensor([1.0, 2.0], stop_gradient=False)
    (leaf * 1).sum().backward()
    g = leaf.grad
    with port.no_grad():
        leaf.subtract_(leaf.grad * 0.5)      # an optimizer's update
    assert leaf.is_leaf and not leaf.stop_gradient
    np.testing.assert_allclose(leaf.numpy(), [0.5, 1.5])
    np.testing.assert_allclose(leaf.grad.numpy(), g.numpy())
    v = port.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    u = v * 1
    u[1] = 10.0                                            # index_put
    (u * u).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), [2.0, 0.0, 6.0])


def test_to_tensor_without_cuda_raises_unless_the_cpu_was_asked_for():
    import torch

    from paddle_tpu_torch.framework import device as dev

    if torch.cuda.is_available():
        pytest.skip("the refusal is for machines without CUDA")
    prev = dev._current["place"]
    dev._current["place"] = None
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.to_tensor([1.0])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.zeros([2])
        assert port.to_tensor([1.0], place="cpu").place.is_cpu_place()
        with pytest.raises(RuntimeError):
            port.TPUPlace()
    finally:
        dev._current["place"] = prev


# ------------------------------------------------------------------ seam
def _jax_sdpa_grads(q, k, v, causal, mask=None):
    def loss(q, k, v):
        out = _sdpa_core(q, k, v, mask, q.shape[-1] ** -0.5, causal, 0.0,
                         False)
        return (out * W).sum(), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


W = None


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_on_tensors_matches_jax_grad(on_cpu, causal):
    """gpt_tiny width (B 2, S 16, H 4, D 16): the output and the .grad of
    q, k and v of ``F.flash_attention`` called on Tensors, held to
    ``jax.grad`` of ``_sdpa_core`` on f64 inputs at 1e-5: the JAX
    reference takes its softmax in f32 (unit roundoff 6e-8 on values and
    gradients of order 1, over 16 columns)."""
    global W
    rng = np.random.default_rng(4)
    q, k, v, W = (rng.standard_normal((2, 16, 4, 16)) for _ in range(4))
    out, grads = _jax_sdpa_grads(q, k, v, causal)
    ts = [port.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
    got = port.nn.functional.flash_attention(*ts, causal=causal)
    got = got[0] if isinstance(got, tuple) else got
    assert isinstance(got, port.Tensor)
    (got * port.to_tensor(W)).sum().backward()
    np.testing.assert_allclose(got.numpy(), out, atol=1e-5)
    for t, g in zip(ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), g, atol=1e-5)


def test_flashmask_attention_on_tensors_matches_jax_grad(on_cpu):
    """Two causal documents of 8 rows (FlashMask start rows [B, 1, S, 1]):
    the JAX reference is ``_sdpa_core`` under the equivalent boolean
    mask."""
    global W
    rng = np.random.default_rng(5)
    q, k, v, W = (rng.standard_normal((2, 16, 4, 16)) for _ in range(4))
    ends = np.where(np.arange(16) < 8, 8, 16)
    sri = np.broadcast_to(ends[None, None, :, None], (2, 1, 16, 1))
    rows, cols = np.arange(16)[:, None], np.arange(16)[None, :]
    allowed = (cols <= rows) & (rows < ends[cols])       # [q row, k col]
    out, grads = _jax_sdpa_grads(q, k, v, False,
                                 jnp.asarray(allowed[None, None]))
    ts = [port.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
    got = port.nn.functional.flashmask_attention(
        *ts, port.to_tensor(sri.astype(np.int32)), causal=True)
    (got * port.to_tensor(W)).sum().backward()
    np.testing.assert_allclose(got.numpy(), out, atol=1e-5)
    for t, g in zip(ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), g, atol=1e-5)
