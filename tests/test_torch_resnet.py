"""ResNet on both packages: ``vision.models.resnet18`` (NCHW and NHWC, f32,
live) and ``resnet50`` (NHWC, f64, marked slow: the JAX model's build and
compiles take ~40 s), 10 classes, B 2 at 64 x 64, built by the JAX
package and carried to the port through ``bridge.from_paddle_tpu_state``
(parameters and batch-norm statistics under the same structured names).

Held to JAX: the training-mode forward's logits and loss, every
parameter's gradient and the batch-norm running statistics it leaves
(JAX's from one jitted ``value_and_grad`` of ``functional_call``, the
statistics from its captured mutations); then two ``TrainStep`` steps of
``Momentum(0.1, 0.9)`` with ``CrossEntropyLoss``: losses, parameters,
velocities and running statistics.

Tolerances. f32: each tensor within 1e-4 relative plus 1e-4 of its
largest magnitude. Both packages run batch norm in f32 and sum in other
orders (about 1e-7 relative a layer); the worst ResNet-18 tensor measured
within 2e-5 of its magnitude. ResNet-50's random-init gradients at B 2
amplify that rounding about 10^5-fold (single elements measured 30% off
in f32, 15% in f64 with f32 statistics), which hides no defect and shows
none; so its leg runs in f64 with batch norm's statistics dtype raised to
f64 on both sides (the port's ``norm._STATS`` and the ``jnp.float32`` the
JAX norm module reads, patched for that leg only), where the two agree to
1e-12 (measured) and are held to 1e-9. Smaller inputs are ill-conditioned
in f32 as well: at 32 x 32 the last stage is 1 x 1 and its batch norm
normalises two values.
"""
import contextlib
import functools

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as port
from paddle_tpu.jit.train import TrainStep as JaxTrainStep
from paddle_tpu_torch import bridge
from paddle_tpu_torch.nn.functional import norm as port_norm
from paddle_tpu_torch.jit import TrainStep
from port_bodies import on_cpu  # noqa: F401

HW = 64
CLASSES = 10
TOL = {"float32": 1e-4, "float64": 1e-9}
CASES = [pytest.param(("resnet18", "NCHW", "float32"), id="resnet18-NCHW"),
         pytest.param(("resnet18", "NHWC", "float32"), id="resnet18-NHWC"),
         pytest.param(("resnet50", "NHWC", "float64"), id="resnet50-NHWC",
                      marks=pytest.mark.slow)]


class _F64Numpy:
    """``jax.numpy`` with ``float32`` meaning float64."""

    float32 = jax.numpy.float64

    def __getattr__(self, name):
        return getattr(jax.numpy, name)


@contextlib.contextmanager
def _stats_dtype(dtype):
    """Within: both packages' batch norm computes in ``dtype`` (f64 for
    the f64 leg; as they are for f32)."""
    if dtype == "float32":
        yield
        return
    from paddle_tpu.nn.functional import norm as jax_norm

    saved = jax_norm.jnp, port_norm._STATS
    jax_norm.jnp, port_norm._STATS = _F64Numpy(), torch.float64
    try:
        yield
    finally:
        jax_norm.jnp, port_norm._STATS = saved


def _batch(fmt, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, HW, HW)).astype(dtype)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return x, np.array([1, 7], np.int64)


def _np(state):
    return {k: np.array(v._value if hasattr(v, "_value") else v)
            for k, v in state.items()}


@functools.lru_cache(maxsize=None)
def _jax_reference(depth, fmt, dtype):
    """The JAX package's numbers for one case (computed once a process)."""
    with _stats_dtype(dtype):
        return _jax_numbers(depth, fmt, dtype)


def _jax_numbers(depth, fmt, dtype):
    paddle.seed(0)
    jm = getattr(paddle.vision.models, depth)(num_classes=CLASSES,
                                              data_format=fmt)
    jm.astype(dtype)
    state0 = _np(jm.state_dict())
    x, y = _batch(fmt, dtype)
    loss_fn = paddle.nn.CrossEntropyLoss()
    names = [n for n, _ in jm.named_parameters()]

    def f(trainable, rest):
        mut = {}
        out = jm.functional_call({**rest, **trainable}, paddle.Tensor(x),
                                 _capture_mutations=mut)
        loss = loss_fn(out, paddle.Tensor(y))
        return loss._value, (out._value, {k: getattr(v, "_value", v)
                                          for k, v in mut.items()})

    raw = jm.raw_state()
    trainable = {k: raw[k] for k in names}
    rest = {k: v for k, v in raw.items() if k not in trainable}
    (loss, (logits, stats)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(trainable, rest)
    opt = paddle.optimizer.Momentum(0.1, 0.9, parameters=jm.parameters())
    step = JaxTrainStep(jm, lambda o, t: loss_fn(o, t), opt)
    losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
              for _ in range(2)]
    exported = step.export_state()
    return dict(state0=state0, loss=float(loss), logits=np.asarray(logits),
                grads=_np(grads), stats=_np(stats), losses=losses,
                after=_np(jm.state_dict()),
                velocity=_np(exported["acc"]["velocity"]))


@pytest.fixture(scope="module", params=CASES)
def case(request):
    depth, fmt, dtype = request.param
    return depth, fmt, dtype, _jax_reference(depth, fmt, dtype)


@pytest.fixture
def stats_dtype(case):
    with _stats_dtype(case[2]):
        yield


def _closer(dtype):
    def close(got, want, where):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert got.shape == want.shape, where
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=TOL[dtype],
                                   atol=TOL[dtype] * scale, err_msg=where)

    return close


def _port_model(depth, fmt, dtype, ref):
    tm = getattr(port.vision.models, depth)(num_classes=CLASSES,
                                            data_format=fmt)
    tm.astype(dtype)
    assert list(tm.state_dict()) == list(ref["state0"])
    return bridge.from_paddle_tpu_state(ref["state0"], tm)


def test_forward_gradients_and_statistics_match_jax(on_cpu, case,
                                                    stats_dtype):
    depth, fmt, dtype, ref = case
    _close = _closer(dtype)
    tm = _port_model(depth, fmt, dtype, ref)
    x, y = _batch(fmt, dtype)
    logits = tm(port.to_tensor(x))
    loss = port.nn.CrossEntropyLoss()(logits, port.to_tensor(y))
    loss.backward()
    _close(logits.numpy(), ref["logits"], "logits")
    _close(loss.numpy(), ref["loss"], "loss")
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert grads.keys() == ref["grads"].keys()
    for n, g in grads.items():
        _close(g, ref["grads"][n], f"grad {n}")
    state = tm.state_dict()
    assert ref["stats"] and all(k.endswith(("_mean", "_variance"))
                                for k in ref["stats"])
    for k, v in ref["stats"].items():
        _close(state[k].numpy(), v, k)


def test_two_momentum_train_steps_match_jax(on_cpu, case, stats_dtype):
    depth, fmt, dtype, ref = case
    _close = _closer(dtype)
    tm = _port_model(depth, fmt, dtype, ref)
    opt = port.optimizer.Momentum(0.1, 0.9, parameters=tm.parameters())
    loss_fn = port.nn.CrossEntropyLoss()
    step = TrainStep(tm, lambda o, t: loss_fn(o, t), opt)
    x, y = (port.to_tensor(a) for a in _batch(fmt, dtype))
    losses = [float(step(x, y)) for _ in range(2)]
    np.testing.assert_allclose(losses, ref["losses"], rtol=TOL[dtype])
    after = tm.state_dict()
    for k, v in ref["after"].items():
        _close(after[k].numpy(), v, k)
    velocity = step.export_state()["acc"]["velocity"]
    assert velocity.keys() == ref["velocity"].keys()
    for k, v in ref["velocity"].items():
        _close(velocity[k].numpy(), v, f"velocity {k}")
