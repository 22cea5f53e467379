"""``nn.Layer``, ``nn.Parameter`` and ``nn.ParamAttr`` on both packages:
each body runs on the JAX package and on the PyTorch port (on the CPU),
and the port's results are held to the JAX package's
(``port_bodies.run``; f32 values within 1e-5 relative, 1e-6 absolute:
the same f32 operations in another order).

The bodies cover structured names and ``state_dict`` (parameters, then
persistable buffers), ``set_state_dict``, forward hooks, ``train`` /
``eval``, ``astype``, ``create_parameter`` with a ``ParamAttr``, the
global initializer, traversal, and the per-parameter learning rate and
regularizer in the eager step and in ``TrainStep``. Weights are carried
across by ``set_state_dict`` from numpy: the two packages' random draws
differ.
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu_torch as port
from port_bodies import dname, npy, on_cpu, run  # noqa: F401

PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


class L2:
    """A regularizer object as the optimizers read one (``_coeff``)."""

    def __init__(self, coeff):
        self._coeff = coeff


def _net(paddle):
    nn = paddle.nn
    return nn.Sequential(
        nn.Conv2D(3, 4, 3, padding=1, bias_attr=False),
        nn.BatchNorm2D(4), nn.ReLU(), nn.AdaptiveAvgPool2D(1), nn.Flatten(),
        nn.Linear(4, 5))


def _fill(net, seed=0):
    """Every state entry set from one numpy draw (variances positive)."""
    rng = np.random.default_rng(seed)
    state = {}
    for k, t in net.state_dict().items():
        v = rng.standard_normal(t.shape).astype(np.float32)
        state[k] = np.abs(v) + 0.5 if k.endswith("_variance") else v
    net.set_state_dict(state)
    return state


def _x(shape=(2, 3, 6, 6), seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def names_and_state_dict(paddle):
    net = _net(paddle)
    sd = net.state_dict()
    names = [n for n, _ in net.named_parameters()]
    assert list(sd)[:len(names)] == names
    w = net[0].weight
    assert w.shape == [4, 3, 3, 3] and isinstance(w.shape, list)
    assert w.stop_gradient is False and w.trainable
    assert net[1]._mean.stop_gradient is True
    return {"keys": tuple(sd), "shapes": tuple(tuple(t.shape)
                                               for t in sd.values()),
            "dtypes": tuple(dname(t) for t in sd.values()),
            "n_params": len(net.parameters()),
            "n_buffers": len(net.buffers()),
            "sublayers": tuple(type(m).__name__ for m in net.sublayers()),
            "children": len(list(net.children()))}


def set_state_dict_roundtrip(paddle):
    net = _net(paddle)
    state = _fill(net)
    missing, unexpected = net.set_state_dict({**state, "extra": np.ones(2)})
    net.eval()
    out = net(paddle.to_tensor(_x()))
    other = _net(paddle)
    other.set_state_dict({k: npy(v) for k, v in net.state_dict().items()})
    other.eval()
    np.testing.assert_allclose(npy(other(paddle.to_tensor(_x()))),
                               npy(out), rtol=1e-6, atol=1e-6)
    return {"out": npy(out), "missing": tuple(missing),
            "unexpected": tuple(unexpected)}


def hooks(paddle):
    lin = paddle.nn.Linear(3, 2)
    _fill(lin)
    calls = []

    def pre(layer, inputs):
        calls.append("pre")
        return (inputs[0] * 2.0,)

    def post(layer, inputs, outputs):
        calls.append("post")
        return outputs + 1.0

    h1 = lin.register_forward_pre_hook(pre)
    h2 = lin.register_forward_post_hook(post)
    x = paddle.to_tensor(_x((4, 3)))
    hooked = lin(x)
    h1.remove()
    h2.remove()
    plain = lin(x)
    return {"hooked": npy(hooked), "plain": npy(plain),
            "calls": tuple(calls)}


def train_eval(paddle):
    net = paddle.nn.Sequential(paddle.nn.Linear(3, 3),
                               paddle.nn.Dropout(0.5))
    modes = [net.training, net[1].training]
    net.eval()
    modes += [net.training, net[1].training]
    x = paddle.to_tensor(_x((4, 3)))
    _fill(net)
    out = net(x)
    net.train()
    modes += [net.training, net[1].training]
    return {"modes": tuple(modes), "eval_out": npy(out)}


def astype_casts(paddle):
    net = _net(paddle)
    net.astype("float64")
    new = net[5].create_parameter([2])
    return {"dtypes": tuple(dname(t) for t in net.state_dict().values()),
            "new": dname(new)}


def create_parameter_attrs(paddle):
    nn = paddle.nn
    layer = nn.Layer()
    attr = nn.ParamAttr(name="w", initializer=nn.initializer.Constant(0.5),
                        learning_rate=0.25, regularizer=L2(0.1),
                        trainable=False, need_clip=False)
    p = layer.create_parameter([2, 3], attr=attr)
    b = layer.create_parameter([3], is_bias=True)
    none = layer.create_parameter([3], attr=False)
    c = layer.create_parameter(
        [2], default_initializer=nn.initializer.Constant(2.0))
    nn.initializer.set_global_initializer(nn.initializer.Constant(3.0),
                                          nn.initializer.Constant(4.0))
    try:
        gw = layer.create_parameter([2])
        gb = layer.create_parameter([2], is_bias=True)
    finally:
        nn.initializer.set_global_initializer(None)
    made = paddle.create_parameter([2, 2], "float64")
    return {"p": npy(p), "lr": p.optimize_attr["learning_rate"],
            "reg": p.regularizer._coeff, "trainable": p.trainable,
            "sg": p.stop_gradient, "need_clip": p.need_clip, "b": npy(b),
            "none": none is None, "c": npy(c), "gw": npy(gw), "gb": npy(gb),
            "made": dname(made), "made_sg": made.stop_gradient,
            "reset": paddle.nn.initializer.get_global_initializer()
            == (None, None)}


def traversal_and_grads(paddle):
    net = _net(paddle)
    _fill(net)
    seen = []
    net.apply(lambda m: seen.append(type(m).__name__))
    out = net(paddle.to_tensor(_x()))
    out.sum().backward()
    grads = {n: npy(p.grad) for n, p in net.named_parameters()}
    net.clear_gradients()
    cleared = all(p.grad is None for p in net.parameters())
    return {"seen": tuple(seen), "full_name": net[5].full_name(),
            "cleared": cleared, **{f"g:{k}": v for k, v in grads.items()}}


def _lr_net(paddle):
    nn = paddle.nn
    lin = nn.Linear(4, 3, weight_attr=nn.ParamAttr(learning_rate=0.5),
                    bias_attr=nn.ParamAttr(regularizer=L2(0.2)))
    out = nn.Linear(3, 2, weight_attr=nn.ParamAttr(learning_rate=2.0,
                                                   regularizer=L2(0.05)))
    net = nn.Sequential(lin, nn.ReLU(), out)
    _fill(net, seed=3)
    return net


def _loss(paddle, net, x, y):
    return paddle.nn.functional.mse_loss(net(x), y)


def per_param_eager(paddle):
    net = _lr_net(paddle)
    opt = paddle.optimizer.Momentum(0.1, 0.9, parameters=net.parameters(),
                                    weight_decay=L2(0.01))
    x, y = (paddle.to_tensor(a) for a in (_x((5, 4), 4), _x((5, 2), 5)))
    for _ in range(2):
        _loss(paddle, net, x, y).backward()
        opt.step()
        opt.clear_grad()
    return {k: npy(v) for k, v in net.state_dict().items()}


def per_param_train_step(paddle):
    net = _lr_net(paddle)
    opt = paddle.optimizer.SGD(0.1, parameters=net.parameters(),
                               weight_decay=0.01)
    train = importlib.import_module(paddle.__name__ + ".jit.train")
    step = train.TrainStep(net, lambda o, y: paddle.nn.functional.mse_loss(
        o, y), opt)
    x, y = (paddle.to_tensor(a) for a in (_x((5, 4), 4), _x((5, 2), 5)))
    losses = [float(step(x, y)) for _ in range(2)]
    return {"losses": np.asarray(losses),
            **{k: npy(v) for k, v in net.state_dict().items()}}


def adamw_regularizer_object(paddle):
    net = _lr_net(paddle)
    opt = paddle.optimizer.AdamW(0.01, parameters=net.parameters(),
                                 weight_decay=L2(0.1))
    x, y = (paddle.to_tensor(a) for a in (_x((5, 4), 4), _x((5, 2), 5)))
    _loss(paddle, net, x, y).backward()
    opt.step()
    return {k: npy(v) for k, v in net.state_dict().items()}


BODIES = [names_and_state_dict, set_state_dict_roundtrip, hooks, train_eval,
          astype_casts, create_parameter_attrs, traversal_and_grads,
          per_param_eager, per_param_train_step, adamw_regularizer_object]


@PKG
@pytest.mark.parametrize("body", BODIES, ids=[b.__name__ for b in BODIES])
def test_layer_body(on_cpu, body, pkg):
    run(body, pkg)


def test_parameter_is_a_view_of_the_torch_parameter(on_cpu):
    """One storage: the wrapper's ``_value`` is the registered
    ``torch.nn.Parameter``; writes through either side are seen by the
    other, and the wrapper keeps its identity and attributes."""
    lin = port.nn.Linear(3, 2)
    w = lin.weight
    tp = lin._parameters["weight"]
    assert w._value is tp and isinstance(tp, torch.nn.Parameter)
    w.optimize_attr["learning_rate"] = 0.5
    w.set_value(np.ones((3, 2), np.float32))
    assert tp.data_ptr() == w._value.data_ptr() and bool((tp == 1).all())
    with torch.no_grad():
        tp.mul_(3.0)
    np.testing.assert_array_equal(lin.weight.numpy(), 3.0)
    assert lin.weight is w and w.optimize_attr["learning_rate"] == 0.5
    assert dict(torch.nn.Module.named_parameters(lin))["weight"] is tp
    assert lin.state_dict(keep_vars=True)["weight"] is tp
    lin.to(dtype="float64")
    assert lin.weight is w and w._value is tp and tp.dtype == torch.float64


def test_layers_inside_a_torch_module_stay_torch(on_cpu):
    """A torch module holding port layers (as GPT, LLaMA and BERT do)
    sees torch parameters and gets torch tensors back."""
    holder = torch.nn.Module()
    holder.norm = port.nn.LayerNorm(4, device="cpu")
    holder.emb = port.nn.Embedding(6, 4, device="cpu")
    params = dict(holder.named_parameters())
    assert set(params) == {"norm.weight", "norm.bias", "emb.weight"}
    assert all(type(p) is torch.nn.Parameter for p in params.values())
    out = holder.norm(holder.emb(torch.tensor([[1, 2]])))
    assert type(out) is torch.Tensor and out.shape == (1, 2, 4)
    assert set(holder.state_dict()) == set(params)


def test_deepcopy_keeps_attributes_and_unties_storage(on_cpu):
    import copy

    lin = port.nn.Linear(3, 2, weight_attr=port.nn.ParamAttr(
        learning_rate=0.5))
    twin = copy.deepcopy(lin)
    assert twin.weight.optimize_attr["learning_rate"] == 0.5
    assert twin.weight._value is twin._parameters["weight"]
    assert twin.weight._value.data_ptr() != lin.weight._value.data_ptr()
    np.testing.assert_array_equal(twin.weight.numpy(), lin.weight.numpy())
