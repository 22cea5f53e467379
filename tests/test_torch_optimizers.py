"""The port's other optimizers (``paddle_tpu_torch/optimizer``: Adamax,
Adagrad, Adadelta, RMSProp, Lamb, ASGD, Rprop, NAdam, RAdam, and eager
LBFGS) held against the JAX package's on the CPU.

* Eager: the same f32 parameters and the same five seeded gradients go
  through ``step()`` on both sides; parameters after each step within
  1e-6 absolute + 1e-5 relative (the same formulas in another framework:
  transcendental functions and sums may round apart).
* Captured: a two-layer MLP (the same numpy init) trains five steps
  through ``jit.TrainStep`` (whose CPU body is the step CUDA captures) and
  JAX's TrainStep; losses within 1e-5 relative and parameters as above in
  f32; in bf16 (``decorate(level="O2")``, every parameter updated in its own
  dtype with the counter and rate as f32 scalars) within 2^-6 relative +
  2^-7 absolute: bf16 roundings (spacing 2^-8 below 1) placed differently
  by XLA's excess precision, compounded over five steps (measured: one
  spacing after the first step, up to two after the fifth). Two cases are
  held in f32 only, since a bf16 rounding there moves the result by a step,
  not by a rounding: Rprop steps by the sign of g * prev, which flips for
  a gradient near 0, and centered RMSProp divides by sqrt(ms - mg^2), a
  difference of two bf16 values that cancels after the first steps.
* ``TrainStep(LBFGS)`` raises: LBFGS evaluates a closure on the host.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.train import TrainStep as JaxTrainStep
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2 ** -6, atol=2 ** -7)
SHAPES = [(4, 3), (3,)]

# name -> constructor keywords (both packages take the same names)
OPTIMIZERS = {
    "Adamax": dict(learning_rate=0.01),
    "Adagrad": dict(learning_rate=0.1),
    "Adadelta": dict(learning_rate=1.0),
    "RMSProp": dict(learning_rate=0.01),
    "RMSProp_centered_momentum": dict(learning_rate=0.01, momentum=0.9,
                                      centered=True),
    "Lamb": dict(learning_rate=0.01),
    "ASGD": dict(learning_rate=0.05, batch_num=3),
    "Rprop": dict(learning_rate=0.01),
    "NAdam": dict(learning_rate=0.01),
    "RAdam": dict(learning_rate=0.01),
    "Adadelta_l2": dict(learning_rate=1.0, weight_decay=0.01),
}


def _cls(name):
    return name.split("_")[0]


def _eager_data(seed=0, steps=5):
    rng = np.random.default_rng(seed)
    w0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]
    return w0, grads


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_eager_step_matches_jax(name):
    w0, grads = _eager_data()
    jp = [paddle.to_tensor(w, stop_gradient=False) for w in w0]
    tp = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in w0]
    jo = getattr(paddle.optimizer, _cls(name))(parameters=jp,
                                               **OPTIMIZERS[name])
    to = getattr(topt, _cls(name))(parameters=tp, **OPTIMIZERS[name])
    for i, g in enumerate(grads):
        for p, gv in zip(jp, g):
            p.grad = paddle.to_tensor(gv)
        jo.step()
        for p, gv in zip(tp, g):
            p.grad = torch.from_numpy(gv.copy())
        to.step()
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(
                a.numpy()), err_msg=f"step {i}", **F32)
    assert to._step_count == 5
    moved = max(float(np.abs(b.detach().numpy() - w).max())
                for b, w in zip(tp, w0))
    assert moved > 1e-4


def test_eager_lbfgs_matches_jax():
    w0, grads = _eager_data(seed=1)
    jp = [paddle.to_tensor(w, stop_gradient=False) for w in w0]
    tp = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in w0]
    jo = paddle.optimizer.LBFGS(learning_rate=0.1, parameters=jp,
                                history_size=3)
    to = topt.LBFGS(learning_rate=0.1, parameters=tp, history_size=3)
    for i, g in enumerate(grads):
        def jclosure(g=g):
            for p, gv in zip(jp, g):
                p.grad = paddle.to_tensor(gv)
            return 1.0

        def tclosure(g=g):
            for p, gv in zip(tp, g):
                p.grad = torch.from_numpy(gv.copy())
            return 1.0

        assert jo.step(jclosure) == to.step(tclosure) == 1.0
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(
                a.numpy()), err_msg=f"step {i}", **F32)
    assert len(to._history) == len(jo._history) == 3
    with pytest.raises(ValueError, match="closure"):
        to.step()


class _Lin(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.bias = torch.nn.Parameter(torch.from_numpy(b.copy()))

    def forward(self, x):
        return x @ self.weight + self.bias


def _mlp_pair(seed=0):
    rng = np.random.default_rng(seed)
    w = {"0.weight": rng.standard_normal((8, 16)).astype(np.float32) * .4,
         "0.bias": rng.standard_normal(16).astype(np.float32) * .1,
         "2.weight": rng.standard_normal((16, 4)).astype(np.float32) * .4,
         "2.bias": rng.standard_normal(4).astype(np.float32) * .1}
    with paddle.utils.unique_name.guard():
        jm = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.Tanh(),
                                  paddle.nn.Linear(16, 4))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in w.items()})
    tm = torch.nn.Sequential(_Lin(w["0.weight"], w["0.bias"]),
                             torch.nn.Tanh(),
                             _Lin(w["2.weight"], w["2.bias"]))
    return jm, tm


def _mse(out, y):
    return ((out - y) ** 2).mean()


# the cases whose update moves continuously with a rounding (see above)
CONTINUOUS = sorted(set(OPTIMIZERS) - {"Rprop", "RMSProp_centered_momentum"})


@pytest.mark.parametrize("name, dtype", [(n, "float32")
                                         for n in sorted(OPTIMIZERS)]
                         + [(n, "bfloat16") for n in CONTINUOUS])
def test_train_step_matches_jax(name, dtype):
    jm, tm = _mlp_pair()
    jo = getattr(paddle.optimizer, _cls(name))(parameters=jm.parameters(),
                                               **OPTIMIZERS[name])
    to = getattr(topt, _cls(name))(parameters=tm.parameters(),
                                   **OPTIMIZERS[name])
    if dtype == "bfloat16":
        paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
        tamp.decorate(tm, level="O2", dtype="bfloat16")
    jstep = JaxTrainStep(jm, _mse, jo, split_label=True)
    tstep = TrainStep(tm, _mse, to, split_label=True)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    y = rng.standard_normal((6, 4)).astype(np.float32)
    td = getattr(torch, dtype)
    jl, tl = [], []
    for _ in range(5):
        jl.append(float(jstep(paddle.to_tensor(x).astype(dtype),
                              paddle.to_tensor(y).astype(dtype))
                        .astype("float32")))
        tl.append(float(tstep(torch.from_numpy(x).to(td),
                              torch.from_numpy(y).to(td)).float()))
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(tl, jl, rtol=tol["rtol"])
    jstate = {k: np.asarray(v._value.astype("float32"))
              for k, v in jm.state_dict().items()}
    for k, p in tm.state_dict().items():
        assert p.dtype == td
        np.testing.assert_allclose(p.float().numpy(), jstate[k], err_msg=k,
                                   **tol)
    assert tl[-1] < tl[0]


def test_train_step_refuses_lbfgs():
    _, tm = _mlp_pair()
    with pytest.raises(NotImplementedError, match="closure"):
        TrainStep(tm, _mse, topt.LBFGS(parameters=tm.parameters()),
                  split_label=True)
