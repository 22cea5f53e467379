"""The port's learning-rate schedulers (``paddle_tpu_torch/optimizer/lr.py``)
held against the JAX package's (``paddle_tpu/optimizer/lr.py``).

Both are host Python over the same arithmetic, so the rates must be equal,
not close:

* every scheduler (the 17 subclasses, and the variants their options
  select) built with the same arguments on both sides gives the same rate
  over 30 steps, and the same ``state_dict`` after 10;
* a state dict taken after 10 steps and set into a fresh scheduler gives
  the rest of the schedule (20 more steps) unchanged;
* twins of ``tests/test_optimizer_golden.py``'s schedule legs: the closed
  forms there, and "scheduler in optimizer updates lr" (SGD under
  ``StepDecay``, eager steps: the rates seen and the weights within 1e-6).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.optimizer import lr as tlr

jlr = paddle.optimizer.lr

SCHEDULERS = {
    "noam": lambda m: m.NoamDecay(d_model=64, warmup_steps=4,
                                  learning_rate=2.0),
    "piecewise": lambda m: m.PiecewiseDecay(boundaries=[3, 9, 20],
                                            values=[1.0, 0.5, 0.1, 0.01]),
    "natural_exp": lambda m: m.NaturalExpDecay(learning_rate=0.5,
                                               gamma=0.1),
    "inverse_time": lambda m: m.InverseTimeDecay(learning_rate=0.5,
                                                 gamma=0.2),
    "polynomial": lambda m: m.PolynomialDecay(learning_rate=1.0,
                                              decay_steps=12, end_lr=0.1,
                                              power=2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(
        learning_rate=1.0, decay_steps=7, end_lr=0.05, power=1.0,
        cycle=True),
    "linear_warmup": lambda m: m.LinearWarmup(learning_rate=0.3,
                                              warmup_steps=5, start_lr=0.0,
                                              end_lr=0.3),
    "linear_warmup_cosine": lambda m: m.LinearWarmup(
        learning_rate=m.CosineAnnealingDecay(learning_rate=0.1, T_max=20),
        warmup_steps=4, start_lr=0.01, end_lr=0.1),
    "exponential": lambda m: m.ExponentialDecay(learning_rate=1.0,
                                                gamma=0.9),
    "multistep": lambda m: m.MultiStepDecay(learning_rate=1.0,
                                            milestones=[2, 5, 17],
                                            gamma=0.5),
    "step": lambda m: m.StepDecay(learning_rate=0.5, step_size=4,
                                  gamma=0.3),
    "lambda": lambda m: m.LambdaDecay(learning_rate=2.0,
                                      lr_lambda=lambda e: 0.95 ** e),
    "multiplicative": lambda m: m.MultiplicativeDecay(
        learning_rate=1.0, lr_lambda=lambda e: 0.9 + 0.001 * e),
    "cosine": lambda m: m.CosineAnnealingDecay(learning_rate=1.0, T_max=10,
                                               eta_min=0.01),
    "cosine_restarts": lambda m: m.CosineAnnealingWarmRestarts(
        learning_rate=1.0, T_0=5, T_mult=2, eta_min=0.001),
    "linear_lr": lambda m: m.LinearLR(learning_rate=0.2, total_steps=15,
                                      start_factor=0.25, end_factor=1.0),
    "one_cycle_cos": lambda m: m.OneCycleLR(max_learning_rate=0.1,
                                            total_steps=25),
    "one_cycle_linear_3phase": lambda m: m.OneCycleLR(
        max_learning_rate=0.1, total_steps=24, anneal_strategy="linear",
        three_phase=True),
    "cyclic_triangular": lambda m: m.CyclicLR(
        base_learning_rate=0.01, max_learning_rate=0.1, step_size_up=4),
    "cyclic_triangular2": lambda m: m.CyclicLR(
        base_learning_rate=0.01, max_learning_rate=0.1, step_size_up=3,
        step_size_down=5, mode="triangular2"),
    "cyclic_exp_range": lambda m: m.CyclicLR(
        base_learning_rate=0.01, max_learning_rate=0.1, step_size_up=4,
        mode="exp_range", exp_gamma=0.97),
    "reduce_on_plateau": lambda m: m.ReduceOnPlateau(
        learning_rate=1.0, factor=0.5, patience=2, threshold=0.01,
        cooldown=1, min_lr=0.01),
}

# the metric ReduceOnPlateau is stepped with: falls, stalls, falls again
PLATEAU = [5.0, 4.0, 3.9, 3.95, 3.96, 3.97, 3.5, 3.49, 3.49, 3.49] * 3


def _advance(sched, i):
    if isinstance(sched, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
        sched.step(PLATEAU[i])
    else:
        sched.step()


def _rates(sched, n, start=0):
    out = []
    for i in range(start, start + n):
        out.append(sched())
        _advance(sched, i)
    return out


def test_every_jax_scheduler_has_a_port():
    names = set(jlr.__all__)
    assert names == set(tlr.__all__)
    built = {type(f(tlr)).__name__ for f in SCHEDULERS.values()}
    assert built == names - {"LRScheduler"}        # all 17 subclasses


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_schedule_equals_jax_over_30_steps(name):
    mine, ref = SCHEDULERS[name](tlr), SCHEDULERS[name](jlr)
    got, want = _rates(mine, 10), _rates(ref, 10)
    assert got == want
    assert mine.state_dict() == ref.state_dict()
    assert _rates(mine, 20, 10) == _rates(ref, 20, 10)
    assert len(set(got + want)) > 1 or name == "reduce_on_plateau"


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_state_dict_round_trip_continues_the_schedule(name):
    a = SCHEDULERS[name](tlr)
    _rates(a, 10)
    state = a.state_dict()
    b = SCHEDULERS[name](tlr)
    b.set_state_dict(state)
    assert state == a.state_dict()          # setting it did not consume it
    assert _rates(b, 20, 10) == _rates(a, 20, 10)


def test_closed_forms_of_the_jax_golden_legs():
    """The numpy references of ``test_optimizer_golden.py``."""
    def seq(s, n):
        return _rates(s, n)

    np.testing.assert_allclose(
        seq(tlr.StepDecay(learning_rate=0.5, step_size=3, gamma=0.1), 9),
        [0.5] * 3 + [0.05] * 3 + [0.005] * 3, rtol=1e-6)
    np.testing.assert_allclose(
        seq(tlr.CosineAnnealingDecay(learning_rate=1.0, T_max=10), 11),
        [0.5 * (1 + math.cos(math.pi * i / 10)) for i in range(11)],
        rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        seq(tlr.PolynomialDecay(learning_rate=1.0, decay_steps=4,
                                end_lr=0.1, power=1.0), 6),
        [1.0, 0.775, 0.55, 0.325, 0.1, 0.1], rtol=1e-5)
    warm = seq(tlr.LinearWarmup(learning_rate=1.0, warmup_steps=4,
                                start_lr=0.0, end_lr=1.0), 6)
    np.testing.assert_allclose(warm[:4], [0.0, 0.25, 0.5, 0.75], rtol=1e-6)
    assert warm[4] == pytest.approx(1.0)
    s = tlr.ReduceOnPlateau(learning_rate=1.0, factor=0.5, patience=1,
                            threshold=0.0)
    lrs = []
    for loss in [1.0, 1.0, 1.0, 1.0]:
        lrs.append(s())
        s.step(torch.tensor(loss))          # a tensor metric, read on host
    assert lrs[0] == 1.0 and min(lrs) <= 0.5


W0 = np.array([[1.0, -2.0], [0.5, 3.0]], dtype="float32")
X = np.array([[0.7, -1.2], [0.3, 0.9], [-0.5, 0.4]], dtype="float32")


def test_scheduler_in_optimizer_updates_lr_like_jax():
    """SGD under StepDecay, eager steps with ``sched.step()`` between them:
    ``get_lr`` follows the scheduler and the weights follow JAX's."""
    def run(paddle_side):
        mod = jlr if paddle_side else tlr
        sched = mod.StepDecay(learning_rate=0.1, step_size=1, gamma=0.5)
        if paddle_side:
            w = paddle.to_tensor(W0.copy(), stop_gradient=False)
            opt = paddle.optimizer.SGD(learning_rate=sched, parameters=[w])
            xs = paddle.to_tensor(X)
        else:
            w = torch.nn.Parameter(torch.from_numpy(W0.copy()))
            opt = topt.SGD(learning_rate=sched, parameters=[w])
            xs = torch.from_numpy(X)
        seen = []
        for _ in range(3):
            (xs @ w).square().mean().backward()
            seen.append(opt.get_lr())
            opt.step()
            opt.clear_grad()
            sched.step()
        value = np.asarray(w._value) if paddle_side else w.detach().numpy()
        return seen, value

    seen, w = run(False)
    jseen, jw = run(True)
    np.testing.assert_allclose(seen, [0.1, 0.05, 0.025], rtol=1e-6)
    assert seen == jseen
    np.testing.assert_allclose(w, jw, rtol=1e-6, atol=1e-7)
    opt = topt.SGD(learning_rate=tlr.StepDecay(0.1, 1), parameters=[
        torch.nn.Parameter(torch.zeros(2))])
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.5)
    opt.set_lr_scheduler(0.25)
    assert opt.get_lr() == 0.25
    opt.set_lr(0.5)
    assert opt.get_lr() == 0.5
