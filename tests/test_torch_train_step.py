"""The port's training step (``paddle_tpu_torch/jit/train.py``), optimizers
and clips held against the JAX package on the CPU.

On the CPU ``TrainStep`` runs the body that CUDA captures, on the same
static input buffer, so these tests exercise the captured code. Models: a
two-layer MLP (weights [in, out] on both sides, the same numpy init) and
``gpt_tiny``-sized GPTs; everything f32 unless said. Tolerances:

* port vs JAX, f32: losses within 1e-5 relative, parameters within 1e-6
  absolute + 1e-5 relative (sums in another order, torch's reciprocal-
  times for a scalar over a tensor); bf16: parameters within 2^-7
  relative + 1e-3 absolute (one bf16 rounding, placed differently by XLA's
  excess precision);
* port vs port (``run_steps`` against calls, a resumed run against an
  uninterrupted one, ``aot_prime`` against nothing): bit-equal, the same
  body on the same inputs.

Twins of the JAX legs in ``test_optimizer_golden.py`` (SGD, Momentum),
``test_multi_step.py`` (``run_steps`` stacked / broadcast / then-call) and
``test_checkpoint.py`` (``export_state`` / ``import_state``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.fingerprint import aval_fingerprint as jax_fingerprint
from paddle_tpu.jit.train import TrainStep as JaxTrainStep
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import from_paddle_tpu_state, to_paddle_tpu_state
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep, aval_fingerprint
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.optimizer import lr as tlr

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2 ** -7, atol=1e-3)


class _Lin(torch.nn.Module):
    """y = x @ W + b with W [in, out], as the JAX package's Linear."""

    def __init__(self, w, b):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.bias = torch.nn.Parameter(torch.from_numpy(b.copy()))

    def forward(self, x):
        return x @ self.weight + self.bias


def _init(seed=0):
    rng = np.random.default_rng(seed)
    return {"0.weight": rng.standard_normal((8, 16)).astype(np.float32) * .4,
            "0.bias": rng.standard_normal(16).astype(np.float32) * .1,
            "2.weight": rng.standard_normal((16, 4)).astype(np.float32) * .4,
            "2.bias": rng.standard_normal(4).astype(np.float32) * .1}


def _mlp_pair(seed=0):
    w = _init(seed)
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


def _data(B=6, seed=1, stacked=0):
    rng = np.random.default_rng(seed)
    lead = (stacked,) if stacked else ()
    return (rng.standard_normal(lead + (B, 8)).astype(np.float32),
            rng.standard_normal(lead + (B, 4)).astype(np.float32))


def _jstate(jm):
    return {k: np.asarray(v._value.astype("float32"))
            for k, v in jm.state_dict().items()}


def _tstate(tm):
    return {k: p.detach().float().numpy().copy()
            for k, p in tm.state_dict().items()}


def _assert_states(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


OPTS = {
    "sgd": lambda m, params, clip: m.SGD(learning_rate=0.1,
                                         parameters=params, grad_clip=clip),
    "momentum": lambda m, params, clip: m.Momentum(
        learning_rate=0.05, momentum=0.9, parameters=params, grad_clip=clip),
    "nesterov_l2": lambda m, params, clip: m.Momentum(
        learning_rate=0.05, momentum=0.9, parameters=params,
        use_nesterov=True, weight_decay=0.01, grad_clip=clip),
}
CLIPS = {
    "none": lambda m: None,
    "global": lambda m: m.ClipGradByGlobalNorm(0.05),
    "norm": lambda m: m.ClipGradByNorm(0.02),
    "value": lambda m: m.ClipGradByValue(0.01),
}


def _train_both(opt_name, clip_name, steps=3, bf16=False):
    jm, tm = _mlp_pair()
    jopt = OPTS[opt_name](paddle.optimizer, jm.parameters(),
                          CLIPS[clip_name](paddle.nn))
    topt_ = OPTS[opt_name](topt, tm.parameters(), CLIPS[clip_name](tnn))
    if bf16:
        paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
        tamp.decorate(tm, level="O2", dtype="bfloat16")
    jstep = JaxTrainStep(jm, _mse, jopt, split_label=True)
    tstep = TrainStep(tm, _mse, topt_, split_label=True)
    x, y = _data()
    dt = torch.bfloat16 if bf16 else torch.float32
    jx = paddle.to_tensor(x).astype("bfloat16" if bf16 else "float32")
    jy = paddle.to_tensor(y).astype("bfloat16" if bf16 else "float32")
    jl, tl = [], []
    for _ in range(steps):
        jl.append(float(jstep(jx, jy).astype("float32")))
        tl.append(float(tstep(torch.from_numpy(x).to(dt),
                              torch.from_numpy(y).to(dt)).float()))
    return jl, tl, _jstate(jm), _tstate(tm), tm, topt_


@pytest.mark.parametrize("clip", ["none", "global", "norm", "value"])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "nesterov_l2"])
def test_trainstep_sgd_momentum_and_clips_match_jax(opt, clip):
    jl, tl, jstate, tstate, tm, o = _train_both(opt, clip)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_states(tstate, jstate, **F32)
    assert all(p.grad is None for p in tm.parameters())
    assert o._step_count == 3
    if opt != "sgd":
        assert all(v.dtype == torch.float32 for v in
                   o._accumulators["velocity"].values())
    if clip != "none":          # the clip was active: it moved the result
        _, _, _, free, _, _ = _train_both(opt, "none")
        assert max(np.abs(free[k] - tstate[k]).max() for k in free) > 1e-3


def test_trainstep_momentum_in_bf16_matches_jax():
    """O2 bf16: parameters, velocities and the update in bf16 on both
    sides (the JAX TrainStep keeps no masters)."""
    jl, tl, jstate, tstate, tm, o = _train_both("nesterov_l2", "norm",
                                                bf16=True)
    np.testing.assert_allclose(tl, jl, rtol=2 ** -7)
    _assert_states(tstate, jstate, **BF16)
    assert all(v.dtype == torch.bfloat16 for v in
               o._accumulators["velocity"].values())
    assert not o._master_weights


# ------------------------------------------------------------ eager path
W0 = np.array([[1.0, -2.0], [0.5, 3.0]], dtype="float32")
X = np.array([[0.7, -1.2], [0.3, 0.9], [-0.5, 0.4]], dtype="float32")


def _grad_of(w):
    return (2.0 / (X.shape[0] * W0.shape[1])) * X.T @ (X @ w)


@pytest.mark.parametrize("clip", ["none", "global", "norm", "value"])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "nesterov_l2"])
def test_eager_steps_match_jax(opt, clip):
    """Five eager ``Optimizer.step``s on the golden quadratic problem."""
    def run(jax_side):
        if jax_side:
            w = paddle.to_tensor(W0.copy(), stop_gradient=False)
            o = OPTS[opt](paddle.optimizer, [w], CLIPS[clip](paddle.nn))
            xs = paddle.to_tensor(X)
        else:
            w = torch.nn.Parameter(torch.from_numpy(W0.copy()))
            o = OPTS[opt](topt, [w], CLIPS[clip](tnn))
            xs = torch.from_numpy(X)
        hist = []
        for _ in range(5):
            (xs @ w).square().mean().backward()
            o.step()
            o.clear_grad()
            hist.append(np.asarray(w._value) if jax_side
                        else w.detach().numpy().copy())
        return hist

    got, want = run(False), run(True)
    for g, j in zip(got, want):
        np.testing.assert_allclose(g, j, **F32)
    if clip == "none":          # and the golden numpy references
        w, v = W0.copy(), np.zeros_like(W0)
        for g in got:
            grad = _grad_of(w)
            if opt == "sgd":
                w = w - 0.1 * grad
            elif opt == "momentum":
                v = 0.9 * v + grad
                w = w - 0.05 * v
            else:
                grad = grad + 0.01 * w
                v = 0.9 * v + grad
                w = w - 0.05 * (grad + 0.9 * v)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_eager_clips_leave_need_clip_false_and_missing_grads():
    a, b = torch.ones(3, requires_grad=True), torch.ones(2)
    b.need_clip = False
    ga, gb = torch.full((3,), 5.0), torch.full((2,), 5.0)
    for clip in (tnn.ClipGradByNorm(1.0), tnn.ClipGradByValue(1.0),
                 tnn.ClipGradByGlobalNorm(1.0)):
        out = clip([(a, ga), (b, gb), (torch.ones(1), None)])
        assert float(out[0][1].abs().max()) <= 1.0
        assert out[1][1] is gb and out[2][1] is None


@pytest.mark.parametrize("norm_type", [2.0, 3.0, float("inf")])
def test_clip_grad_norm_and_value_match_jax(norm_type):
    rng = np.random.default_rng(7)
    grads = [rng.standard_normal(s).astype(np.float32) * 3
             for s in ((4, 5), (6,))]
    jp = [paddle.to_tensor(np.zeros_like(g), stop_gradient=False)
          for g in grads]
    tp = [torch.zeros(g.shape, requires_grad=True) for g in grads]
    for p, q, g in zip(jp, tp, grads):
        p.grad = paddle.to_tensor(g)
        q.grad = torch.from_numpy(g.copy())
    jtot = paddle.nn.utils.clip_grad_norm_(jp, 2.0, norm_type)
    ttot = tnn.clip_grad_norm_(tp, 2.0, norm_type)
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=1e-6)
    for p, q in zip(jp, tp):
        np.testing.assert_allclose(q.grad.numpy(), np.asarray(p.grad._value),
                                   **F32)
    paddle.nn.utils.clip_grad_value_(jp, 0.1)
    tnn.clip_grad_value_(tp, 0.1)
    for p, q in zip(jp, tp):
        np.testing.assert_array_equal(q.grad.numpy(),
                                      np.asarray(p.grad._value))


# ------------------------------------------------------ the GPT, scheduled
GPT = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
           max_position=64)


def _gpt_pair(seed=11):
    with paddle.utils.unique_name.guard():
        paddle.seed(seed)
        jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**GPT))
    state = {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}
    return jm, from_paddle_tpu_state(state, tgpt.GPTConfig(**GPT),
                                     device="cpu")


def test_gpt_momentum_under_warmup_cosine_and_norm_clip_matches_jax():
    """The chip's LR-schedule leg at tiny size: Momentum under
    LinearWarmup(CosineAnnealingDecay) with ClipGradByNorm, the scheduler
    stepped after each of 4 steps; every step reads its own rate."""
    jm, tm = _gpt_pair()

    def sched(mod):
        return mod.LinearWarmup(
            learning_rate=mod.CosineAnnealingDecay(learning_rate=0.05,
                                                   T_max=6),
            warmup_steps=2, start_lr=0.01, end_lr=0.05)

    js, ts = sched(paddle.optimizer.lr), sched(tlr)
    jopt = paddle.optimizer.Momentum(
        learning_rate=js, momentum=0.9, parameters=jm.parameters(),
        grad_clip=paddle.nn.ClipGradByNorm(0.5))
    opt = topt.Momentum(learning_rate=ts, momentum=0.9,
                        parameters=tm.parameters(),
                        grad_clip=tnn.ClipGradByNorm(0.5))
    jstep = JaxTrainStep(jm, lambda logits, loss: loss, jopt)
    step = TrainStep(tm, lambda logits, loss: loss, opt)
    ids = np.random.default_rng(0).integers(0, 1024, (2, 16))
    labels = np.roll(ids, -1, axis=1)
    rates = []
    for _ in range(4):
        rates.append(opt.get_lr())
        want = float(jstep(paddle.to_tensor(ids),
                           labels=paddle.to_tensor(labels)))
        got = float(step(torch.from_numpy(ids),
                         labels=torch.from_numpy(labels)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        js.step()
        ts.step()
    assert len(set(rates)) == 4
    assert len(step._programs) == 1         # one key for all four rates
    _assert_states(to_paddle_tpu_state(tm), {
        k: np.asarray(v._value) for k, v in jm.state_dict().items()}, **F32)


# ------------------------------------------------------------- run_steps
K = 4


def _adamw_step(seed=0):
    _, tm = _mlp_pair(seed)
    opt = topt.AdamW(learning_rate=1e-2, parameters=tm.parameters())
    return tm, TrainStep(tm, _mse, opt, split_label=True)


def _jax_adamw_step(seed=0):
    jm, _ = _mlp_pair(seed)
    opt = paddle.optimizer.AdamW(learning_rate=1e-2,
                                 parameters=jm.parameters())
    return jm, JaxTrainStep(jm, _mse, opt, split_label=True)


def test_run_steps_stacked_equals_calls_and_jax():
    xs, ys = _data(stacked=K)
    tm_a, step_a = _adamw_step()
    seq = [step_a(torch.from_numpy(xs[i]), torch.from_numpy(ys[i]))
           for i in range(K)]
    tm_b, step_b = _adamw_step()
    losses = step_b.run_steps(K, xs, ys, stacked=True)
    assert losses.shape == (K,)
    assert torch.equal(losses, torch.stack(seq))
    _assert_states(_tstate(tm_b), _tstate(tm_a), rtol=0, atol=0)
    assert step_b.optimizer._step_count == K and step_b._seed == K
    jm, jstep = _jax_adamw_step()
    jl = jstep.run_steps(K, paddle.to_tensor(xs), paddle.to_tensor(ys),
                         stacked=True)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl._value),
                               rtol=1e-5)
    _assert_states(_tstate(tm_b), _jstate(jm), **F32)


def test_run_steps_broadcast_then_call_continue_the_calls():
    x, y = (torch.from_numpy(a) for a in _data())
    tm_a, step_a = _adamw_step()
    seq = [step_a(x, y) for _ in range(K + 1)]
    tm_b, step_b = _adamw_step()
    losses = step_b.run_steps(K, x, y)
    assert torch.equal(losses, torch.stack(seq[:K]))
    assert losses[-1] < losses[0]
    assert torch.equal(step_b(x, y), seq[-1])
    assert len(step_b._programs) == 1       # the calls' program
    _assert_states(_tstate(tm_b), _tstate(tm_a), rtol=0, atol=0)


def test_the_step_writes_parameters_and_accumulators_in_place():
    """What a captured step needs: the tensors it reads are the tensors it
    writes, created before its first run (the moments exist, as zeros,
    before the first call returns)."""
    tm, step = _adamw_step()
    x, y = (torch.from_numpy(a) for a in _data())
    opt = step.optimizer

    def addresses():
        return [t.data_ptr() for t in step._state_tensors()]

    step(x, y)
    first = addresses()
    assert len(first) == 3 * 4              # 4 parameters, 2 moments each
    for _ in range(3):
        step(x, y)
    assert addresses() == first
    assert all(torch.count_nonzero(v) > 0
               for v in opt._accumulators["moment2"].values())


def test_run_steps_refuses_what_jax_refuses():
    _, step = _adamw_step()
    x, y = _data()
    with pytest.raises(ValueError, match="leading dim"):
        step.run_steps(K, x, y, stacked=True)
    _, tm = _mlp_pair()
    out_step = TrainStep(tm, _mse, topt.SGD(parameters=tm.parameters()),
                         return_outputs=True, split_label=True)
    with pytest.raises(ValueError, match="return_outputs"):
        out_step.run_steps(2, x, y)


# --------------------------------------------------- export / import
def test_export_import_resumes_bit_exact_without_a_new_program():
    x, y = (torch.from_numpy(a) for a in _data())
    sched = tlr.StepDecay(learning_rate=0.1, step_size=2)
    _, tm = _mlp_pair()
    opt = topt.Momentum(learning_rate=sched, parameters=tm.parameters())
    step = TrainStep(tm, _mse, opt, split_label=True)
    for _ in range(2):
        step(x, y)
        sched.step()
    snap = step.export_state()
    assert snap["meta"]["lr_sched"] == sched.state_dict()
    assert snap["meta"]["step_count"] == 2 and snap["meta"]["seed"] == 2
    rng = torch.get_rng_state()
    after = step(x, y)
    after_state = _tstate(tm)
    sched.step()
    step(x, y)                              # move past the export
    sched.step()
    torch.rand(3)
    prog = next(iter(step._programs.values()))
    step.import_state(snap)
    assert opt._step_count == 2 and step._seed == 2
    assert sched.state_dict() == snap["meta"]["lr_sched"]
    assert torch.equal(torch.get_rng_state(), rng)
    assert torch.equal(step(x, y), after)
    _assert_states(_tstate(tm), after_state, rtol=0, atol=0)
    assert list(step._programs.values()) == [prog]


def test_import_of_a_jax_export_continues_the_jax_run():
    """The JAX TrainStep's export (2 steps of Momentum under StepDecay),
    moved across as numpy, imported into a fresh port step: the third step
    matches JAX's third step."""
    x, y = _data()
    jm, _ = _mlp_pair()
    js = paddle.optimizer.lr.StepDecay(learning_rate=0.1, step_size=2)
    jstep = JaxTrainStep(jm, _mse, paddle.optimizer.Momentum(
        learning_rate=js, parameters=jm.parameters()), split_label=True)
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    for _ in range(2):
        float(jstep(jx, jy))
        js.step()
    snap = jstep.export_state()
    snap = {"params": {k: np.asarray(v) for k, v in snap["params"].items()},
            "acc": {a: {k: np.asarray(v) for k, v in per.items()}
                    for a, per in snap["acc"].items()},
            "meta": {k: v for k, v in snap["meta"].items() if k != "rng"}}
    want = float(jstep(jx, jy))
    _, tm = _mlp_pair(seed=5)               # other weights, overwritten
    ts = tlr.StepDecay(learning_rate=0.1, step_size=2)
    opt = topt.Momentum(learning_rate=ts, parameters=tm.parameters())
    step = TrainStep(tm, _mse, opt, split_label=True)
    step.import_state(snap)
    assert opt._step_count == 2 and ts.state_dict() == js.state_dict()
    got = float(step(torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    _assert_states(_tstate(tm), _jstate(jm), **F32)


# ------------------------------------------------------------ aot_prime
def test_aot_prime_mutates_nothing_and_counts_exact_flops():
    """aot_prime runs (and on CUDA captures) a step and undoes it: the
    parameters, accumulators, counters, RNG and scheduler are bit-equal
    after it, and the next call equals an unprimed twin's. One step of the
    MLP at B = 6 is five matrix products (x@W0, h@W1; dW1, dh, dW0):
    2·6·(8·16 + 16·4 + 16·4 + 16·4 + 8·16) = 5376 FLOPs."""
    x, y = (torch.from_numpy(a) for a in _data())

    def build():
        _, tm = _mlp_pair()
        sched = tlr.LinearWarmup(0.01, warmup_steps=3, start_lr=0.0,
                                 end_lr=0.01)
        opt = topt.AdamW(learning_rate=sched, parameters=tm.parameters())
        return tm, opt, sched, TrainStep(tm, _mse, opt, split_label=True)

    tm, opt, sched, step = build()
    twin_m, _, twin_s, twin = build()
    for s, st in ((step, sched), (twin, twin_s)):
        s(x, y)
        st.step()
    before = _tstate(tm)
    accs = {n: [v.clone() for v in store.values()]
            for n, store in opt._accumulators.items()}
    rng, sd = torch.get_rng_state(), sched.state_dict()
    prog = step.aot_prime(x, y)
    assert prog.flops == 5376.0
    _assert_states(_tstate(tm), before, rtol=0, atol=0)
    for n, vals in accs.items():
        for a, b in zip(vals, opt._accumulators[n].values()):
            assert torch.equal(a, b)
    assert opt._step_count == 1 and step._seed == 1
    assert torch.equal(torch.get_rng_state(), rng)
    assert sched.state_dict() == sd
    assert step.aot_prime(x, y) is prog and list(step._programs.values()) \
        == [prog]
    assert torch.equal(step(x, y), twin(x, y))
    _assert_states(_tstate(tm), _tstate(twin_m), rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="program text"):
        step.lowered(x, y)
    with pytest.raises(NotImplementedError, match="program text"):
        step.lowered_steps(2, x, y)


# ------------------------------------------- keys, scalars, outputs
class _Scaled(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.linspace(-1, 1, 12).reshape(4, 3))

    def forward(self, x, scale=1.0):
        return (x @ self.w) * scale


def test_python_numbers_are_values_not_keys():
    """A Python number in the batch is a 0-d tensor in the step's buffer:
    a new value replays the same program and is read by it; a new type is
    a new key (as JAX's fingerprint and trace)."""
    x, y = torch.ones(2, 4), torch.zeros(2, 3)
    m, ref = _Scaled(), _Scaled()
    step = TrainStep(m, _mse, topt.SGD(learning_rate=0.1,
                                       parameters=m.parameters()),
                     split_label=True)
    ropt = topt.SGD(learning_rate=0.1, parameters=ref.parameters())
    for scale in (1.0, 2.5, -0.5):
        got = step(x, y, scale=scale)
        want = _mse(ref(x, scale=scale), y)
        want.backward()
        ropt.step()
        ropt.clear_grad()
        torch.testing.assert_close(got, want.detach(), rtol=1e-6, atol=0)
    assert len(step._programs) == 1
    step(x, y, scale=2)
    assert len(step._programs) == 2


def test_fingerprint_draws_the_lines_jax_draws():
    f32 = np.zeros((2, 3), np.float32)
    ids = np.zeros((2,), np.int64)
    variants = [
        ((f32,), {"labels": ids}),
        ((f32 + 1,), {"labels": ids + 3}),          # values: same
        ((np.zeros((2, 4), np.float32),), {"labels": ids}),   # shape
        ((f32.astype(np.float16),), {"labels": ids}),         # dtype
        ((f32, 1), {"labels": ids}),
        ((f32, 2), {"labels": ids}),                 # a number's value
        ((f32, 2.0), {"labels": ids}),               # a number's type
        ((f32,), {"labels": ids, "mask": ids}),      # structure
        (([f32],), {"labels": ids}),
        (((f32,),), {"labels": ids}),                # list vs tuple
    ]
    mine = [aval_fingerprint(a, k) for a, k in variants]
    ref = [jax_fingerprint(a, k) for a, k in variants]
    for i in range(len(variants)):
        for j in range(len(variants)):
            assert (mine[i] == mine[j]) == (ref[i] == ref[j]), (i, j)
    assert mine[0][1] == ref[0][1]          # the same (shape, dtype) leaves
    t = (torch.zeros(2, 3),), {"labels": torch.zeros(2, dtype=torch.int64)}
    assert aval_fingerprint(*t) == mine[0]  # a tensor prints as its array


def test_return_outputs_matches_jax():
    jm, tm = _mlp_pair()
    jstep = JaxTrainStep(jm, _mse, paddle.optimizer.SGD(
        learning_rate=0.1, parameters=jm.parameters()), return_outputs=True,
        split_label=True)
    step = TrainStep(tm, _mse, topt.SGD(learning_rate=0.1,
                                        parameters=tm.parameters()),
                     return_outputs=True, split_label=True)
    x, y = _data()
    for _ in range(2):
        jl, jo = jstep(paddle.to_tensor(x), paddle.to_tensor(y))
        tl, to = step(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo._value), **F32)
        assert not to.requires_grad


def test_unknown_clip_raises():
    _, tm = _mlp_pair()
    opt = topt.SGD(parameters=tm.parameters(),
                   grad_clip=lambda params_grads: params_grads)
    step = TrainStep(tm, _mse, opt, split_label=True)
    with pytest.raises(NotImplementedError, match="global norm, norm or"):
        step(*(torch.from_numpy(a) for a in _data()))


# ------------------------------------------------------- optimizer api
def test_optimizer_groups_state_dict_and_minimize():
    _, tm = _mlp_pair()
    named = list(tm.named_parameters())
    opt = topt.Momentum(learning_rate=tlr.StepDecay(0.1, 1), parameters=[
        {"params": named[:2]}, {"params": named[2:], "weight_decay": 0.1}])
    assert [p for g in opt._param_groups for p in g["params"]] == list(
        tm.parameters())
    x, y = (torch.from_numpy(a) for a in _data())
    _, pairs = opt.minimize(_mse(tm(x), y))
    assert len(pairs) == 4 and all(g is not None for _, g in pairs)
    opt.clear_gradients()
    sd = opt.state_dict()
    assert sd["@step"] == 1 and sd["LR_Scheduler"]["last_epoch"] == 0
    assert sorted(k for k in sd if k.endswith("_velocity")) == sorted(
        f"{n}_velocity" for n, _ in named)
    _, tm2 = _mlp_pair()
    opt2 = topt.Momentum(learning_rate=tlr.StepDecay(0.1, 1),
                         parameters=tm2.named_parameters())
    opt2.set_state_dict(sd)
    assert opt2._step_count == 1
    for p, q in zip(tm.parameters(), tm2.parameters()):
        assert torch.equal(opt._accumulators["velocity"][id(p)],
                           opt2._accumulators["velocity"][id(q)])
    held = opt2._accumulators["velocity"][id(next(tm2.parameters()))]
    opt2.set_state_dict(sd)                 # lands in the stored tensors
    assert opt2._accumulators["velocity"][id(next(tm2.parameters()))] \
        is held
