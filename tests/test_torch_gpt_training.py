"""The port's GPT training slice held against the JAX package on the CPU.

The same weights (numpy, through ``bridge.py``) and the same batch go
through the JAX package and the port, on ``gpt_tiny()`` (and a GQA variant)
in f32. The JAX cache-free forward takes its XLA attention path here, the
port its flash wrapper's plain versions (with the explicit backward
formulas):

* logits within 1e-5, the loss within 1e-6 relative and every gradient
  within 5e-5 (f32 sums in another order);
* three ``TrainStep`` steps of AdamW (lr 1e-4, weight decay 0.01) with
  ``ClipGradByGlobalNorm(1.0)``: per-step losses within 1e-5 relative,
  parameters within 1e-5;
* two eager ``Optimizer.step``s with ``multi_precision`` on bf16
  parameters: f32 master weights and moments within 1e-6 relative, the bf16
  parameters within one bf16 rounding;
* O2 ``decorate``: the same dtype for every parameter name;
* ``ParallelCrossEntropy`` with ``ignore_index``, values and gradients.
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu.autograd import tape
from paddle_tpu.distributed.fleet.meta_parallel import (
    ParallelCrossEntropy as JaxCE,
)
from paddle_tpu.jit.train import TrainStep as JaxTrainStep
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import from_paddle_tpu_state, to_paddle_tpu_state
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    ParallelCrossEntropy,
)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn import functional as TF

CONFIGS = {
    "tiny": dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
                 max_position=128),
    "gqa": dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
                num_kv_heads=2, max_position=128),
}


def _pair(name="tiny", seed=11):
    kw = CONFIGS[name]
    with paddle.utils.unique_name.guard():
        paddle.seed(seed)
        jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**kw))
    state = {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}
    return jm, from_paddle_tpu_state(state, tgpt.GPTConfig(**kw),
                                     device="cpu")


def _batch(B=2, S=24, V=1024, seed=0):
    ids = np.random.default_rng(seed).integers(0, V, (B, S))
    return ids, np.roll(ids, -1, axis=1)


def _jax_loss_and_grads(jm, ids, labels):
    """(logits, loss, {name: grad}) of the JAX model: one jitted
    ``value_and_grad`` over its functional call (the TrainStep's own route,
    and much quicker here than the eager tape's per-op programs)."""
    def f(state, x, y):
        with tape.no_grad():
            logits, loss = jm.functional_call(state, paddle.Tensor(x),
                                              labels=paddle.Tensor(y))
        return loss._value, logits._value

    state = {k: v._value for k, v in jm.state_dict().items()}
    (loss, logits), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        state, ids, labels)
    return (np.asarray(logits), float(loss),
            {k: np.asarray(g) for k, g in grads.items()})


def _jax_state(jm):
    return {k: np.asarray(v._value.astype("float32"))
            for k, v in jm.state_dict().items()}


@pytest.fixture(scope="module")
def jax_loss_and_grads():
    """JAX's logits, loss and gradients per config, computed once before
    the tests (the jitted ``value_and_grad`` compiles in setup)."""
    ids, labels = _batch()
    return {c: _jax_loss_and_grads(_pair(c)[0], ids, labels)
            for c in sorted(CONFIGS)}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_logits_loss_and_gradients_match_jax(config, jax_loss_and_grads):
    _, tm = _pair(config)
    ids, labels = _batch()
    jlogits, jloss, jgrads = jax_loss_and_grads[config]
    tlogits, tloss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert TF.get_last_attention_backend() == "plain"
    tloss.backward()
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(tloss.detach()), jloss, rtol=1e-6)
    tgrads = dict(tm.named_parameters())
    assert set(jgrads) == set(tgrads)
    for k, g in jgrads.items():
        np.testing.assert_allclose(tgrads[k].grad.numpy(), g, atol=5e-5,
                                   rtol=5e-5, err_msg=k)


@pytest.fixture(scope="module")
def position_ids_case():
    """The JAX forward at given positions, computed once before the test
    (its eager programs compile per op: setup, not the test's call)."""
    jm, tm = _pair()
    ids, _ = _batch(B=1, S=10)
    pos = np.arange(5, 15)[None]
    want = np.asarray(jm(paddle.to_tensor(ids),
                         position_ids=paddle.to_tensor(pos))._value)
    return tm, ids, pos, want


def test_forward_takes_position_ids_like_jax(position_ids_case):
    tm, ids, pos, want = position_ids_case
    got = tm(torch.from_numpy(ids), position_ids=torch.from_numpy(pos))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def jax_adamw_steps():
    """JAX's three TrainStep steps of AdamW with the global-norm clip:
    (losses, step count, final state), computed once before the test (the
    step's compile belongs to setup, not to the test's call)."""
    jm, _ = _pair()
    ids, labels = _batch()
    jopt = paddle.optimizer.AdamW(
        learning_rate=1e-4, parameters=jm.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    jstep = JaxTrainStep(jm, lambda logits, loss: loss, jopt)
    losses = [float(jstep(paddle.to_tensor(ids),
                          labels=paddle.to_tensor(labels)))
              for _ in range(3)]
    return losses, jopt._step_count, _jax_state(jm)


def test_trainstep_adamw_with_global_norm_clip_matches_jax(jax_adamw_steps):
    _, tm = _pair()
    ids, labels = _batch()
    jlosses, jcount, jstate = jax_adamw_steps
    opt = topt.AdamW(learning_rate=1e-4, parameters=tm.parameters(),
                     weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(tm, lambda logits, loss: loss, opt)
    before = to_paddle_tpu_state(tm)
    for want in jlosses:
        got = float(step(torch.from_numpy(ids),
                         labels=torch.from_numpy(labels)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert opt._step_count == jcount == 3
    tstate = to_paddle_tpu_state(tm)
    moved = max(float(np.abs(tstate[k] - before[k]).max()) for k in tstate)
    assert moved > 1e-4                     # the steps did move them
    for k, v in jstate.items():
        np.testing.assert_allclose(tstate[k], v, atol=1e-5, rtol=0,
                                   err_msg=k)
    assert all(p.grad is None for p in tm.parameters())


def test_trainstep_in_bf16_updates_in_the_parameter_dtype():
    """Under O2 the TrainStep keeps no f32 master weights and its moments
    are bf16, as the JAX TrainStep does (``jit/train.py:201-212``)."""
    _, tm = _pair()
    opt = topt.AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                     multi_precision=True)
    tamp.decorate(tm, opt, level="O2", dtype="bfloat16")
    step = TrainStep(tm, lambda logits, loss: loss, opt)
    ids, labels = _batch()
    losses = [float(step(torch.from_numpy(ids),
                         labels=torch.from_numpy(labels))) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert not opt._master_weights
    for store in opt._accumulators.values():
        assert all(v.dtype == torch.bfloat16 for v in store.values())


def test_trainstep_gives_the_last_argument_to_the_loss_when_forward_cannot():
    torch.manual_seed(0)
    lin = torch.nn.Linear(4, 3)
    opt = topt.Adam(learning_rate=0.1, parameters=lin.parameters())
    step = TrainStep(lin, lambda out, y: ((out - y) ** 2).mean(), opt)
    x, y = torch.randn(5, 4), torch.randn(5, 3)
    losses = [float(step(x, y)) for _ in range(5)]
    assert losses[-1] < losses[0]


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


def test_eager_multi_precision_steps_match_jax():
    """Two eager AdamW steps on bf16 parameters with ``multi_precision``:
    f32 master weights, f32 gradients and f32 moments on both sides."""
    rng = np.random.default_rng(5)
    shapes = [(6, 5), (7,)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(2)]
    jparams = [paddle.to_tensor(a, dtype="bfloat16", stop_gradient=False)
               for a in init]
    tparams = [torch.nn.Parameter(_bf16(a)) for a in init]
    jopt = paddle.optimizer.AdamW(learning_rate=1e-2, parameters=jparams,
                                  weight_decay=0.1, multi_precision=True)
    opt = topt.AdamW(learning_rate=1e-2, parameters=tparams,
                     weight_decay=0.1, multi_precision=True)
    for g in grads:
        for jp, tp, a in zip(jparams, tparams, g):
            jp.grad = paddle.to_tensor(a).astype("bfloat16")
            tp.grad = _bf16(a)
        jopt.step()
        opt.step()
    for jp, tp in zip(jparams, tparams):
        master = opt._master_weights[id(tp)]
        assert master.dtype == torch.float32 and tp.dtype == torch.bfloat16
        np.testing.assert_allclose(
            master.numpy(), np.asarray(jopt._master_weights[id(jp)]),
            rtol=1e-6, atol=1e-7)
        for name in ("moment1", "moment2"):
            mine = opt._accumulators[name][id(tp)]
            assert mine.dtype == torch.float32
            np.testing.assert_allclose(
                mine.numpy(), np.asarray(jopt._accumulators[name][id(jp)]),
                rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(
            tp.detach().float().numpy(),
            np.asarray(jp._value.astype("float32")), rtol=2 ** -8, atol=0)


def test_o2_decorate_casts_the_same_parameters_as_jax():
    jm, tm = _pair()
    jopt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                  parameters=jm.parameters())
    opt = topt.AdamW(learning_rate=1e-4, parameters=tm.parameters())
    paddle.amp.decorate(jm, jopt, level="O2", dtype="bfloat16")
    tamp.decorate(tm, opt, level="O2", dtype="bfloat16")
    want = {k: str(v.dtype) for k, v in jm.state_dict().items()}
    got = {k: str(p.dtype).replace("torch.", "")
           for k, p in tm.named_parameters()}
    assert got == want and set(want.values()) == {"bfloat16"}
    assert opt._multi_precision and jopt._multi_precision
    assert all(p is q for p, q in zip(opt._params, tm.parameters()))
    # auto_cast O2 reaches the model's seams: bf16 logits
    with tamp.auto_cast(level="O2"):
        assert tm(torch.zeros((1, 4), dtype=torch.int64)).dtype == \
            torch.bfloat16


def _ce_case():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((10, 32)).astype(np.float32)
    labels = rng.integers(0, 32, (10,))
    labels[[1, 6]] = -100
    w = rng.standard_normal((10,)).astype(np.float32)
    return logits, labels, w


@pytest.fixture(scope="module")
def jax_ce():
    """JAX's cross entropy with ignore_index and its gradient, per dtype,
    and its shape with labels [N, 1]: computed once before the tests (its
    eager programs compile per op)."""
    logits, labels, w = _ce_case()
    out = {}
    for dtype in ("float32", "bfloat16"):
        jx = paddle.to_tensor(logits, dtype=dtype, stop_gradient=False)
        jloss = JaxCE(ignore_index=-100)(jx, paddle.to_tensor(labels))
        (jloss.astype("float32") * paddle.to_tensor(w)).sum().backward()
        out[dtype] = (np.asarray(jloss._value.astype("float32")),
                      np.asarray(jx.grad._value.astype("float32")))
    ref = JaxCE()(paddle.to_tensor(logits), paddle.to_tensor(labels[:, None]))
    out["shape"] = tuple(ref.shape)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parallel_cross_entropy_with_ignore_index_matches_jax(dtype, jax_ce):
    logits, labels, w = _ce_case()
    jloss, jgrad = jax_ce[dtype]
    tx = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    tloss = ParallelCrossEntropy(ignore_index=-100)(tx,
                                                    torch.from_numpy(labels))
    assert tloss.dtype == getattr(torch, dtype)     # in the logits' dtype
    (tloss.float() * torch.from_numpy(w)).sum().backward()
    assert float(tloss[1].detach()) == float(tloss[6].detach()) == 0.0
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(tloss.float().detach().numpy(), jloss,
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(tx.grad.float().numpy(), jgrad,
                               atol=tol, rtol=tol)
    got = ParallelCrossEntropy()(torch.from_numpy(logits),
                                 torch.from_numpy(labels[:, None]))
    assert tuple(got.shape) == jax_ce["shape"] == (10, 1)


def test_bridge_round_trips_the_jax_state():
    jm, tm = _pair()
    got = to_paddle_tpu_state(tm)
    want = _jax_state(jm)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_config_refuses_dropout_and_recompute():
    """Dropout and recompute are ported; a recompute policy other than
    None, "block" or "dots" is refused, as JAX refuses it."""
    with pytest.raises(ValueError, match="recompute"):
        tgpt.GPTConfig(recompute="everything")
    c = tgpt.GPTConfig(dropout=0.1, recompute="block")
    assert c.dropout == 0.1 and c.recompute == "block"
    c = tgpt.GPTConfig(dropout=0.0, recompute=None)
    assert c.dropout == 0.0 and c.recompute is None
