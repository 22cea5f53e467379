"""Recompute (``paddle_tpu_torch/distributed/fleet/recompute.py``,
``GPTConfig.recompute``) held against no recompute within the port and
against the JAX package's gradients with ``recompute`` set, on
``gpt_tiny`` in f32 on the CPU.

* Within the port, at the same generator state: "block" and "dots" give
  the loss and every gradient of the same model without recompute bit for
  bit, with dropout 0 and with dropout 0.1 (the recomputed forward reuses
  the forward's masks, and the generator ends in the same state).
* Against JAX (dropout 0): logits within 1e-5, the loss within 1e-6
  relative and every gradient within 5e-5 (f32 sums in another order), as
  the no-recompute parity test holds them.
* ``recompute`` on a module of its own: "dots" keeps the matmul outputs
  (the backward re-runs no ``mm``), "block" keeps none of them, and the
  region re-runs under the AMP state of its forward.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.autograd import tape
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import from_paddle_tpu_state
from paddle_tpu_torch.distributed.fleet.recompute import (
    recompute,
    recompute_sequential,
)
from paddle_tpu_torch.framework import default_generator
from paddle_tpu_torch.models import gpt as tgpt

TINY = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
            max_position=128)


def _batch(B=2, S=24, seed=0):
    ids = np.random.default_rng(seed).integers(0, 1024, (B, S))
    return torch.from_numpy(ids), torch.from_numpy(np.roll(ids, -1, 1))


def _port(recompute_=None, dropout=0.0):
    return tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY, dropout=dropout,
                                              recompute=recompute_),
                               device="cpu", seed=3)


def _loss_and_grads(model, ids, labels, state):
    default_generator("cpu").set_state(state)
    _, loss = model(ids, labels=labels)
    loss.backward()
    return (loss.detach(), {k: p.grad.clone()
                            for k, p in model.named_parameters()},
            default_generator("cpu").get_state())


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("policy", ["block", "dots"])
def test_recompute_equals_no_recompute_bit_for_bit(policy, dropout):
    ids, labels = _batch()
    state = default_generator("cpu").get_state()
    ref = _loss_and_grads(_port(None, dropout), ids, labels, state)
    got = _loss_and_grads(_port(policy, dropout), ids, labels, state)
    assert torch.equal(got[0], ref[0])
    for k, g in ref[1].items():
        assert torch.equal(got[1][k], g), k
    assert torch.equal(got[2], ref[2])      # the generator ends alike
    if dropout:         # the masks were drawn: another state, another loss
        other = _loss_and_grads(_port(policy, dropout), ids, labels,
                                got[2])
        assert not torch.equal(other[0], got[0])


def _jax_pair(policy):
    with paddle.utils.unique_name.guard():
        paddle.seed(11)
        jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**TINY, recompute=policy))
    state = {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}
    tm = from_paddle_tpu_state(state, tgpt.GPTConfig(**TINY,
                                                     recompute=policy),
                               device="cpu")
    return jm, tm


@pytest.mark.parametrize("policy", ["block", "dots"])
def test_recompute_gradients_match_jax(policy):
    jm, tm = _jax_pair(policy)
    ids, labels = _batch()

    def f(state, x, y):
        with tape.no_grad():
            logits, loss = jm.functional_call(state, paddle.Tensor(x),
                                              labels=paddle.Tensor(y))
        return loss._value, logits._value

    state = {k: v._value for k, v in jm.state_dict().items()}
    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        state, ids.numpy(), labels.numpy())
    assert tm.training and tm.config.recompute == policy
    tlogits, tloss = tm(ids, labels=labels)
    tloss.backward()
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-6)
    params = dict(tm.named_parameters())
    assert set(params) == set(jgrads)
    for k, g in jgrads.items():
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(g),
                                   atol=5e-5, rtol=5e-5, err_msg=k)


class _Counting(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the aten ops run while active."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def _mlp(x, w1, w2):
    return (torch.tanh(x @ w1) @ w2).sum()


@pytest.mark.parametrize("policy, mm_in_backward", [("block", 1),
                                                    ("dots", 0)])
def test_dots_keeps_the_products_and_block_keeps_none(policy,
                                                      mm_in_backward):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 8, generator=g)
    w1 = torch.randn(8, 8, generator=g, requires_grad=True)
    w2 = torch.randn(8, 2, generator=g, requires_grad=True)
    out = recompute(_mlp, x, w1, w2, policy=policy)
    with _Counting() as mode:
        out.backward()
    # the backward's own products: dW2, dH, dW1 (three mm); "block"
    # recomputes x @ w1 (the forward stops once tanh's output, the last
    # value the backward needs, is back), "dots" kept it
    mm = sum(op == torch.ops.aten.mm.default for op in mode.ops)
    assert mm == 3 + mm_in_backward
    ref1, ref2 = w1.grad.clone(), w2.grad.clone()
    w1.grad = w2.grad = None
    _mlp(x, w1, w2).backward()
    assert torch.equal(w1.grad, ref1) and torch.equal(w2.grad, ref2)
    with pytest.raises(ValueError, match="policy"):
        recompute(_mlp, x, w1, w2, policy="everything")


def test_recompute_reruns_under_the_forward_amp_state():
    lin = tgpt.ColumnParallelLinear(8, 8, has_bias=False, device="cpu")
    lin.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(1))
    with tamp.auto_cast(dtype="bfloat16"):
        out = recompute(lin, x)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()          # outside auto_cast: no mismatch
    ref = lin.weight.grad.clone()
    lin.weight.grad = None
    with tamp.auto_cast(dtype="bfloat16"):
        out = lin(x)
    out.float().sum().backward()
    assert torch.equal(lin.weight.grad, ref)


def test_recompute_sequential_segments():
    layers = [torch.nn.Linear(6, 6) for _ in range(4)]
    x = torch.randn(2, 6, requires_grad=True)
    out = recompute_sequential({"segments": 2}, layers, x)
    ref = x
    for layer in layers:
        ref = layer(ref)
    assert torch.equal(out, ref)
    out.sum().backward()
    gx = x.grad.clone()
    x.grad = None
    ref.sum().backward()
    assert torch.equal(x.grad, gx)
