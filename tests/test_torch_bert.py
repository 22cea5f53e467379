"""The port's BERT masked LM (``paddle_tpu_torch/models/bert.py``) held
against the JAX package's on the CPU, on ``bert_tiny`` in f32, with JAX's
weights carried over by ``bridge.py``.

Tolerances (f32 sums in another order, as in the GPT parity tests):
logits within 1e-5 absolute, losses within 1e-6 relative, gradients within
5e-5; three ``TrainStep`` steps: losses within 1e-5 relative,
parameters within 1e-5. The steps are Momentum's: the k projection's
bias has a zero gradient in exact arithmetic (a shift of every score in a
row, which the softmax ignores), and Adam's normalisation would turn each
side's rounding noise there into a full step of either sign.
``bert_mlm_mask`` is host numpy on both sides: its arrays are compared
exactly.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.autograd import tape
from paddle_tpu.jit.train import TrainStep as JaxTrainStep
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import from_paddle_tpu_state, to_paddle_tpu_state
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.nn import functional as TF

V, MASK_ID = 512, 3


def _pair(seed=5):
    with paddle.utils.unique_name.guard():
        paddle.seed(seed)
        jm = jbert.BertForMaskedLM(jbert.bert_tiny())
    state = {k: np.asarray(v) for k, v in jm.raw_state().items()}
    return jm, from_paddle_tpu_state(state, tbert.bert_tiny(), device="cpu")


def _inputs(B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, V, (B, S))
    types = (np.arange(S)[None] >= S // 2).astype(np.int64).repeat(B, 0)
    keep = np.ones((B, S), bool)
    keep[1, S - 5:] = False                     # request 1 padded
    return ids, types, keep


MASKS = {"none": lambda keep: None,
         "bool": lambda keep: keep[:, None, None, :],
         "additive": lambda keep: np.where(keep, 0.0, -1e9).astype(
             np.float32)[:, None, None, :]}


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_forward_loss_and_gradients_match_jax(mask):
    """Without a mask the flash route (its plain version here), with a
    bool or additive padding mask the plain SDPA route; token types on;
    the MLM loss on ``bert_mlm_mask`` labels."""
    jm, tm = _pair()
    ids, types, keep = _inputs()
    am = MASKS[mask](keep)
    mids, labels = tbert.bert_mlm_mask(ids, V, MASK_ID, seed=1)

    def f(state, x, y, t, m):
        with tape.no_grad():
            logits, loss = jm.functional_call(
                state, paddle.Tensor(x), labels=paddle.Tensor(y),
                token_type_ids=paddle.Tensor(t),
                attention_mask=None if m is None else paddle.Tensor(m))
        return loss._value, logits._value

    state = {k: v._value for k, v in jm.state_dict().items()}
    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(state, mids, labels, types, am)
    logits, loss = tm(mids, labels=labels, token_type_ids=types,
                      attention_mask=None if am is None
                      else torch.from_numpy(am))
    assert TF.get_last_attention_backend() == "plain"
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    grads = dict(tm.named_parameters())
    assert set(grads) == set(jgrads)
    for k, g in jgrads.items():
        np.testing.assert_allclose(grads[k].grad.numpy(), np.asarray(g),
                                   atol=5e-5, rtol=5e-5, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_mlm_mask_gives_jax_arrays(seed):
    ids = np.random.default_rng(seed).integers(0, V, (4, 64))
    special = (0, 1, 2)
    got = tbert.bert_mlm_mask(torch.from_numpy(ids), V, MASK_ID, seed=seed,
                              special_ids=special)
    want = jbert.bert_mlm_mask(ids, V, MASK_ID, seed=seed,
                               special_ids=special)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1] != tbert.IGNORE_INDEX).any()
    assert not np.isin(ids[got[1] != tbert.IGNORE_INDEX], special).any()


def test_masked_lm_loss_matches_jax_and_is_zero_when_nothing_is_masked():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32)
    labels = np.full((2, 6), -100)
    labels[0, 2], labels[1, 5] = 4, 9
    got = tbert.masked_lm_loss(torch.from_numpy(logits),
                               torch.from_numpy(labels))
    want = jbert.masked_lm_loss(paddle.to_tensor(logits),
                                paddle.to_tensor(labels))
    np.testing.assert_allclose(float(got), float(want._value), rtol=1e-6)
    none = np.full((2, 6), -100)
    zero = tbert.masked_lm_loss(torch.from_numpy(logits),
                                torch.from_numpy(none))
    assert float(zero) == 0.0 == float(jbert.masked_lm_loss(
        paddle.to_tensor(logits), paddle.to_tensor(none))._value)
    bf16 = tbert.masked_lm_loss(torch.from_numpy(logits).bfloat16(),
                                torch.from_numpy(labels))
    assert bf16.dtype == torch.float32


def test_sequence_past_max_position_raises():
    _, tm = _pair()
    ids = np.zeros((1, 129), np.int64)
    with pytest.raises(ValueError, match="max_position"):
        tm(ids)
    assert tm(ids[:, :128]).shape == (1, 128, V)


def test_trainstep_momentum_matches_jax():
    jm, tm = _pair()
    ids, types, _ = _inputs()
    mids, labels = tbert.bert_mlm_mask(ids, V, MASK_ID, seed=2)
    jopt = paddle.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                     parameters=jm.parameters())
    jstep = JaxTrainStep(jm, lambda logits, loss: loss, jopt)
    opt = topt.Momentum(learning_rate=0.05, momentum=0.9,
                        parameters=tm.parameters())
    step = TrainStep(tm, lambda logits, loss: loss, opt)
    before = to_paddle_tpu_state(tm)
    for _ in range(3):
        want = float(jstep(paddle.to_tensor(mids),
                           labels=paddle.to_tensor(labels),
                           token_type_ids=paddle.to_tensor(types)))
        got = float(step(torch.from_numpy(mids),
                         labels=torch.from_numpy(labels),
                         token_type_ids=torch.from_numpy(types)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    tstate = to_paddle_tpu_state(tm)
    assert max(float(np.abs(tstate[k] - before[k]).max())
               for k in tstate) > 1e-4
    for k, v in jm.state_dict().items():
        np.testing.assert_allclose(tstate[k], np.asarray(v._value),
                                   atol=1e-5, rtol=0, err_msg=k)
