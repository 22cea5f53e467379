"""Dropout in the port (``nn.functional.common``, ``nn.layer_common``,
attention dropout, ``GPTConfig.dropout``) held against the JAX package on
the CPU.

JAX draws its masks from ``jax.random`` and the port from its own default
generator (``framework.default_generator``), so training masks are held by
distribution pins, never by mask identity (ROADMAP C):

* inference (``training=False``) outputs equal JAX's exactly: identity for
  ``upscale_in_train``, x (1 - p) for ``downscale_in_infer``;
* the keep rate of 200,000 draws lies within 5 binomial standard
  deviations of 1 - p (a false alarm once in ~3.5 million runs); survivors
  are x / (1 - p) in x's dtype, the value JAX gives a survivor, exactly;
  ``axis`` (and ``dropout2d`` / ``dropout3d``) draws one mask entry per
  kept axis, broadcast over the rest; ``alpha_dropout`` keeps a standard
  normal's mean and variance within 5 standard errors, and takes only
  a x + b or a alpha' + b, JAX's values;
* attention dropout (the plain route, as JAX's XLA route) is the
  probabilities times one mask of their shape over 1 - p: equal to that
  sum recomputed from the same generator state, bit for bit;
* GPT with dropout in eval gives JAX's logits (within 1e-5, f32 sums in
  another order); in training the masks change the loss, one generator
  state gives one loss, and torch's global RNG is not touched;
* ``flash_attn_unpadded`` with dropout raises (JAX ignores it there).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import from_paddle_tpu_state
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import (
    default_generator,
    get_rng_state,
    seed,
    set_rng_state,
)
from paddle_tpu_torch.incubate.nn import memory_efficient_attention
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional.common import keep_mask

N = 200_000
SIGMAS = 5.0


def _x(shape, seed_=0):
    return np.random.default_rng(seed_).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_inference_outputs_equal_jax(mode, p):
    x = _x((4, 7))
    want = np.asarray(JF.dropout(paddle.to_tensor(x), p, training=False,
                                 mode=mode)._value)
    got = TF.dropout(torch.from_numpy(x), p, training=False, mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)
    layer = tnn.Dropout(p, mode=mode).eval()
    np.testing.assert_array_equal(layer(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_and_scaling(mode, p):
    x = torch.from_numpy(np.abs(_x(N)) + 0.5)
    out = TF.dropout(x, p, mode=mode)
    kept = out != 0
    rate = float(kept.float().mean())
    sd = math.sqrt(p * (1 - p) / N)
    assert abs(rate - (1 - p)) < SIGMAS * sd, rate
    want = x / (1.0 - p) if mode == "upscale_in_train" else x
    assert torch.equal(out[kept], want[kept])
    # JAX's survivors take the same values
    jout = np.asarray(JF.dropout(paddle.to_tensor(x[:64].numpy()), p,
                                 mode=mode)._value)
    jkept = jout != 0
    np.testing.assert_array_equal(jout[jkept], want[:64].numpy()[jkept])


def test_axis_broadcasts_the_mask_like_jax():
    x = torch.ones((64, 32, 9))
    out = TF.dropout(x, 0.5, axis=[0, 1])
    rows = out.reshape(-1, 9)
    assert bool(((rows == 0).all(1) | (rows != 0).all(1)).all())
    jout = np.asarray(JF.dropout(paddle.to_tensor(x.numpy()), 0.5,
                                 axis=[0, 1])._value).reshape(-1, 9)
    assert bool(((jout == 0).all(1) | (jout != 0).all(1)).all())
    rate = float((rows[:, 0] != 0).float().mean())
    assert abs(rate - 0.5) < SIGMAS * math.sqrt(0.25 / rows.shape[0])
    for fn, shape, fmt, ch in (
            (TF.dropout2d, (16, 8, 5, 5), "NCHW", 1),
            (TF.dropout2d, (16, 5, 5, 8), "NHWC", 3),
            (TF.dropout3d, (8, 8, 3, 3, 3), "NCDHW", 1),
            (TF.dropout3d, (8, 3, 3, 3, 8), "NDHWC", 4)):
        out = fn(torch.ones(shape), 0.5, data_format=fmt)
        per = out.movedim(ch, 1).reshape(shape[0], shape[ch], -1)
        assert bool(((per == 0).all(-1) | (per == 2).all(-1)).all()), fmt


def test_alpha_dropout_keeps_mean_and_variance():
    p = 0.2
    x = torch.from_numpy(_x(N, 5))
    out = tnn.AlphaDropout(p)(x)
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = 1.0 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5
    b = -a * alpha_p * p
    fill = float(torch.tensor(a * alpha_p + b, dtype=torch.float32))
    dropped = out == fill
    rate = float(dropped.float().mean())
    assert abs(rate - p) < SIGMAS * math.sqrt(p * (1 - p) / N)
    np.testing.assert_allclose(out[~dropped].numpy(),
                               (a * x[~dropped] + b).numpy(), rtol=1e-6)
    assert abs(float(out.mean())) < SIGMAS / math.sqrt(N)
    assert abs(float(out.var()) - 1.0) < SIGMAS * math.sqrt(2.0 / N)
    jout = np.asarray(JF.alpha_dropout(paddle.to_tensor(x[:1000].numpy()),
                                       p)._value)
    jfill = np.isclose(jout, fill, rtol=0, atol=1e-6)
    np.testing.assert_allclose(jout[~jfill], a * x[:1000].numpy()[~jfill]
                               + b, rtol=1e-5)
    assert torch.equal(tnn.AlphaDropout(p).eval()(x), x)


def test_masks_come_from_the_port_generator_not_torch_global():
    x = torch.ones(1000)
    g = torch.get_rng_state()
    state = get_rng_state("cpu")
    a = TF.dropout(x, 0.5)
    set_rng_state(state, "cpu")
    b = TF.dropout(x, 0.5)
    c = TF.dropout(x, 0.5)
    assert torch.equal(a, b) and not torch.equal(b, c)
    assert torch.equal(torch.get_rng_state(), g)
    gen = default_generator("cpu")
    seed(123)
    assert default_generator("cpu") is gen      # reseeded in place
    d = TF.dropout(x, 0.5)
    seed(123)
    assert torch.equal(TF.dropout(x, 0.5), d)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_dropout_is_one_mask_over_the_probabilities(causal):
    q, k, v = (torch.from_numpy(_x((2, 12, 4, 16), s)) for s in (1, 2, 3))
    p = 0.25
    state = get_rng_state("cpu")
    out, _ = TF.flash_attention(q, k, v, dropout=p, causal=causal)
    assert TF.get_last_attention_backend() == "plain"
    set_rng_state(state, "cpu")
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    s = torch.einsum("bhsd,bhtd->bhst", qh, kh) * (1.0 / math.sqrt(16))
    if causal:
        s = torch.where(torch.ones(12, 12, dtype=torch.bool).tril(), s,
                        torch.finfo(s.dtype).min)
    probs = torch.softmax(s, -1)
    keep = keep_mask(probs.shape, 1 - p, "cpu")
    want = torch.einsum("bhst,bhtd->bhsd",
                        torch.where(keep, probs / (1 - p), 0.0), vh)
    assert torch.equal(out, want.transpose(1, 2))
    ref, _ = TF.flash_attention(q, k, v, causal=causal)
    assert not torch.allclose(out, ref)
    # the bias route of memory_efficient_attention draws the same way
    bias = torch.zeros(1, 1, 12, 12)
    set_rng_state(state, "cpu")
    got = memory_efficient_attention(q, k, v, bias, p=p)
    set_rng_state(state, "cpu")
    probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.25, -1)
    keep = keep_mask(probs.shape, 1 - p, "cpu")
    want = torch.einsum("bhqk,bkhd->bqhd",
                        torch.where(keep, probs / (1 - p), 0.0), v)
    assert torch.equal(got, want)


def test_varlen_dropout_raises_naming_roadmap_c():
    q = torch.ones((16, 2, 16))
    cu = torch.tensor([0, 9, 16])
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        TF.flash_attn_unpadded(q, q, q, cu, cu, 9, 9, 0.25, dropout=0.1)
    out, _ = TF.flash_attn_unpadded(q, q, q, cu, cu, 9, 9, 0.25, dropout=0.1,
                                    training=False)
    assert out.shape == q.shape


TINY = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
            max_position=128, dropout=0.1)


def test_gpt_with_dropout_in_eval_equals_jax_logits():
    with paddle.utils.unique_name.guard():
        paddle.seed(4)
        jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**TINY))
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}
    tm = from_paddle_tpu_state(state, tgpt.GPTConfig(**TINY), device="cpu")
    ids = np.random.default_rng(0).integers(0, 1024, (2, 20))
    want = np.asarray(jm(paddle.to_tensor(ids))._value)
    assert tm.training                  # a JAX Layer starts in training
    tm.eval()
    got = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
    tm.train()
    labels = torch.from_numpy(np.roll(ids, -1, 1))
    st = get_rng_state("cpu")
    _, a = tm(torch.from_numpy(ids), labels=labels)
    _, b = tm(torch.from_numpy(ids), labels=labels)
    set_rng_state(st, "cpu")
    _, c = tm(torch.from_numpy(ids), labels=labels)
    assert torch.equal(a, c) and not torch.equal(a, b)
    with torch.no_grad():
        tm.eval()
        _, e = tm(torch.from_numpy(ids), labels=labels)
    assert not torch.equal(a, e)
