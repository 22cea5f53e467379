"""AMP O2 (``amp.decorate(level="O2")`` + ``amp.auto_cast(level="O2")``,
Paddle's standard recipe) on the port's models, held against the JAX
package on the CPU with the same weights (``bridge.py``).

Under O2 the JAX package casts every op it dispatches (``apply_op``) to
the amp dtype except the black list, which runs in f32, inside the
differentiated function (``paddle_tpu/ops/__init__.py:39-66``). The port
casts at seams of the same names (``amp._amp_cast``, ``ops.apply_like``).

* tiny GPT (both families), LLaMA and BERT: every module's output dtype
  (forward post-hooks on both, matched by name), the logits', the loss's
  (f32: JAX's black-listed ``mean``) and every gradient's equal JAX's;
  the loss within ``LOSS_TOL`` relative and every gradient within
  ``GRAD_TOL`` of its tensor's largest |gradient|: bf16 keeps 8
  significant bits, and the two packages round the same activations at
  other places (XLA's excess precision, the order of sums), so the gaps
  are not 0 (measured: see ``CASES``).
* a ``custom_white_list`` that takes ``mean`` off the black list leaves
  the loss in bf16 on both.
* one ``TrainStep`` (AdamW, multi-precision) under the same context
  gives JAX's ``TrainStep``'s parameters.
"""
import contextlib
import functools

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch
from paddle_tpu.autograd import tape
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import from_paddle_tpu_state
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama
from port_bodies import on_cpu  # noqa: F401

GPT = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
           max_position=64)
GPT2 = dict(GPT, use_rope=False, use_rms_norm=False, use_swiglu=False,
            tie_embeddings=False)


def _configs(name):
    """(JAX model, port config) of model ``name``."""
    if name in ("gpt", "gpt2"):
        kw = GPT if name == "gpt" else GPT2
        return (jgpt.GPTForCausalLM(jgpt.GPTConfig(**kw)),
                tgpt.GPTConfig(**kw))
    if name == "llama":
        return jllama.LlamaForCausalLM(jllama.llama_tiny()), \
            tllama.llama_tiny()
    return jbert.BertForMaskedLM(jbert.bert_tiny()), tbert.bert_tiny()


def _pair(name):
    with paddle.utils.unique_name.guard():
        paddle.seed(31)
        jm, cfg = _configs(name)
    state = {k: np.asarray(v) for k, v in jm.raw_state().items()}
    tm = from_paddle_tpu_state(state, cfg, device="cpu")
    paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
    tamp.decorate(tm, level="O2", dtype="bfloat16")
    return jm, tm


def _batch(name):
    rng = np.random.default_rng(0)
    if name == "bert":
        ids = rng.integers(4, 512, (2, 16))
        mids, labels = tbert.bert_mlm_mask(ids, 512, 3, seed=1)
        types = (np.arange(16)[None] >= 8).astype(np.int64).repeat(2, 0)
        return {"x": mids, "labels": labels, "token_type_ids": types}
    ids = rng.integers(0, 512, (2, 24))
    return {"x": ids, "labels": np.roll(ids, -1, 1)}


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "").replace("paddle.", "")


def _jax_run(jm, batch, kw):
    seen = {}
    hooks = [layer.register_forward_post_hook(
        lambda l, i, o, n=name: seen.__setitem__(
            n, str(getattr(o, "dtype", None)).replace("paddle.", "")))
        for name, layer in jm.named_sublayers()]
    rest = {k: v for k, v in batch.items() if k != "x"}

    def f(state, x, r):
        with tape.no_grad():
            logits, loss = jm.functional_call(
                state, paddle.Tensor(x),
                **{k: paddle.Tensor(v) for k, v in r.items()})
        return loss._value, logits._value

    state = {k: v._value for k, v in jm.state_dict().items()}
    with paddle.amp.auto_cast(**kw):
        (loss, logits), grads = jax.jit(jax.value_and_grad(
            f, has_aux=True))(state, batch["x"], rest)
    for h in hooks:
        h.remove()
    return seen, logits, loss, grads


def _port_run(tm, batch, kw):
    seen = {}
    hooks = [m.register_forward_hook(
        lambda m, i, o, n=name: seen.__setitem__(
            n, _dtype_name(o[0] if isinstance(o, tuple) else o)))
        for name, m in tm.named_modules() if name]
    rest = {k: torch.from_numpy(v) for k, v in batch.items() if k != "x"}
    with tamp.auto_cast(**kw):
        logits, loss = tm(torch.from_numpy(batch["x"]), **rest)
    loss.backward()
    for h in hooks:
        h.remove()
    return seen, logits, loss


O2 = dict(level="O2", dtype="bfloat16")
O2_WHITE_MEAN = dict(O2, custom_white_list={"mean"})


@functools.lru_cache(maxsize=None)
def _jax_answers(name, white_mean=False):
    jm, _ = _pair(name)
    return _jax_run(jm, _batch(name), O2_WHITE_MEAN if white_mean else O2)


MODELS = ["gpt", "gpt2", "llama", "bert"]
# (logits over the largest |logit|, loss relative, gradient over its
# tensor's largest |gradient|): about twice the gaps measured on the CPU
# (logits 0.0086-0.014, loss 0-8.4e-4, gradients 0.019-0.031)
LOGIT_TOL, LOSS_TOL, GRAD_TOL = 2 ** -5, 2e-3, 2 ** -4


@pytest.mark.parametrize("name", MODELS)
def test_o2_dtypes_values_and_gradients_match_jax(name):
    _, tm = _pair(name)
    jseen, jlogits, jloss, jgrads = _jax_answers(name)
    tseen, tlogits, tloss = _port_run(tm, _batch(name), O2)
    common = set(tseen) & set(jseen)
    assert len(common) >= len(jseen) - 1, set(jseen) - set(tseen)
    diff = {k: (tseen[k], jseen[k]) for k in common if tseen[k] != jseen[k]}
    assert not diff, diff
    assert _dtype_name(tlogits) == str(jlogits.dtype) == "bfloat16"
    # JAX's black-listed ``mean`` (BERT: ``mlm_loss`` in f32) makes it f32
    assert _dtype_name(tloss) == str(jloss.dtype) == "float32"
    jl = np.asarray(jlogits.astype(np.float32))
    np.testing.assert_allclose(tlogits.detach().float().numpy(), jl, rtol=0,
                               atol=LOGIT_TOL * np.abs(jl).max())
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    params = dict(tm.named_parameters())
    assert set(params) == set(jgrads)
    for k, g in jgrads.items():
        got = params[k].grad
        assert _dtype_name(got) == str(g.dtype), k
        want = np.asarray(g.astype(np.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(want).max()),
                                   err_msg=k)


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_custom_white_list_takes_mean_off_the_black_list(name):
    """``custom_white_list={"mean"}`` overrides the black list: the loss
    stays in bf16 on both packages."""
    _, tm = _pair(name)
    _, _, jloss, _ = _jax_answers(name, white_mean=True)
    _, _, tloss = _port_run(tm, _batch(name), O2_WHITE_MEAN)
    assert _dtype_name(tloss) == str(jloss.dtype) == "bfloat16"
    np.testing.assert_allclose(float(tloss.detach().float()),
                               float(jloss.astype(np.float32)),
                               rtol=2 ** -7)


def test_cast_target_follows_jax_o2_rule():
    with tamp.auto_cast(level="O2"):
        x = torch.ones(2)
        assert tamp._amp_cast("linear", x)[0].dtype == torch.bfloat16
        assert tamp._amp_cast("add", x)[0].dtype == torch.bfloat16
        assert tamp._amp_cast("mean", x.bfloat16())[0].dtype == \
            torch.float32
    with tamp.auto_cast(level="O2", custom_white_list={"softmax"}):
        assert tamp._amp_cast("softmax", x)[0].dtype == torch.bfloat16
    with tamp.auto_cast(level="O2", custom_black_list={"linear"}):
        assert tamp._amp_cast("linear", x.bfloat16())[0].dtype == \
            torch.float32
    with tamp.auto_cast(level="O1"):
        assert tamp._amp_cast("add", x)[0].dtype == torch.float32


LR = 1e-2


@pytest.mark.parametrize("name", ["gpt", "bert"])
def test_train_step_under_o2_matches_jax_train_step(name):
    """One ``TrainStep`` of AdamW (multi-precision: f32 master weights)
    under ``auto_cast(O2)`` on both packages: the bf16 parameters after it
    within a bf16 rounding and 2 lr of JAX's (Adam's first step moves each
    weight by about lr, in the sign of its gradient, which flips where the
    two gradients straddle 0; each side's new value is rounded to bf16,
    2^-8 of its size, hence the 2^-6 of slack on the 2 lr)."""
    from paddle_tpu.jit.train import TrainStep as JaxTrainStep
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch import to_paddle_tpu_state
    from paddle_tpu_torch.jit import TrainStep

    jm, tm = _pair(name)
    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jm.parameters())
    jopt._multi_precision = True
    opt = topt.AdamW(learning_rate=LR, parameters=tm.parameters())
    opt._multi_precision = True
    batch = _batch(name)
    rest = {k: v for k, v in batch.items() if k != "x"}
    before = to_paddle_tpu_state(tm)
    with paddle.amp.auto_cast(**O2):
        jloss = JaxTrainStep(jm, lambda lg, loss: loss, jopt)(
            paddle.to_tensor(batch["x"]),
            **{k: paddle.to_tensor(v) for k, v in rest.items()})
    with tamp.auto_cast(**O2):
        tloss = TrainStep(tm, lambda lg, loss: loss, opt)(
            torch.from_numpy(batch["x"]),
            **{k: torch.from_numpy(v) for k, v in rest.items()})
    assert _dtype_name(tloss) == "float32"
    np.testing.assert_allclose(float(tloss.detach()),
                               float(np.asarray(jloss._value)),
                               rtol=LOSS_TOL)
    after = to_paddle_tpu_state(tm)
    moved = 0
    for k, v in jm.state_dict().items():
        want = np.asarray(v._value.astype("float32"))
        assert _dtype_name(dict(tm.named_parameters())[k]) == str(v.dtype)
        np.testing.assert_allclose(after[k], want, rtol=2 ** -7,
                                   atol=2 * LR * (1 + 2 ** -6),
                                   err_msg=k)
        moved += int((after[k] != before[k]).sum())
    assert moved > 0.5 * sum(a.size for a in after.values())


def _fused(pkg, name, amp):
    """One incubate fused functional on both packages' inputs, under O2 or
    not: (output, its dtype)."""
    inc = pkg.incubate.nn.functional
    rng = np.random.default_rng(5)
    x, r = (rng.standard_normal((3, 8)).astype(np.float32) for _ in "ab")
    w, b = rng.standard_normal((8,)).astype(np.float32), \
        rng.standard_normal((8,)).astype(np.float32)
    wl = rng.standard_normal((8, 6)).astype(np.float32)
    t = pkg.to_tensor
    calls = {
        "fused_linear": lambda: inc.fused_linear(t(x), t(wl), t(b[:6])),
        "fused_bias_act": lambda: inc.fused_bias_act(t(x), t(b)),
        "fused_bias_act_swiglu": lambda: inc.fused_bias_act(
            t(x), t(b), act_method="swiglu"),
        "fused_rms_norm": lambda: inc.fused_rms_norm(t(x), t(w), t(b),
                                                     residual=t(r)),
        "fused_layer_norm": lambda: inc.fused_layer_norm(t(x), t(w), t(b),
                                                         bias=t(r)),
        "fused_dropout_add": lambda: inc.fused_dropout_add(
            t(x), t(r), p=0.5, training=False),
        "swiglu": lambda: inc.swiglu(t(x)),
    }
    amp = pkg.amp.auto_cast(**O2) if amp else contextlib.nullcontext()
    with amp:
        out = calls[name]()
    out = out[0] if isinstance(out, tuple) else out
    arr = (out._value.float().numpy() if pkg is paddle_tpu_torch
           else np.asarray(out._value.astype("float32")))
    return arr, _dtype_name(out)


FUSED = ["fused_linear", "fused_bias_act", "fused_bias_act_swiglu",
         "fused_rms_norm", "fused_layer_norm", "fused_dropout_add", "swiglu"]


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "o2"])
@pytest.mark.parametrize("name", FUSED)
def test_incubate_fused_functionals_match_jax(name, amp, on_cpu):
    """Values within 1e-5 in f32 and within bf16's 2^-7 relative (of the
    largest |value|) under O2, and JAX's dtype: the amp dtype under O2
    (none of these ops is black-listed)."""
    got, gdt = _fused(paddle_tpu_torch, name, amp)
    want, wdt = _fused(paddle, name, amp)
    assert gdt == wdt == ("bfloat16" if amp else "float32")
    tol = 2 ** -7 * np.abs(want).max() if amp else 1e-5
    np.testing.assert_allclose(got, want, rtol=0 if amp else 1e-5, atol=tol)
