"""AMP O1 (``amp.auto_cast``) and ``GradScaler`` of the port held against
the JAX package on the CPU, on ``gpt_tiny`` (the same weights through
``bridge.py``).

* Under ``auto_cast`` every module of the model returns the dtype JAX's
  returns (forward post-hooks on both, matched by name), and so do the
  logits, the loss and every gradient: f32 parameters under bf16 and f16;
  bf16 parameters (``decorate``) under bf16, with and without a custom
  white list taking ``exp`` / ``sum`` / ``log`` / ``mean`` off the black
  list; and a custom black list holding ``linear`` in f32. The tied head
  (``lm_head_tied``, on neither list) runs in its inputs' dtype, where
  ``torch.autocast`` would cast it.
* The loss (relative) and every gradient (against the largest |gradient|
  of its tensor) within each case's own limit, ``CASE_TOL``: about twice
  the gap measured for that case, never above 2^-5 of the largest
  gradient. The two packages round the same activations at other places
  (XLA's excess precision, JAX's bf16 scores against the port's f32 ones
  in attention), so the gaps are not 0.
* The limits are tight enough to see a misplaced cast that leaves every
  output dtype as it was: with ``exp``, ``sum`` and ``log`` of the cross
  entropy run in the amp dtype instead of f32 (a black-listed op planted
  into the amp dtype), each case where those ops are black-listed falls
  outside its limit.
* Nested ``auto_cast`` blocks restore the outer state; under
  ``level="O2"`` a model's seam casts to the amp dtype
  (``test_torch_amp_o2.py`` holds O2 to JAX).
* ``GradScaler``: a scripted run of finite and non-finite gradients, with
  one optimizer and with two sharing a scaler, gives JAX's scale, good and
  bad counts and ``state_dict`` after every step, and the parameters move
  only on the finite steps.
"""
import contextlib
import functools

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.autograd import tape
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import from_paddle_tpu_state
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import gpt as tgpt

TINY = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
            max_position=128)
# (params dtype, amp dtype, custom white list, custom black list)
CASES = {
    "f32-bf16": ("float32", "bfloat16", None, None),
    "f32-f16": ("float32", "float16", None, None),
    "bf16-bf16": ("bfloat16", "bfloat16", None, None),
    "bf16-white": ("bfloat16", "bfloat16", {"exp", "sum", "log", "mean"},
                   None),
    "f32-black-linear": ("float32", "bfloat16", None, {"linear"}),
}
TOL = {"bfloat16": (2 ** -7, 2 ** -5), "float16": (2 ** -10, 2 ** -8)}
# per case: (loss rtol, gradient atol over the largest |gradient| of its
# tensor), about twice the gaps measured on the CPU (loss, gradient):
# bf16-bf16 5.8e-5, 0.026 (held at 2^-5); bf16-white 0, 0.019;
# f32-bf16 3.7e-6, 0.011; f32-black-linear 6.9e-8, 9.6e-7;
# f32-f16 3.5e-6, 0.0018
CASE_TOL = {
    "bf16-bf16": (2 ** -13, 2 ** -5),
    "bf16-white": (2 ** -13, 2 ** -5),
    "f32-bf16": (8e-6, 0.022),
    "f32-black-linear": (1.5e-7, 2e-6),
    "f32-f16": (8e-6, 0.004),
}


def _pair():
    with paddle.utils.unique_name.guard():
        paddle.seed(21)
        jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**TINY))
    state = {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}
    return jm, from_paddle_tpu_state(state, tgpt.GPTConfig(**TINY),
                                     device="cpu")


def _batch():
    ids = np.random.default_rng(0).integers(0, 1024, (2, 24))
    return ids, np.roll(ids, -1, 1)


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "").replace("paddle.", "")


def _jax_run(jm, ids, labels, kw):
    """(module output dtypes, logits, loss, grads) of the JAX model: its
    forward traced under auto_cast (the cast hook reads the state while
    tracing), differentiated by one jitted value_and_grad."""
    seen = {}
    hooks = [layer.register_forward_post_hook(
        lambda l, i, o, n=name: seen.__setitem__(
            n, str(getattr(o, "dtype", None))))
        for name, layer in jm.named_sublayers()]

    def f(state, x, y):
        with tape.no_grad():
            logits, loss = jm.functional_call(state, paddle.Tensor(x),
                                              labels=paddle.Tensor(y))
        return loss._value, logits._value

    state = {k: v._value for k, v in jm.state_dict().items()}
    with paddle.amp.auto_cast(**kw):
        (loss, logits), grads = jax.jit(jax.value_and_grad(
            f, has_aux=True))(state, ids, labels)
    for h in hooks:
        h.remove()
    return seen, logits, loss, grads


def _port_run(tm, ids, labels, kw):
    seen = {}
    hooks = [m.register_forward_hook(
        lambda m, i, o, n=name: seen.__setitem__(n, _dtype_name(o)))
        for name, m in tm.named_modules() if name]
    with tamp.auto_cast(**kw):
        logits, loss = tm(torch.from_numpy(ids),
                          labels=torch.from_numpy(labels))
    loss.backward()
    for h in hooks:
        h.remove()
    return seen, logits, loss


def _models(case):
    pdt = CASES[case][0]
    jm, tm = _pair()
    if pdt != "float32":
        paddle.amp.decorate(jm, level="O2", dtype=pdt)
        tamp.decorate(tm, level="O2", dtype=pdt)
    return jm, tm


def _amp_kw(case):
    _, adt, white, black = CASES[case]
    return dict(level="O1", dtype=adt, custom_white_list=white,
                custom_black_list=black)


@functools.lru_cache(maxsize=None)
def _jax_answers(case):
    jm, _ = _models(case)
    return _jax_run(jm, *_batch(), _amp_kw(case))


def _gaps(tloss, tm, jloss, jgrads):
    """(|loss gap| / |JAX loss|, the largest gradient gap of any tensor over
    that tensor's largest |JAX gradient|)."""
    want = float(jloss.astype(np.float32))
    loss = abs(float(tloss.detach().float()) - want) / abs(want)
    params = dict(tm.named_parameters())
    grad = max(float(np.abs(params[k].grad.float().numpy() - np.asarray(
        g.astype(np.float32))).max() / np.abs(np.asarray(
            g.astype(np.float32))).max()) for k, g in jgrads.items())
    return loss, grad


@pytest.mark.parametrize("case", sorted(CASES))
def test_o1_dtypes_loss_and_gradients_match_jax(case):
    pdt = CASES[case][0]
    _, tm = _models(case)
    jseen, jlogits, jloss, jgrads = _jax_answers(case)
    tseen, tlogits, tloss = _port_run(tm, *_batch(), _amp_kw(case))
    jseen = {k: v.replace("paddle.", "") for k, v in jseen.items()}
    assert set(tseen) == set(jseen), set(tseen) ^ set(jseen)
    assert tseen == jseen
    assert _dtype_name(tlogits) == str(jlogits.dtype)
    assert _dtype_name(tloss) == str(jloss.dtype)
    if case == "bf16-white":
        assert str(jloss.dtype) == "bfloat16"     # CE kept in bf16
    elif pdt != "float32" or case == "f32-black-linear":
        assert str(jloss.dtype) == "float32"
    if case == "f32-bf16":     # linear in bf16, the tied head in f32
        assert tseen["gpt.blocks.0.attn.qkv_proj"] == "bfloat16"
        assert str(jlogits.dtype) == "float32"
    rl, rg = CASE_TOL[case]
    np.testing.assert_allclose(float(tloss.detach().float()), float(
        jloss.astype(np.float32)), rtol=rl)
    params = dict(tm.named_parameters())
    assert set(params) == set(jgrads)
    for k, g in jgrads.items():
        got = params[k].grad
        assert _dtype_name(got) == str(g.dtype), k
        want = np.asarray(g.astype(np.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=rg * float(np.abs(want).max()),
                                   err_msg=k)


@pytest.mark.parametrize("case", ["bf16-bf16", "f32-bf16",
                                  "f32-black-linear", "f32-f16"])
def test_o1_limits_catch_a_black_listed_op_in_the_amp_dtype(case,
                                                            monkeypatch):
    """The cross entropy's ``exp``, ``sum`` and ``log`` (black-listed: f32
    under O1) planted into the amp dtype: every output dtype of the model
    stays as it was, and the loss or a gradient leaves its case's limit."""
    from paddle_tpu_torch.distributed.fleet import meta_parallel

    sound = meta_parallel._amp_cast

    def planted(name, *tensors):
        if name in ("exp", "sum", "log"):
            dt = tamp.get_amp_dtype()
            return tuple(t.to(dt) if t.is_floating_point() else t
                         for t in tensors)
        return sound(name, *tensors)

    monkeypatch.setattr(meta_parallel, "_amp_cast", planted)
    _, tm = _models(case)
    jseen, _, jloss, jgrads = _jax_answers(case)
    tseen, _, tloss = _port_run(tm, *_batch(), _amp_kw(case))
    assert tseen == {k: v.replace("paddle.", "") for k, v in jseen.items()}
    loss, grad = _gaps(tloss, tm, jloss, jgrads)
    rl, rg = CASE_TOL[case]
    assert loss > rl or grad > rg, (loss, grad)


def test_nested_auto_cast_restores_the_outer_state():
    assert not tamp.is_auto_cast_enabled()
    with tamp.auto_cast(dtype="float16", custom_black_list={"linear"}):
        assert tamp.get_amp_dtype() == torch.float16
        assert "linear" in tamp.black_list()
        with tamp.amp_guard(enable=False):
            assert not tamp.is_auto_cast_enabled()
        with tamp.auto_cast(dtype="bfloat16", custom_white_list={"exp"}):
            assert tamp.get_amp_dtype() == torch.bfloat16
            assert "exp" not in tamp.black_list()
            assert "linear" not in tamp.black_list()
        assert tamp.is_auto_cast_enabled()
        assert tamp.get_amp_dtype() == torch.float16
        assert "linear" in tamp.black_list()
    assert not tamp.is_auto_cast_enabled()
    assert tamp.white_list() == paddle.amp.white_list()
    assert tamp.black_list() == paddle.amp.black_list()
    # O2 casts every op but the black list, the models' seams too
    with tamp.auto_cast(level="O2"):
        assert tamp.get_amp_level() == "O2"
        assert tamp._amp_cast("linear", torch.ones(2))[0].dtype == \
            torch.bfloat16
    with pytest.raises(NotImplementedError, match="OD"):
        with tamp.auto_cast(level="OD"):
            pass


def test_decorate_takes_float16():
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY), device="cpu")
    opt = topt.AdamW(parameters=tm.parameters())
    tamp.decorate(tm, opt, level="O2", dtype="float16")
    assert {p.dtype for p in tm.parameters()} == {torch.float16}
    assert opt._multi_precision


# each step: per optimizer, "ok" (finite gradients) or "inf"
SCRIPT = ["ok", "ok", "inf", "ok", "inf", "inf", "ok", "ok", "ok"]
SCALER = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)


def _grads(step, bad, shape):
    g = np.full(shape, 0.5 * (step + 1), np.float32)
    if bad:
        g[0] = np.inf
    return g


@pytest.mark.parametrize("two_optimizers", [False, True])
def test_grad_scaler_state_machine_matches_jax(two_optimizers):
    n_opt = 2 if two_optimizers else 1
    w0 = [np.ones(3, np.float32) * (i + 1) for i in range(n_opt)]
    jp = [paddle.to_tensor(w, stop_gradient=False) for w in w0]
    tp = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in w0]
    jopts = [paddle.optimizer.SGD(0.1, parameters=[p]) for p in jp]
    topts = [topt.SGD(0.1, parameters=[p]) for p in tp]
    js, ts = paddle.amp.GradScaler(**SCALER), tamp.GradScaler(**SCALER)
    assert ts.scale(torch.tensor(2.0)) == 2048.0
    for step, kind in enumerate(SCRIPT):
        before = [p.detach().clone() for p in tp]
        for i in range(n_opt):
            # with two optimizers only the second sees the inf: found-inf
            # is ORed across them
            bad = kind == "inf" and i == n_opt - 1
            g = _grads(step, bad, 3) * js.get_init_loss_scaling()
            jp[i].grad = paddle.to_tensor(g)
            tp[i].grad = torch.from_numpy(g.copy())
        for jo, to in zip(jopts, topts):
            js.unscale_(jo)
            ts.unscale_(to)
            js.unscale_(jo)       # a second call in one step is a no-op
            ts.unscale_(to)
        for jo, to in zip(jopts, topts):
            if not js._found_inf:
                jo.step()
            if not bool(ts._found_inf):
                to.step()
        js.update()
        ts.update()
        assert ts.state_dict() == js.state_dict(), step
        for a, b, old in zip(jp, tp, before):
            np.testing.assert_allclose(b.detach().numpy(),
                                       np.asarray(a.numpy()), rtol=1e-6)
            assert torch.equal(b.detach(), old) == (kind == "inf"), step
    assert ts.get_init_loss_scaling() == js.get_init_loss_scaling()


def test_grad_scaler_step_skips_on_inf_and_halves_the_scale():
    p = torch.nn.Parameter(torch.ones(2))
    opt = topt.SGD(0.5, parameters=[p])
    scaler = tamp.GradScaler(init_loss_scaling=8.0)
    loss = scaler.scale((p * torch.tensor([1.0, float("inf")])).sum())
    loss.backward()
    scaler.step(opt)
    assert torch.equal(p.detach(), torch.ones(2))
    assert scaler.get_init_loss_scaling() == 4.0
    opt.clear_grad()
    scaler.minimize(opt, scaler.scale((p * 2.0).sum()))
    np.testing.assert_allclose(p.detach().numpy(), [0.0, 0.0])
    state = scaler.state_dict()
    other = tamp.GradScaler()
    other.load_state_dict(state)
    assert other.state_dict()["scale"] == 4.0
    assert other.state_dict()["incr_count"] == 1


def _two_steps(make, inside_second):
    """Losses of two TrainStep calls, the first under auto_cast(bf16), the
    second under it too or not."""
    step, batch = make()
    losses = []
    for i in range(2):
        if i == 0 or inside_second:
            ctx = (paddle.amp.auto_cast(dtype="bfloat16")
                   if step[1] == "jax" else tamp.auto_cast(dtype="bfloat16"))
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            losses.append(float(np.asarray(step[0](*batch)._value
                                           if step[1] == "jax"
                                           else step[0](*batch).detach())))
    return losses


def test_train_step_keeps_the_amp_state_of_its_first_call():
    """JAX's step key holds no AMP state: a step compiled under auto_cast
    keeps its casts when later called outside it. The port's TrainStep runs
    a key's program under its first call's AMP state (captured on the card,
    the body on the CPU), so the second call's loss is the one a call under
    auto_cast gives, in both packages (ROADMAP C)."""
    from paddle_tpu.jit.train import TrainStep as JaxTrainStep
    from paddle_tpu_torch.jit import TrainStep

    ids, labels = _batch()

    def make_jax():
        jm, _ = _pair()
        opt = paddle.optimizer.SGD(0.5, parameters=jm.parameters())
        return ((JaxTrainStep(jm, lambda lg, loss: loss, opt), "jax"),
                (paddle.to_tensor(ids), paddle.to_tensor(labels)))

    def make_port():
        _, tm = _pair()
        opt = topt.SGD(0.5, parameters=tm.parameters())
        return ((TrainStep(tm, lambda lg, loss: loss, opt), "port"),
                (torch.from_numpy(ids), torch.from_numpy(labels)))

    jl, tl = _two_steps(make_jax, False), _two_steps(make_port, False)
    assert jl == _two_steps(make_jax, True)
    assert tl == _two_steps(make_port, True)
    np.testing.assert_allclose(tl, jl, rtol=TOL["bfloat16"][0])
