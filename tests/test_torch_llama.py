"""The port's LLaMA (``paddle_tpu_torch/models/llama.py``) held against the
JAX package's on the CPU, on ``llama_tiny`` (4 q heads over 2 kv heads) in
f32, with JAX's weights carried over by ``bridge.py``.

Tolerances (f32 sums in another order, as in the GPT parity tests):

* logits within 1e-5 absolute, the loss within 1e-6 relative, every
  gradient within 5e-5 of ``jax.grad``'s;
* ``recompute`` "block" and "dots": the loss and gradients of the same
  model without recompute, bit for bit;
* paged ``prefill_chunk`` / ``decode_step`` logits within 1e-4 of JAX's
  ``decode_kernel="xla"`` step path; greedy tokens of ``generate()``, the
  continuous scheduler and ``/generate`` identical to JAX greedy, after a
  top-1 / top-2 logit margin of 1e-3 is asserted on the port's forward;
* three ``TrainStep`` steps of AdamW: losses within 1e-5 relative,
  parameters within 1e-5.
"""
import io
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.autograd import tape
from paddle_tpu.inference.kv_cache import PagedKVCache as JaxPagedKVCache
from paddle_tpu.inference.scheduler import (
    ContinuousGenerateBatchingPredictor as JaxContinuous,
)
from paddle_tpu.jit.train import TrainStep as JaxTrainStep
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import from_paddle_tpu_state, to_paddle_tpu_state
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.inference import (
    ContinuousGenerateBatchingPredictor,
    InferenceServer,
    PagedKVCache,
)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import llama as tllama

V = 512
LOGIT_TOL = 1e-4
MARGIN = 1e-3           # top-1 minus top-2 logit; > 2 * LOGIT_TOL


def _pair(seed=11, eval_mode=True, **kw):
    with paddle.utils.unique_name.guard():
        paddle.seed(seed)
        jm = jllama.LlamaForCausalLM(jllama.llama_tiny())
    state = {k: np.asarray(v) for k, v in jm.raw_state().items()}
    cfg = tllama.llama_tiny()
    for k, v in kw.items():
        setattr(cfg, k, v)
    tm = from_paddle_tpu_state(state, cfg, device="cpu")
    if eval_mode:
        jm.eval()
        tm.eval()
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _batch(B=2, S=24, seed=0):
    ids = np.random.default_rng(seed).integers(0, V, (B, S))
    return ids, np.roll(ids, -1, axis=1)


@pytest.fixture(scope="module")
def jax_grads():
    """(logits, loss, {name: grad}) of JAX's model on ``_batch()``: one
    jitted ``value_and_grad`` over its functional call."""
    jm, _ = _pair(eval_mode=False)
    ids, labels = _batch()

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


def _port_loss_and_grads(recompute=None):
    _, tm = _pair(eval_mode=False, recompute=recompute)
    ids, labels = _batch()
    logits, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    return logits.detach(), loss.detach(), {
        k: p.grad for k, p in tm.named_parameters()}


def test_bridge_names_are_jax_names(pair):
    jm, tm = pair
    assert set(to_paddle_tpu_state(tm)) == set(jm.state_dict())
    assert "lm_head.weight" in to_paddle_tpu_state(tm)


def test_logits_loss_and_gradients_match_jax(jax_grads):
    jlogits, jloss, jgrads = jax_grads
    logits, loss, grads = _port_loss_and_grads()
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-6)
    assert set(grads) == set(jgrads)
    for k, g in jgrads.items():
        np.testing.assert_allclose(grads[k].numpy(), g, atol=5e-5,
                                   rtol=5e-5, err_msg=k)


@pytest.mark.parametrize("policy", ["block", "dots"])
def test_recompute_gives_the_loss_and_gradients_of_none(policy):
    _, ref_loss, ref = _port_loss_and_grads()
    _, loss, got = _port_loss_and_grads(policy)
    assert torch.equal(loss, ref_loss)
    for k, g in ref.items():
        assert torch.equal(got[k], g), k


def _jax_chunk_logits(jm, kv, chunk, offs, lens, tables):
    C = chunk.shape[1]
    valid = np.arange(C)[None, :] < lens[:, None]

    @jax.jit
    def call(state, ids, caches, offs, tbl, vld):
        return jm._decode_call(state, ids, caches, offs, "xla",
                               paged_tables=tbl, cache_valid=vld)

    logits, caches = call(
        jm.model_state_raw(), jnp.asarray(chunk),
        list(zip(kv.k_pages, kv.v_pages)), jnp.asarray(offs, jnp.int32),
        jnp.asarray(tables, jnp.int32), jnp.asarray(valid))
    kv.commit([k for k, _ in caches], [v for _, v in caches])
    return np.asarray(logits)[np.arange(len(lens)), np.maximum(lens - 1, 0)]


def _greedy_with_margin(lg):
    top2 = np.sort(lg, axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > MARGIN).all(), \
        f"near-tie: margins {top2[:, 1] - top2[:, 0]}"
    return lg.argmax(-1)


def test_paged_step_logits_and_tokens_match_jax(pair):
    """Two prompts prefilled in one chunk, then three one-token decode
    forwards over what they wrote: last-position logits within 1e-4 of
    JAX's step path, and the port's step programs (``prefill_chunk``,
    ``decode_step``) give the margin-checked greedy chain."""
    jm, tm = pair
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, V, 7), rng.integers(0, V, 5)]
    C = 8
    chunk = np.zeros((2, C), np.int64)
    for i, p in enumerate(prompts):
        chunk[i, :len(p)] = p
    lens = np.array([len(p) for p in prompts])
    offs = np.zeros(2, np.int64)
    spec = jm._decode_cache_spec()
    assert tuple(tm._decode_cache_spec()) == tuple(spec)
    jkv = JaxPagedKVCache(*spec, block_size=4, num_blocks=12,
                          dtype="float32")
    tkv = PagedKVCache(*spec, block_size=4, num_blocks=12,
                       dtype=torch.float32, device="cpu")
    tables = [np.stack([kv.reserve(i, 12) for i in range(2)])
              for kv in (jkv, tkv)]
    ref = _jax_chunk_logits(jm, jkv, chunk, offs, lens, tables[0])
    got = tm.chunk_logits(chunk, offs, lens, tkv, tables[1]).numpy()
    np.testing.assert_allclose(got, ref, atol=LOGIT_TOL, rtol=0)
    chain = [_greedy_with_margin(got)]
    length = lens.copy()
    for _ in range(3):
        ref = _jax_chunk_logits(jm, jkv, chain[-1][:, None], length,
                                np.ones(2, np.int64), tables[0])
        got = tm.chunk_logits(chain[-1][:, None], length,
                              np.ones(2, np.int64), tkv, tables[1]).numpy()
        np.testing.assert_allclose(got, ref, atol=LOGIT_TOL, rtol=0)
        chain.append(_greedy_with_margin(got))
        length = length + 1
    chain = np.stack(chain, axis=1)
    kv = PagedKVCache(*spec, block_size=4, num_blocks=12,
                      dtype=torch.float32, device="cpu")
    tbl = np.stack([kv.reserve(i, 12) for i in range(2)])
    first = tm.prefill_chunk(chunk, offs, lens, kv, tbl)
    rest = tm.decode_step(np.asarray(first), lens, np.ones(2, bool), kv,
                          tbl, steps=3, max_lens=lens + 4)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(first)[:, None], np.asarray(rest)], 1),
        chain)


@torch.no_grad()
def _assert_margins(tm, out, P):
    lg = tm(torch.as_tensor(np.asarray(out))).float()[:, P - 1:-1]
    top2 = lg.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    assert bool((gap > MARGIN).all()), f"near-tie: min margin {gap.min()}"


def test_generate_greedy_tokens_match_jax(pair):
    jm, tm = pair
    ids = np.random.default_rng(4).integers(0, V, (2, 6))
    got = tm.generate(ids, max_new_tokens=8, dtype=None).numpy()
    _assert_margins(tm, got, 6)
    want = np.asarray(jm.generate(paddle.to_tensor(ids), max_new_tokens=8,
                                  dtype=None, decode_kernel="xla")._value)
    np.testing.assert_array_equal(got, want)


def _run_concurrently(gp, prompts):
    results = {}
    ts = [threading.Thread(target=lambda i=i: results.update(
        {i: gp.infer(prompts[i], timeout=120)})) for i in range(len(prompts))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    return [results[i] for i in range(len(prompts))]


def test_continuous_scheduler_and_http_match_jax(pair):
    """Three mixed-length greedy requests through both continuous
    schedulers give JAX's sequences (margins asserted on the port's), and
    one prompt over ``/generate`` gives its in-process answer."""
    jm, tm = pair
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, V, n).astype(np.int64) for n in (3, 9, 6)]
    knobs = dict(max_slots=2, prefill_chunk=4, decode_steps=2,
                 max_new_tokens=5, max_seq_len=24)
    spec = jm._decode_cache_spec()
    jgp = JaxContinuous(jm, kv_cache=JaxPagedKVCache(
        *spec, block_size=8, num_blocks=12, dtype="float32"),
        decode_kernel="xla", **knobs)
    try:
        ref = _run_concurrently(jgp, prompts)
    finally:
        jgp.close()
    tkv = PagedKVCache(*spec, block_size=8, num_blocks=12,
                       dtype=torch.float32, device="cpu")
    gp = ContinuousGenerateBatchingPredictor(tm, kv_cache=tkv, device="cpu",
                                             **knobs)
    srv = InferenceServer(gp, device="cpu").start()
    try:
        got = _run_concurrently(gp, prompts)
        buf = io.BytesIO()
        np.savez(buf, ids=prompts[1])
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/generate", data=buf.getvalue(),
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            http = np.load(io.BytesIO(r.read()))["out0"]
    finally:
        srv.stop()
    for i, (r, g) in enumerate(zip(ref, got)):
        _assert_margins(tm, g[None], len(prompts[i]))
        np.testing.assert_array_equal(g, r, err_msg=f"request {i}")
    np.testing.assert_array_equal(http, got[1])
    assert tkv.blocks_in_use == 0
    tkv.check_conservation()


def test_trainstep_adamw_matches_jax():
    jm, tm = _pair(eval_mode=False)
    ids, labels = _batch()
    jopt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                  parameters=jm.parameters(),
                                  weight_decay=0.01)
    jstep = JaxTrainStep(jm, lambda logits, loss: loss, jopt)
    opt = topt.AdamW(learning_rate=1e-4, parameters=tm.parameters(),
                     weight_decay=0.01)
    step = TrainStep(tm, lambda logits, loss: loss, opt)
    before = to_paddle_tpu_state(tm)
    losses = []
    for _ in range(3):
        want = float(jstep(paddle.to_tensor(ids),
                           labels=paddle.to_tensor(labels)))
        got = float(step(torch.from_numpy(ids),
                         labels=torch.from_numpy(labels)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        losses.append(got)
    assert losses[-1] < losses[0]
    tstate = to_paddle_tpu_state(tm)
    assert max(float(np.abs(tstate[k] - before[k]).max())
               for k in tstate) > 1e-4
    for k, v in jm.state_dict().items():
        np.testing.assert_allclose(tstate[k], np.asarray(v._value),
                                   atol=1e-5, rtol=0, err_msg=k)
