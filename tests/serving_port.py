"""Shared pieces of the port's serving tests (``test_torch_multi_lora``,
``_qos``, ``_slo_observability``, ``_utilization``, ``_observability``,
``_resilience``, ``_chaos_serving``, ``_fleet``): a JAX GPT and the same
weights in the port through the bridge, JAX's dense greedy references,
the logit-margin guard that greedy tokens are compared under, the model-
free ``Doubler`` predictor, a fake clock and the HTTP helpers.

Greedy tokens of the port are compared with JAX's only where the port's
own forward over the sequence has a top-1 / top-2 logit gap above
``MARGIN`` (1e-3) at every generated position: the two packages' f32
forwards agree to ~1e-6 on these models (``test_torch_gpt_generate.py``),
so a gap that wide cannot flip."""
import io
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import from_paddle_tpu_state
from paddle_tpu_torch.inference.faults import FaultInjector
from paddle_tpu_torch.inference.scheduler import (
    ContinuousGenerateBatchingPredictor,
)
from paddle_tpu_torch.models import gpt as tgpt

MARGIN = 1e-3


def jax_gpt(seed, vocab=160, max_position=96):
    """JAX GPT on ``gpt_tiny``'s widths (2 layers, hidden 64, 4 heads, 2 kv
    heads), f32, eval."""
    cfg = dict(vocab_size=vocab, hidden_size=64, num_layers=2, num_heads=4,
               num_kv_heads=2, max_position=max_position)
    with paddle.utils.unique_name.guard():
        paddle.seed(seed)
        m = jgpt.GPTForCausalLM(jgpt.GPTConfig(**cfg, dropout=0.0))
    m.eval()
    return m, cfg


def port_of(jm, cfg, delta=None):
    """The port's GPT with ``jm``'s weights (on the CPU); ``delta`` maps a
    weight-name suffix to an array added to that weight (merged LoRA)."""
    state = {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}
    for suffix, d in (delta or {}).items():
        key = next(k for k in state if k.endswith(suffix))
        state[key] = (state[key] + d).astype(state[key].dtype)
    return from_paddle_tpu_state(state, tgpt.GPTConfig(**cfg), device="cpu")


def jax_dense_ref(jm, prompt, new):
    """JAX dense greedy ``generate()`` of one prompt: prompt + new ids."""
    out = jm.generate(paddle.to_tensor(np.asarray(prompt)[None]),
                      max_new_tokens=new, dtype=None, decode_kernel="xla")
    return np.asarray(out._value)[0]


def assert_margins(tm, seq, plen):
    """Every generated position of ``seq`` is decided by a top-1 / top-2
    gap above MARGIN on the port's forward."""
    with torch.no_grad():
        ids = torch.as_tensor(np.array(seq, np.int64))[None]
        lg = tm(ids).float()[0, plen - 1:-1]
    top2 = lg.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    assert bool((gap > MARGIN).all()), f"near-tie: min margin {gap.min()}"


def same_tokens(tm, got, ref, plen):
    """Port tokens equal to JAX's, under the margin guard."""
    assert_margins(tm, ref, plen)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def continuous(tm, **kw):
    """The port's continuous scheduler with the JAX tests' defaults."""
    kw.setdefault("max_slots", 4)
    kw.setdefault("prefill_chunk", 4)
    kw.setdefault("decode_steps", 2)
    kw.setdefault("max_new_tokens", 6)
    kw.setdefault("block_size", 8)
    kw.setdefault("num_blocks", 32)
    kw.setdefault("max_seq_len", 40)
    kw.setdefault("device", "cpu")
    return ContinuousGenerateBatchingPredictor(tm, **kw)


class Doubler:
    """Model-free predictor: one input array in, input * 2 out."""

    def __init__(self):
        self.calls = 0

    def run(self, stacked):
        self.calls += 1
        return [stacked[0] * 2.0]


class FakeClock:
    def __init__(self, t=100.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


def drain_outcomes(m):
    return m.get("completed") + m.get("failed") + m.get("timeouts")


def storm(fn, n, timeout=120):
    """Run ``fn(i)`` on n threads; returns the outcomes (result or the
    exception) in order; every thread must finish."""
    outs = [None] * n

    def client(i):
        try:
            outs[i] = fn(i)
        except Exception as e:      # storm bookkeeping
            outs[i] = e

    ts = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in ts), "a client deadlocked"
    return outs


def get(base, path, headers=None):
    req = urllib.request.Request(base + path, headers=headers or {})
    try:
        r = urllib.request.urlopen(req, timeout=30)
        return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def post_npz(base, path, ids, headers=None):
    buf = io.BytesIO()
    np.savez(buf, ids=np.asarray(ids))
    req = urllib.request.Request(base + path, data=buf.getvalue(),
                                 headers=headers or {})
    try:
        r = urllib.request.urlopen(req, timeout=120)
        return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def out0(body):
    return np.load(io.BytesIO(body))["out0"]


def one_torch_thread():
    """Generator body of an autouse fixture: the tiny models run on one
    torch thread (several test workers, each on all cores, oversubscribe
    the machine), the count restored after."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


class GateInjector(FaultInjector):
    """A FaultInjector whose ``site`` blocks, at its ``at``-th check, until
    ``release()``; ``stalled`` is set while it waits. Orders two threads
    deterministically, without a timed sleep."""

    def __init__(self, site, at):
        super().__init__()
        self._gate = (site, int(at))
        self.stalled = threading.Event()
        self._open = threading.Event()

    def release(self):
        self._open.set()

    def check(self, site):
        super().check(site)
        if (site, self.calls(site)) == self._gate:
            self.stalled.set()
            assert self._open.wait(60), "gate never released"


def wait_for(cond, what, limit=60.0):
    """Poll ``cond`` until it holds (a state the test waits for, not a
    span of time); fail after ``limit`` seconds."""
    deadline = time.monotonic() + limit
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.002)
