"""The continuous scheduler's serving knobs in the port — ``spec_k`` /
``drafter`` (verify ticks), ``admit_policy``, ``warmup`` and the sampler
headers, /metrics and /readyz of ``InferenceServer`` — held against the
JAX package (``tests/test_continuous_serving.py:388-600``,
``tests/test_speculative.py:197-255``).

Greedy tokens are compared port against JAX, paged against paged (f32
pools, ``decode_kernel="xla"`` on the JAX side), after a top-1 / top-2
logit margin of 1e-3 is asserted on the port's forward; sampled requests
are held to the vocabulary (their law is pinned by the chi-square tests of
``test_torch_gpt_serving.py`` and ``test_torch_speculative.py``).
"""
import collections
import io
import json
import queue
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.kv_cache import PagedKVCache as JaxPagedKVCache
from paddle_tpu.inference.scheduler import (
    ContinuousGenerateBatchingPredictor as JaxContinuous,
)
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import from_paddle_tpu_state
from paddle_tpu_torch.inference import (
    ContinuousGenerateBatchingPredictor,
    GenerateBatchingPredictor,
    InferenceServer,
    PagedKVCache,
    warmup,
)
from paddle_tpu_torch.inference.resilience import ServiceUnavailable
from paddle_tpu_torch.inference.serving import _Request
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability.metrics import render_prometheus

MARGIN = 1e-3
SMALL = dict(vocab_size=160, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, max_position=96)
KNOBS = dict(max_slots=4, prefill_chunk=4, decode_steps=2, max_new_tokens=6,
             max_seq_len=40)


@pytest.fixture(scope="module")
def pair():
    with paddle.utils.unique_name.guard():
        paddle.seed(11)
        jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**SMALL))
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}
    tm = from_paddle_tpu_state(state, tgpt.GPTConfig(**SMALL), device="cpu")
    return jm, tm


def _spec_prompts():
    return _repetitive(23, [3, 4, 7, 13, 5, 9])


def _spf_prompts():
    rng = np.random.default_rng(31)
    return [rng.integers(0, 160, n).astype(np.int64)
            for n in (13, 3, 9, 4, 11, 5, 7, 6)]


def _header_prompt():
    return np.random.default_rng(41).integers(0, 160, 5).astype(np.int64)


SPF = dict(max_slots=2, admit_policy="shortest_prompt_first")


@pytest.fixture(scope="module")
def jax_refs(pair):
    """The JAX scheduler's answers, computed once for the module."""
    jm = pair[0]
    refs = {}
    refs["spec"] = _closing(_jax(jm, spec_k=3),
                            lambda g: _storm(g, _spec_prompts()))
    refs["opt_out"] = _closing(_jax(jm), lambda g: np.asarray(
        g.infer(_repetitive(29, [10])[0], timeout=120)))
    refs["spf"] = _closing(_jax(jm, **SPF),
                           lambda g: _storm(g, _spf_prompts()))
    refs["header"] = _closing(_jax(jm), lambda g: np.asarray(
        g.infer(_header_prompt(), timeout=120)))

    def families(g):
        g.infer(np.arange(9, dtype=np.int64), timeout=120)
        return {f.name: (f.type, f.labelnames)
                for f in g.metrics.registry.families()}

    refs["families"] = _closing(
        _jax(jm, spec_k=2, prefix_cache=True, warmup=True), families)
    return refs


def _fresh(pair):
    """A port model with the pair's weights and an empty runner cache."""
    return from_paddle_tpu_state(
        {k: np.asarray(v) for k, v in pair[0].gpt.raw_state().items()},
        tgpt.GPTConfig(**SMALL), device="cpu")


def _jax(jm, **kw):
    kv = JaxPagedKVCache(*jm._decode_cache_spec(), block_size=8,
                         num_blocks=32, dtype="float32")
    return JaxContinuous(jm, kv_cache=kv, decode_kernel="xla",
                         **{**KNOBS, **kw})


def _port(tm, **kw):
    kv = PagedKVCache(*tm._decode_cache_spec(), block_size=8, num_blocks=32,
                      dtype=torch.float32, device="cpu")
    return ContinuousGenerateBatchingPredictor(tm, kv_cache=kv, device="cpu",
                                               **{**KNOBS, **kw})


@torch.no_grad()
def _assert_margins(tm, seq, plen):
    lg = tm(torch.as_tensor(np.asarray(seq))[None]).float()[0, plen - 1:-1]
    top2 = lg.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    assert bool((gap > MARGIN).all()), f"near-tie: min margin {gap.min()}"


def _storm(gp, prompts, **kw):
    outs = [None] * len(prompts)

    def client(i):
        outs[i] = np.asarray(gp.infer(prompts[i], timeout=120, **kw))

    ts = [threading.Thread(target=client, args=(i,))
          for i in range(len(prompts))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    return outs


def _closing(gp, fn):
    try:
        return fn(gp)
    finally:
        gp.close()


def _repetitive(seed, plens):
    rng = np.random.default_rng(seed)
    return [np.tile(rng.integers(0, 160, max(2, n // 2)), 8)[:n]
            .astype(np.int64) for n in plens]


# ------------------------------------------------------------- speculation
def test_spec_scheduler_matches_jax_spec_on_and_off(pair, jax_refs):
    """spec_k > 0 (verify ticks, n-gram drafts) gives the tokens of spec
    off, in the port and in JAX; one verify program at (S, K + 1)."""
    tm = _fresh(pair)
    prompts = _spec_prompts()
    ref = jax_refs["spec"]
    off = _closing(_port(tm), lambda g: _storm(g, prompts))
    gp = _port(tm, spec_k=3)
    try:
        got = _storm(gp, prompts)
        snap = gp.metrics.snapshot()
        assert snap["admitted_seqs"] == snap["retired_seqs"] == len(prompts)
        assert gp.metrics.get("verify_ticks") >= 1
        assert gp.kv_cache.blocks_in_use == 0
        gp.kv_cache.check_conservation()
        d, a = gp._spec_drafted, gp._spec_accepted
        assert d >= a >= 0 and d > 0
        text = render_prometheus(gp.metrics.registry)
        for kind, n in (("drafted", d), ("accepted", a),
                        ("wasted", d - a)):
            assert (f'paddle_spec_tokens_total{{component="continuous",'
                    f'kind="{kind}"}} {n}') in text
        assert gp._acceptance_rate() == pytest.approx(a / d)
    finally:
        gp.close()
    verify = [k for k in tm._generate_cache if k[0] == "verify_step"]
    assert len(verify) == 1 and verify[0][1:3] == (4, 4), verify
    for i, p in enumerate(prompts):
        _assert_margins(tm, off[i], len(p))
        np.testing.assert_array_equal(got[i], off[i], err_msg=f"stream {i}")
        np.testing.assert_array_equal(got[i], ref[i], err_msg=f"stream {i}")


def test_spec_opt_out_and_sampled_requests(pair, jax_refs):
    tm = pair[1]
    prompt = _repetitive(29, [10])[0]
    ref = jax_refs["opt_out"]
    gp = _port(tm, spec_k=3)
    try:
        out = np.asarray(gp.infer(prompt, timeout=120, spec=False))
        assert gp._spec_drafted == 0            # zero drafts, same program
        sampled = np.asarray(gp.infer(prompt, timeout=120, temperature=0.9,
                                      top_k=7))
        assert gp.kv_cache.blocks_in_use == 0
    finally:
        gp.close()
    _assert_margins(tm, out, len(prompt))
    np.testing.assert_array_equal(out, ref)
    assert sampled.shape == ref.shape
    assert (sampled >= 0).all() and (sampled < 160).all()


@pytest.mark.parametrize("knobs", [dict(spec_k=-1),
                                   dict(admit_policy="longest_prompt_first"),
                                   dict(spec_k=2, drafter="markov"),
                                   dict(prefill_token_budget=2)])
def test_knob_validation(pair, knobs):
    with pytest.raises(ValueError):
        _port(pair[1], **knobs).close()


@pytest.mark.parametrize("knob, item", [("compile_cache_dir", "ROADMAP C"),
                                        ("hbm_budget", "ROADMAP A6")])
def test_knobs_not_ported_raise_not_implemented(pair, knob, item):
    """compile_cache_dir= still raises (ROADMAP C). hbm_budget= is ported
    (ROADMAP A6, part 1): the port's scheduler sizes its pool from
    analysis.hbm.plan_kv_pool as JAX's does — the same num_blocks where
    max_seq_len clamps the pool, one block fewer where the budget binds
    (the port's pool holds a scratch page past num_blocks, which its plan
    reserves; with no max_seq_len JAX's target is None and the budget
    always binds)."""
    if knob == "compile_cache_dir":
        with pytest.raises(NotImplementedError, match=item):
            _port(pair[1], compile_cache_dir="/nonexistent")
        return
    from paddle_tpu.analysis.hbm import params_bytes_of as jax_params_bytes
    from paddle_tpu_torch.analysis.hbm import params_bytes_of

    jm, tm = pair
    assert params_bytes_of(tm) == jax_params_bytes(jm)
    # 2 layers x 2 kv heads x 8 rows x 16 dims x bf16, K and V
    pbb = 2 * 2 * 2 * 8 * 16 * 2
    fit_bound = int((params_bytes_of(tm) + 100.5 * pbb) / 0.92)
    for budget, seq, want_gap in ((1 << 30, 40, 0), (fit_bound, None, 1)):
        kw = dict(KNOBS, max_seq_len=seq, hbm_budget=budget, block_size=8)
        jg = JaxContinuous(jm, decode_kernel="xla", **kw)
        gp = ContinuousGenerateBatchingPredictor(tm, device="cpu", **kw)
        try:
            jb, pb = jg.kv_cache.num_blocks, gp.kv_cache.num_blocks
            assert jb - pb == want_gap, (budget, jb, pb)
            if seq is not None:
                assert pb == KNOBS["max_slots"] * 5   # blocks_for(40, 8)
            assert gp.kv_cache.per_chip_pool_bytes() == (pb + 1) * pbb
            assert gp.hbm_budget == budget
        finally:
            jg.close()
            gp.close()


# -------------------------------------------------------- admission policy
def test_shortest_prompt_first_matches_jax(pair, jax_refs):
    tm = pair[1]
    prompts = _spf_prompts()
    ref = jax_refs["spf"]
    gp = _port(tm, **SPF)
    try:
        got = _storm(gp, prompts)
        snap = gp.metrics.snapshot()
        assert snap["admitted_seqs"] == snap["retired_seqs"] == len(prompts)
        assert gp.pending() == 0 and len(gp._backlog) == 0
        gp.kv_cache.check_conservation()
    finally:
        gp.close()
    for i, p in enumerate(prompts):
        _assert_margins(tm, got[i], len(p))
        np.testing.assert_array_equal(got[i], ref[i], err_msg=f"stream {i}")


class _Policy(ContinuousGenerateBatchingPredictor):
    """The admission policy alone: no model, no tick thread."""

    def __init__(self, policy):
        self.admit_policy = policy
        self._queue = queue.Queue()
        self._backlog = collections.deque()


def _req(n, deadline=None):
    return _Request([np.zeros(n, np.int64)], deadline)


def test_shortest_prompt_first_order_and_fifo_order():
    from paddle_tpu_torch.inference.resilience import Deadline

    lens = [9, 3, 7, 3, 5]
    for policy in ("fifo", "shortest_prompt_first"):
        p = _Policy(policy)
        reqs = [_req(n) for n in lens]
        reqs[3].deadline = Deadline.after(60)       # ties: urgent first
        for r in reqs:
            p._queue.put(r)
        order = [p._next_request(False) for _ in lens]
        with pytest.raises(queue.Empty):
            p._next_request(False)
        want = (reqs if policy == "fifo"
                else [reqs[3], reqs[1], reqs[4], reqs[2], reqs[0]])
        assert [id(r) for r in order] == [id(r) for r in want]


def test_close_fails_the_reorder_backlog(pair):
    gp = _port(pair[1], admit_policy="shortest_prompt_first")
    parked = _req(5)
    gp._backlog.append(parked)
    gp.close()
    assert parked.event.is_set()
    assert isinstance(parked.error, ServiceUnavailable)
    assert len(gp._backlog) == 0


# ----------------------------------------------------------------- warmup
def test_warmup_captures_every_program_and_no_key_follows(pair):
    """warmup=True builds prefill_chunk, decode_step and verify_step before
    ready(); traffic afterwards adds no runner and counts no recompile."""
    tm = _fresh(pair)
    gp = _port(tm, spec_k=2, warmup=True, prefix_cache=True)
    try:
        t0 = time.monotonic()
        while not gp.ready() and time.monotonic() - t0 < 60:
            time.sleep(0.01)
        st = gp.warm_stats()
        assert gp.ready() and gp.warm_errors() == []
        assert st["programs"] == st["captured"] == 3 and st["missing"] == []
        assert set(st["program_seconds"]) == {"prefill_chunk", "decode_step",
                                              "verify_step"}
        keys = set(tm._generate_cache)
        assert keys == set(warmup.program_keys(gp))
        _storm(gp, _repetitive(3, [5, 9, 12]), max_new_tokens=5)
        _storm(gp, _repetitive(3, [5, 9]), temperature=0.8, top_k=5)
        assert set(tm._generate_cache) == keys
        assert "paddle_serving_recompiles_total{" not in render_prometheus(
            gp.metrics.registry)
    finally:
        gp.close()


def test_warmup_leaves_the_live_pages_bit_equal(pair):
    tm = _fresh(pair)
    kv = PagedKVCache(*tm._decode_cache_spec(), block_size=8, num_blocks=32,
                      dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(0)
    for p in kv.k_pages + kv.v_pages:
        p.copy_(torch.randn(p.shape, generator=g))
    before = [p[:, :kv.num_blocks].clone() for p in kv.k_pages + kv.v_pages]
    gp = ContinuousGenerateBatchingPredictor(tm, kv_cache=kv, device="cpu",
                                             spec_k=2, warmup=True, **KNOBS)
    try:
        t0 = time.monotonic()
        while not gp.ready() and time.monotonic() - t0 < 60:
            time.sleep(0.01)
        assert gp.warm_stats()["missing"] == []
    finally:
        gp.close()
    for a, b in zip(before, kv.k_pages + kv.v_pages):
        assert torch.equal(a, b[:, :kv.num_blocks])


def test_ready_gate_holds_ticks_and_readyz_until_warm(pair, monkeypatch):
    """While the warmup runs, /readyz answers 503 and no tick admits; then
    200 and the waiting request is served."""
    tm = pair[1]
    release = threading.Event()
    real = warmup.Warmup.run

    def slow(self):
        release.wait(30)
        return real(self)

    monkeypatch.setattr(warmup.Warmup, "run", slow)
    gp = _port(tm, warmup=True)
    srv = InferenceServer(gp, device="cpu").start()
    url = f"http://127.0.0.1:{srv.port}/readyz"

    def readyz():
        try:
            with urllib.request.urlopen(url, timeout=30) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code

    try:
        out = []
        t = threading.Thread(target=lambda: out.append(
            gp.infer(np.arange(5, dtype=np.int64), timeout=60)))
        t.start()
        time.sleep(0.3)
        assert readyz() == 503 and not gp.ready()
        assert gp.metrics.get("prefill_ticks") == 0
        release.set()
        t.join(timeout=60)
        assert readyz() == 200 and len(out) == 1
        assert gp.metrics.get("prefill_ticks") >= 1
    finally:
        release.set()
        srv.stop(drain_timeout=10)


def test_failed_warmup_serves_cold_with_the_sentinel_off(pair, monkeypatch):
    def broken(self):
        raise RuntimeError("warmup fault")

    monkeypatch.setattr(warmup.Warmup, "run", broken)
    gp = _port(pair[1], warmup=True)
    try:
        t0 = time.monotonic()
        while not gp.ready() and time.monotonic() - t0 < 30:
            time.sleep(0.01)
        assert gp.ready() and gp.warm_stats() is None
        assert [str(e) for e in gp.warm_errors()] == ["warmup fault"]
        assert not gp._warm_armed.is_set()
        out = gp.infer(np.arange(6, dtype=np.int64), timeout=60)
        assert out.shape == (12,)
    finally:
        gp.close()


def test_a_capture_after_warmup_counts_as_a_recompile(pair):
    tm = _fresh(pair)
    sentinel = warmup.activate(warmup.CompileSentinel())
    gp = _port(tm, warmup=True)
    try:
        t0 = time.monotonic()
        while not gp.ready() and time.monotonic() - t0 < 60:
            time.sleep(0.01)
        dropped = [k for k in tm._generate_cache if k[0] == "decode_step"]
        tm._generate_cache.pop(dropped[0])
        gp.infer(np.arange(6, dtype=np.int64), timeout=60)
        text = render_prometheus(gp.metrics.registry)
        assert ('paddle_serving_recompiles_total{component="continuous",'
                'program="decode_step"} 1') in text
        assert list(sentinel.violations) == [("continuous", "decode_step")]
    finally:
        warmup.deactivate()
        gp.close()


# ------------------------------------------------------------------- HTTP
def _post(port, prompt, headers):
    buf = io.BytesIO()
    np.savez(buf, ids=prompt)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=buf.getvalue(), headers=headers)
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, np.load(io.BytesIO(r.read()))["out0"]


def test_sampler_headers_round_trip_and_400s(pair, jax_refs):
    tm = pair[1]
    prompt = _header_prompt()
    ref = jax_refs["header"]
    srv = InferenceServer(_port(tm, spec_k=2), device="cpu").start()
    try:
        status, out = _post(srv.port, prompt, {
            "X-Temperature": "0.0", "X-Top-K": "0", "X-Spec": "off"})
        assert status == 200
        np.testing.assert_array_equal(out, ref)
        status, out = _post(srv.port, prompt, {"X-Temperature": "0.9",
                                               "X-Top-K": "5",
                                               "X-Spec": "on"})
        assert status == 200 and out.shape == ref.shape
        assert (out >= 0).all() and (out < 160).all()
        for hdrs in ({"X-Temperature": "hot"}, {"X-Temperature": "-0.5"},
                     {"X-Temperature": "inf"}, {"X-Top-K": "-3"},
                     {"X-Top-K": "2.5"}, {"X-Spec": "maybe"}):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(srv.port, prompt, hdrs)
            assert ei.value.code == 400, hdrs
            assert ei.value.headers["X-Trace-Id"]
    finally:
        srv.stop(drain_timeout=10)
    _assert_margins(tm, ref, len(prompt))


def test_sampler_headers_400_on_a_whole_batch_generator(pair):
    gp = GenerateBatchingPredictor(pair[1], max_batch_size=2, max_delay_ms=1,
                                   max_new_tokens=6, block_size=8,
                                   num_blocks=32, device="cpu")
    srv = InferenceServer(gp, device="cpu").start()
    prompt = np.arange(5, dtype=np.int64)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.port, prompt, {"X-Temperature": "0.7"})
        assert ei.value.code == 400
        assert _post(srv.port, prompt, {})[0] == 200
    finally:
        srv.stop(drain_timeout=10)


def _get(port, path, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, r.headers["Content-Type"], r.read().decode()


@pytest.mark.parametrize("how", ["query", "accept"])
def test_metrics_json_and_prometheus(pair, how):
    from test_torch_metrics import SAMPLE

    gp = _port(pair[1], spec_k=2, prefix_cache=True)
    srv = InferenceServer(gp, device="cpu").start()
    try:
        _post(srv.port, np.arange(9, dtype=np.int64), {})
        status, ctype, body = _get(srv.port, "/metrics")
        assert status == 200 and ctype == "application/json"
        snap = json.loads(body)
        assert snap["draining"] is False
        assert snap["generator"]["completed"] == 1
        path, hdr = (("/metrics?format=prom", {}) if how == "query"
                     else ("/metrics", {"Accept": "text/plain"}))
        status, ctype, text = _get(srv.port, path, hdr)
    finally:
        srv.stop(drain_timeout=10)
    assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
    for line in text.splitlines():
        assert line.startswith("# ") or SAMPLE.match(line), line
    for fam in ("paddle_serving_events_total", "paddle_kv_pool_blocks",
                "paddle_sched_slots", "paddle_spec_tokens_total",
                "paddle_prefix_hit_tokens_total",
                "paddle_serving_recompiles_total",
                "paddle_http_responses_total", "paddle_server_draining"):
        assert f"# TYPE {fam} " in text, fam
    assert ('paddle_http_responses_total{path="/generate",status="200"} 1'
            in text)


PORT_FAMILIES = {
    "paddle_serving_events_total", "paddle_serving_request_latency_seconds",
    "paddle_kv_pool_blocks", "paddle_kv_pool_size_blocks",
    "paddle_kv_pool_live_utilization", "paddle_kv_pool_evictions_total",
    "paddle_kv_pool_per_chip_bytes", "paddle_decode_launch_seconds",
    "paddle_generated_tokens_total", "paddle_sched_slots",
    "paddle_sched_slot_count", "paddle_sched_prefill_token_budget",
    "paddle_sched_prefill_backlog_tokens", "paddle_spec_tokens_total",
    "paddle_spec_acceptance_rate", "paddle_prefix_cache_blocks",
    "paddle_prefix_cache_evicted_blocks_total",
    "paddle_prefix_hit_tokens_total", "paddle_serving_recompiles_total",
    "paddle_serving_ttft_seconds", "paddle_serving_tpot_seconds",
    "paddle_trace_dropped_spans_total"}


def test_bound_families_carry_jax_names_types_and_labels(pair, jax_refs):
    """The families the port binds for these knobs, each one the JAX
    scheduler binds for them, with its type and label names."""
    gp = _port(pair[1], spec_k=2, prefix_cache=True, warmup=True)
    try:
        gp.infer(np.arange(9, dtype=np.int64), timeout=120)
        port_fams = {f.name: (f.type, f.labelnames)
                     for f in gp.metrics.registry.families()}
    finally:
        gp.close()
    assert set(port_fams) == PORT_FAMILIES
    jax_fams = jax_refs["families"]
    assert {n: jax_fams.get(n) for n in port_fams} == port_fams
