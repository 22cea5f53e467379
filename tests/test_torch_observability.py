"""Request-scoped tracing (``observability/trace.py``) and the batching
predictor (``inference/serving.py`` ``BatchingPredictor``) of the port,
held against the JAX package (``tests/test_observability.py``'s bodies).

The tracer and metrics legs run the same operations on both packages on
the same fake clocks and compare the spans, tags and rendered text. The
chrome export joins tracer spans with a ``torch.profiler`` capture on one
``perf_counter`` timebase. The lifecycle legs hold the port's
``BatchingPredictor`` (over a model-free predictor) and
``GenerateBatchingPredictor`` to JAX's span taxonomy, and the server's
every terminal path to ``X-Trace-Id`` and ``Retry-After``; the exposition
lint scrapes a live server twice (valid text, no duplicate series,
monotone counters, the conservation sum as rendered).
"""
import json
import re
import threading
import time

import numpy as np
import pytest

from paddle_tpu import observability as jobs
from paddle_tpu.inference import resilience as jres
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.inference import resilience as tres
from paddle_tpu_torch.inference.resilience import (
    AdmissionController,
    ServerBusy,
)
from paddle_tpu_torch.inference.serving import (
    BatchingPredictor,
    GenerateBatchingPredictor,
    InferenceServer,
)
from paddle_tpu_torch.observability import (
    RequestTrace,
    Tracer,
    current_trace_id,
    export_joined_chrome,
)
from serving_port import (
    Doubler,
    FakeClock,
    GateInjector,
    get,
    jax_dense_ref,
    jax_gpt,
    one_torch_thread,
    out0,
    port_of,
    post_npz,
    same_tokens,
    wait_for,
)

_one_thread = pytest.fixture(autouse=True)(one_torch_thread)


# ----------------------------------------------------------------- Tracer unit
def test_tracer_contextvar_nesting_and_parenting():
    def body(obs):
        clk = FakeClock()
        tr = obs.Tracer(clock=clk)
        with tr.span("outer") as tid:
            clk.tick(0.001)
            with tr.span("inner", shard=3):
                clk.tick(0.002)
            clk.tick(0.001)
        outer, inner = tr.trace(tid)
        assert inner.parent_id == outer.span_id
        assert inner.trace_id == outer.trace_id == tid
        assert obs.current_trace_id() is None
        return [(s.name, s.tags, s.duration_us) for s in (outer, inner)]
    got = body(tobs)
    assert got == body(jobs)
    assert got[1] == ("inner", {"shard": 3}, pytest.approx(2000.0))
    assert got[0][2] == pytest.approx(4000.0)
    assert current_trace_id() is None


def test_tracer_span_tags_exception_and_reraises():
    tr = Tracer(clock=FakeClock())
    with pytest.raises(RuntimeError):
        with tr.span("boom") as tid:
            raise RuntimeError("injected")
    (s,) = tr.trace(tid)
    assert "injected" in s.tags["error"]


def test_tracer_ring_buffer_bounds_memory():
    def body(obs):
        tr = obs.Tracer(capacity=8, clock=FakeClock())
        for i in range(20):
            tr.record(f"s{i}", 0.0, 1.0, trace_id="t")
        return len(tr.spans()), tr.dropped, [s.name for s in tr.spans()]
    got = body(tobs)
    assert got == body(jobs)
    assert got == (8, 12, [f"s{i}" for i in range(12, 20)])


def test_tracer_sampling_is_per_trace_and_disabled_is_noop():
    tr = Tracer(clock=FakeClock(), sample_rate=0.0)
    assert tr.should_sample() is False
    rt = RequestTrace(tr)
    rt.child("x", 0, 1)
    rt.finish("result")
    assert tr.spans() == [] and rt.trace_id
    off = Tracer(enabled=False)
    assert off.should_sample() is False
    assert off.record("x", 0, 1, "t") is None
    assert off.spans() == []
    # a sampled fraction: the same per-trace draws as JAX's seeded tracer
    draws = [[obs.Tracer(sample_rate=0.5).should_sample() for _ in range(3)]
             for obs in (tobs, jobs)]
    assert draws[0] == draws[1]


def test_request_trace_cross_thread_and_terminal_idempotence():
    def body(obs):
        clk = FakeClock()
        tr = obs.Tracer(clock=clk)
        rt = obs.RequestTrace(tr, trace_id="req-1")
        clk.tick(0.001)
        t0 = tr.now_us()
        clk.tick(0.005)

        def worker():
            rt.child("queue_wait", t0, tr.now_us())
            rt.finish("timeout", cas="timeout")

        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=5)
        assert rt.finish("result") is False
        spans = tr.trace("req-1")
        assert spans[-1].parent_id == spans[0].span_id
        return [(s.name, s.tags, s.duration_us) for s in spans]
    got = body(tobs)
    assert got == body(jobs)
    assert [n for n, _, _ in got] == ["request", "queue_wait", "timeout"]
    assert got[0][1]["outcome"] == "timeout"
    assert got[-1][1]["cas"] == "timeout"


def test_chrome_export_joined_with_torch_profiler(tmp_path):
    """Tracer spans and a ``torch.profiler`` capture on one timeline: both
    names present, complete events, sorted; the profiler's events land
    inside the tracer's span that enclosed them."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("serving_request"):
            with record_function("model_call"):
                torch.ones(64, 64) @ torch.ones(64, 64)
                time.sleep(0.002)
    path = str(tmp_path / "joined.json")
    export_joined_chrome(path, tracer=tr, profiler=prof)
    events = json.load(open(path))["traceEvents"]
    names = [e["name"] for e in events]
    assert "model_call" in names and "serving_request" in names
    ts = [e["ts"] for e in events]
    assert ts == sorted(ts)
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    span = next(e for e in events if e["name"] == "serving_request")
    call = next(e for e in events if e["name"] == "model_call")
    slack = 1000.0      # µs: the epoch-to-perf_counter anchor's reading
    assert span["ts"] - slack <= call["ts"]
    assert call["ts"] + call["dur"] <= span["ts"] + span["dur"] + slack


# -------------------------------------------------------------- metrics unit
def _registry_body(obs_metrics):
    reg = obs_metrics.MetricsRegistry()
    c = reg.counter("demo_requests_total", "requests", labels=("route",))
    c.labels("a").inc()
    c.labels(route="a").inc(2)
    c.labels("b").inc()
    reg.gauge("demo_depth", "queue depth").set(7)
    reg.gauge("demo_cb", "callback").set_function(lambda: 41 + 1)
    h = reg.histogram("demo_seconds", "lat", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    return reg.render()


def test_registry_counter_gauge_histogram_and_exposition():
    from paddle_tpu.observability import metrics as jm
    from paddle_tpu_torch.observability import metrics as tm

    text = _registry_body(tm)
    assert text == _registry_body(jm)
    for line in ('demo_requests_total{route="a"} 3', "demo_cb 42",
                 'demo_seconds_bucket{le="+Inf"} 3', "demo_seconds_sum 5.55"):
        assert line in text


def test_registry_type_safety():
    reg = tobs.MetricsRegistry()
    c = reg.counter("x_total", "x")
    assert reg.counter("x_total", "x") is c
    with pytest.raises(ValueError):
        reg.gauge("x_total", "x")
    with pytest.raises(ValueError):
        reg.counter("x_total", "x", labels=("a",))
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(TypeError):
        c.set(3)
    with pytest.raises(ValueError):
        reg.counter("bad name", "x")
    g = reg.gauge("g", "g")
    g.inc()
    g.dec(3)
    assert g.value == -2


def test_latency_reservoir_and_registry_mirror_match_jax():
    """The uniform reservoir moves p99 with a late incident, and the events
    mirror into the registry, as JAX's ServingMetrics do."""
    def body(res):
        m = res.ServingMetrics()
        for _ in range(4096):
            m.observe_latency(0.010)
        early = m.snapshot()["p99_ms"]
        for _ in range(4096):
            m.observe_latency(1.000)
        snap = m.snapshot()
        g = res.ServingMetrics(component="generator")
        g.inc("accepted", 3)
        g.inc("completed", 2)
        g.inc("timeouts")
        g.observe_latency(0.02)
        return early, snap["p99_ms"], snap["p50_ms"] > 10.0, \
            g.registry.render(), g.snapshot()["accepted"]
    got = body(tres)
    assert got[:3] == body(jres)[:3]
    assert got[0] == pytest.approx(10.0) and got[1] == pytest.approx(1000.0)
    assert ('paddle_serving_events_total{component="generator",'
            'event="accepted"} 3') in got[3]
    assert "paddle_serving_request_latency_seconds_count" in got[3]
    assert got[4] == 3


# ------------------------------------------------- serving lifecycle spans
def test_predictor_completed_request_trace_covers_lifecycle():
    bp = BatchingPredictor(Doubler(), max_batch_size=2, max_delay_ms=1)
    try:
        out = bp.infer(np.ones(2), timeout=10, trace_id="life-1")
        np.testing.assert_array_equal(out[0], np.full(2, 2.0))
        names = [s.name for s in bp.tracer.trace("life-1")]
        for expected in ("request", "admission", "queue_wait",
                         "batch_assembly", "decode_launch", "decode",
                         "result"):
            assert expected in names, (expected, names)
        root = bp.tracer.trace("life-1")[0]
        assert root.name == "request" and root.tags["cas"] == "result"
    finally:
        bp.close()


def test_predictor_timeout_trace_reaches_terminal_with_outcome():
    """A request that dies by timeout leaves a trace from admission to its
    terminal, tagged with the CAS outcome. The first request holds the
    batcher at a gate until the second has timed out."""
    f = GateInjector("predictor.run", at=1)
    bp = BatchingPredictor(Doubler(), max_batch_size=1, max_delay_ms=1,
                           faults=f)
    try:
        done = {}
        t = threading.Thread(
            target=lambda: done.update(r=bp.infer(np.ones(2), timeout=10)))
        t.start()
        assert f.stalled.wait(30)
        with pytest.raises(TimeoutError):
            bp.infer(np.ones(2), timeout=0.05, trace_id="t-504")
        f.release()
        t.join(timeout=10)
        spans = bp.tracer.trace("t-504")
        names = [s.name for s in spans]
        assert names[0] == "request" and "admission" in names
        terminal = [s for s in spans if s.tags.get("cas")]
        assert {s.tags["cas"] for s in terminal} == {"timeout"}
        assert any(s.name == "timeout" and s.tags["outcome"] == "timeout"
                   for s in spans)
    finally:
        f.release()
        bp.close()


def test_predictor_door_rejection_trace_and_disabled_tracer_records_nothing():
    bp = BatchingPredictor(Doubler(), max_batch_size=1, max_delay_ms=1,
                           admission=AdmissionController(max_queue_depth=0))
    try:
        with pytest.raises(ServerBusy):
            bp.infer(np.ones(2), timeout=5, trace_id="shed-1")
        spans = bp.tracer.trace("shed-1")
        names = [s.name for s in spans]
        assert "admission" in names and "rejected" in names
        assert spans[0].tags["outcome"] == "rejected"
    finally:
        bp.close()
    off = BatchingPredictor(Doubler(), max_batch_size=1, max_delay_ms=1,
                            tracer=Tracer(enabled=False))
    try:
        off.infer(np.ones(2), timeout=10)
        assert off.tracer.spans() == []
        assert off.metrics.get("completed") == 1
    finally:
        off.close()


def test_batching_predictor_pads_to_buckets_like_jax():
    """Batches pad to the next power-of-two bucket with the first row (the
    predictor sees 4 rows for 3 requests), and each request gets its own
    row back."""
    seen = []

    class Recorder(Doubler):
        def run(self, stacked):
            seen.append(stacked[0].shape)
            return super().run(stacked)

    f = GateInjector("predictor.run", at=1)
    bp = BatchingPredictor(Recorder(), max_batch_size=4, max_delay_ms=50,
                           faults=f)
    try:
        first = threading.Thread(target=lambda: bp.infer(np.zeros(2),
                                                         timeout=30))
        first.start()
        assert f.stalled.wait(30)
        outs = {}
        ts = [threading.Thread(target=lambda i=i: outs.update(
            {i: bp.infer(np.full(2, float(i + 1)), timeout=30)}))
            for i in range(3)]
        for t in ts:
            t.start()
        wait_for(lambda: bp._queue.qsize() == 3, "the three never queued")
        f.release()
        for t in ts + [first]:
            t.join(timeout=30)
        assert seen == [(1, 2), (4, 2)]
        for i in range(3):
            np.testing.assert_array_equal(outs[i][0],
                                          np.full(2, 2.0 * (i + 1)))
        assert list(bp.batch_sizes) == [1, 3]
    finally:
        f.release()
        bp.close()


# --------------------------------------------------- generator + HTTP legs
@pytest.fixture(scope="module")
def small_gpt():
    jm, cfg = jax_gpt(11, vocab=128, max_position=64)
    prompt = np.random.default_rng(3).integers(0, 128, 5).astype("int64")
    return port_of(jm, cfg), prompt, jax_dense_ref(jm, prompt, 3)


def _gen(tm, **kw):
    return GenerateBatchingPredictor(tm, max_batch_size=2, max_delay_ms=5,
                                     max_new_tokens=3, block_size=8,
                                     num_blocks=16, device="cpu", **kw)


def test_generator_trace_includes_kv_reserve_and_decode(small_gpt):
    tm, prompt, ref = small_gpt
    gp = _gen(tm)
    try:
        same_tokens(tm, gp.infer(prompt, timeout=120, trace_id="gen-1"),
                    ref, len(prompt))
        names = [s.name for s in gp.tracer.trace("gen-1")]
        for expected in ("request", "admission", "queue_wait", "kv_reserve",
                         "decode_launch", "decode", "result"):
            assert expected in names, (expected, names)
        text = gp.metrics.registry.render()
        assert "paddle_decode_launch_seconds_count" in text
        assert 'paddle_kv_pool_blocks{pool="generator",state="free"} 16' \
            in text
    finally:
        gp.close()


def test_server_every_terminal_path_carries_trace_and_retry_headers(
        small_gpt):
    """200 / 429 / 400 / 504 / 503 (and the GETs) all carry X-Trace-Id; the
    load-shed statuses carry Retry-After. The 504 comes from a request held
    at a gate past its deadline."""
    tm, prompt, ref = small_gpt
    f = GateInjector("predictor.generate", at=2)
    gp = _gen(tm, faults=f)
    srv = InferenceServer(gp, device="cpu").start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        status, body, hdrs = post_npz(base, "/generate", prompt,
                                      {"X-Trace-Id": "client-abc"})
        assert status == 200 and hdrs["X-Trace-Id"] == "client-abc"
        same_tokens(tm, out0(body), ref, len(prompt))
        names = [s.name for s in gp.tracer.trace("client-abc")]
        assert "request" in names and "result" in names
        gp.admission = AdmissionController(max_queue_depth=0, retry_after=0.5)
        status, _, hdrs = post_npz(base, "/generate", prompt)
        assert status == 429
        assert "X-Trace-Id" in hdrs and int(hdrs["Retry-After"]) >= 1
        gp.admission = AdmissionController()
        status, _, hdrs = post_npz(base, "/generate",
                                   np.arange(300).astype("int64"))
        assert status == 400 and "X-Trace-Id" in hdrs
        res = {}
        t = threading.Thread(target=lambda: res.update(r=post_npz(
            base, "/generate", prompt, {"X-Timeout-Ms": "100",
                                        "X-Trace-Id": "slow-1"})))
        t.start()
        assert f.stalled.wait(30)
        t.join(timeout=30)
        f.release()
        status, _, hdrs = res["r"]
        assert status == 504 and hdrs["X-Trace-Id"] == "slow-1"
        wait_for(lambda: gp.pending() == 0, "the held batch never ended")
        assert any(s.tags.get("cas") == "timeout"
                   for s in gp.tracer.trace("slow-1"))
        srv._draining.set()
        status, _, hdrs = post_npz(base, "/generate", prompt)
        assert status == 503 and "Retry-After" in hdrs
        status, _, hdrs = get(base, "/readyz")
        assert status == 503 and "X-Trace-Id" in hdrs
        srv._draining.clear()
        for path, want in (("/health", 200), ("/metrics", 200),
                           ("/nope", 404)):
            status, _, hdrs = get(base, path)
            assert status == want and "X-Trace-Id" in hdrs
    finally:
        f.release()
        srv.stop(drain_timeout=5)


_SERIES_RE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})? ([^ ]+)$')


def _parse_exposition(text):
    """(types, helps, {(name, labels): value}); asserts structure."""
    types, helps, series = {}, {}, {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split(" ", 3)
            assert name not in types, f"duplicate TYPE for {name}"
            types[name] = typ
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            helps[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        mm = _SERIES_RE.match(line)
        assert mm, f"malformed series line {line!r}"
        name, _, labels, value = mm.groups()
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        assert base in types or name in types, name
        key = (name, labels or "")
        assert key not in series, f"duplicate series {key}"
        series[key] = float(value.replace("+Inf", "inf"))
    assert set(types) <= set(helps)
    return types, helps, series


def _events(series, component, event):
    return series.get(("paddle_serving_events_total",
                       f'component="{component}",event="{event}"'), 0.0)


def test_metrics_exposition_lint_and_conservation(small_gpt):
    """A server with a batched predictor and a generator, scraped twice
    with traffic in between: valid text, monotone counters, the
    conservation sum as rendered, absent-iff-off for the SLO, flight and
    utilization series, and the tracer-drop counter always on."""
    tm, prompt, _ = small_gpt
    gp = _gen(tm)
    srv = InferenceServer(gp, device="cpu", predictor=Doubler(),
                          max_batch_size=2, max_delay_ms=1).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        assert post_npz(base, "/generate", prompt)[0] == 200
        assert post_npz(base, "/predict", np.ones(2))[0] == 200
        status, body, hdrs = get(base, "/metrics?format=prom")
        assert status == 200 and hdrs["Content-Type"].startswith(
            "text/plain")
        types1, _, series1 = _parse_exposition(body.decode())
        status, body_json, hdrs = get(base, "/metrics")
        assert hdrs["Content-Type"] == "application/json"
        assert json.loads(body_json)["generator"]["completed"] == 1
        assert post_npz(base, "/generate", prompt)[0] == 200
        status, body2, _ = get(base, "/metrics", {"Accept": "text/plain"})
        types2, _, series2 = _parse_exposition(body2.decode())
        assert types1 == types2
        for (name, labels), v1 in series1.items():
            base_name = re.sub(r"_(bucket|sum|count)$", "", name)
            if types1.get(base_name, types1.get(name)) == "counter" \
                    or name.endswith(("_bucket", "_count")):
                assert series2[(name, labels)] >= v1, (name, labels)
        for component in ("batcher", "generator"):
            acc = _events(series2, component, "accepted")
            assert acc >= 1
            assert acc == (_events(series2, component, "completed")
                           + _events(series2, component, "failed")
                           + _events(series2, component, "timeouts"))
        pool = [series2[("paddle_kv_pool_blocks",
                         f'pool="generator",state="{st}"')]
                for st in ("live", "free", "evictable")]
        assert sum(pool) == series2[("paddle_kv_pool_size_blocks",
                                     'pool="generator"')] == 16
        assert series2[("paddle_http_responses_total",
                        'path="/generate",status="200"')] == 2
        assert not any(n.startswith("paddle_slo_") for n in types2)
        for fam in ("paddle_flightrec_ticks", "paddle_serving_flops_total",
                    "paddle_tenant_flops_total", "paddle_serving_mfu",
                    "paddle_serving_host_gap_seconds"):
            assert fam not in types2
        assert "paddle_trace_dropped_spans_total" in types2
    finally:
        srv.stop(drain_timeout=5)
