"""Serving SLOs in the port — phase attribution, the burn-rate monitor
(``observability/slo.py``) and the flight recorder
(``observability/flightrecorder.py``) — held against the JAX package
(``tests/test_slo_observability.py``'s bodies).

The pure legs run the same operations on both packages, on the same fake
clocks, and compare every number (phase walls, shares, burn rates, budgets,
alert edges, rendered gauges, ring dumps). The live legs boot the port's
continuous scheduler with a tenant ledger, a monitor and a recorder: per-
tenant TTFT / TPOT series, the terminal spans' share tags, ``/slo`` and
``/debug/ticks``, and a forced breach that marks its alert in the ring. The
breach advances the scheduler's injected clock at each launch; nothing
sleeps. A failing live leg dumps the rings it left (``_flight_dump``).
"""
import json
import threading

import numpy as np
import pytest

from paddle_tpu import observability as jobs
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.inference import (
    AdmissionController,
    FaultInjector,
    InferenceServer,
    ServerBusy,
)
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.inference.qos import TenantLedger
from paddle_tpu_torch.observability import SLOMonitor, dump_all
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability.metrics import render_prometheus
from serving_port import (
    FakeClock,
    continuous,
    get,
    jax_gpt,
    one_torch_thread,
    port_of,
    post_npz,
)

_one_thread = pytest.fixture(autouse=True)(one_torch_thread)


@pytest.fixture(autouse=True)
def _flight_dump(request, tmp_path):
    """A leg that failed dumps every live flight recorder to a JSON file
    and prints its path: the breach window's slot state."""
    failed = request.session.testsfailed
    yield
    if request.session.testsfailed > failed:
        path = tmp_path / "flight.json"
        path.write_text(json.dumps(dump_all()))
        print(f"[flightrecorder] {path}")


def _both(fn):
    """fn(scheduler module, observability package, metrics module) on JAX,
    then on the port."""
    return [fn(jsched, jobs, jmetrics), fn(tsched, tobs, tmetrics)]


# ------------------------------------------------------- phase attribution
PHASE_CASES = [(None, None, None, 10.0, 0.0, 0.0),
               (1.0, None, None, 4.0, 0.0, 0.0),
               (1.0, 2.0, None, 10.0, 3.0, 3.0),
               (0.0, 1.0, 5.0, 11.0, 3.0, 2.0),
               (5.0, 4.0, 3.0, 2.0, 0.0, 0.0)]


def test_phase_walls_cases():
    for case in PHASE_CASES:
        assert tsched.phase_walls(*case) == jsched.phase_walls(*case), case
    assert tsched.phase_walls(*PHASE_CASES[2]) == (1.0, 5.0, 3.0, 0.0)
    q, pre, pau, dec = tsched.phase_walls(*PHASE_CASES[3])
    assert (q, pau) == (1.0, 3.0)
    assert pre == pytest.approx(2.0) and dec == pytest.approx(5.0)


def test_attribution_shares_sum_to_one_property():
    """The shares of both packages on a seeded sweep of timelines: equal,
    each in [0, 1], summing to 1."""
    rng = np.random.default_rng(42)
    for _ in range(300):
        t0 = float(rng.uniform(0, 100))
        t_admit = t0 + float(rng.uniform(0, 5))
        t_first = (None if rng.uniform() < 0.2
                   else t_admit + float(rng.uniform(0, 5)))
        t_end = (t_admit if t_first is None else t_first) \
            + float(rng.uniform(0, 5))
        paused = float(rng.uniform(0, 3))
        paused_pre = float(rng.uniform(0, paused)) if paused else 0.0
        walls = tsched.phase_walls(t0, t_admit, t_first, t_end, paused,
                                   paused_pre)
        assert walls == jsched.phase_walls(t0, t_admit, t_first, t_end,
                                           paused, paused_pre)
        shares = tsched.attribution_shares(*walls)
        assert shares == jsched.attribution_shares(*walls)
        assert all(0.0 <= v <= 1.0 for v in shares.values())
        assert sum(shares.values()) == pytest.approx(1.0, abs=5e-6)
    assert tsched.attribution_shares(0.0, 0.0, 0.0, 0.0) == {
        "queue_share": 1.0, "prefill_share": 0.0,
        "paused_share": 0.0, "decode_share": 0.0}


# ------------------------------------------------------------ SLOPolicy math
def test_slo_policy_burn_rate_lifecycle_on_fake_clock():
    """budget exhausted -> fast-window alert -> slow-window confirm ->
    recovery, on a fake clock; every reading equal to JAX's."""
    def body(_, obs, __):
        clk = FakeClock(1000.0)
        p = obs.SLOPolicy("ttft_p95_ms", "ttft", target=0.95,
                          threshold_ms=100.0, fast_window_s=60.0,
                          slow_window_s=300.0, burn_threshold=2.0, clock=clk)
        seen = [(p.bad_fraction(60.0), p.state(),
                 p.error_budget_remaining())]
        for n, dt, lat in ((100, 2.9, 0.010), (5, 1.0, 0.500),
                           (30, 1.0, 0.500)):
            for _ in range(n):
                clk.tick(dt)
                p.observe(lat)
            seen.append((p.state(), p.burn_rate("fast"),
                         p.burn_rate("slow"), p.error_budget_remaining()))
        clk.tick(400.0)
        p.observe(0.010)
        seen.append((p.state(), p.burn_rate("slow"),
                     p.error_budget_remaining()))
        return seen, p.snapshot()
    (js, jsnap), (ts, tsnap) = _both(body)
    assert js == ts and jsnap == tsnap
    assert [s[0] for s in ts[1:4]] == ["ok", "fast_burn", "alerting"]
    assert ts[3][3] == 0.0 and ts[4] == ("ok", 0.0, 1.0)
    assert tsnap["total_events"] == 136 and tsnap["bad_events"] == 35


def test_make_policies_parsing_and_validation():
    spec = {"ttft_p95_ms": 200.0, "tpot_p99.9_ms": 50.0,
            "availability": 0.999}
    got = [{p.name: (p.kind, p.target, p.threshold_ms)
            for p in obs.make_policies(spec)} for obs in (jobs, tobs)]
    assert got[0] == got[1]
    assert got[1]["tpot_p99.9_ms"][0] == "tpot"
    assert got[1]["tpot_p99.9_ms"][1] == pytest.approx(0.999)
    assert got[1]["availability"] == ("availability", 0.999, None)
    with pytest.raises(ValueError):
        tobs.make_policies({"latency_p95_ms": 200.0})
    with pytest.raises(ValueError):
        tobs.make_policies({"ttft_p0_ms": 200.0})
    with pytest.raises(ValueError):
        tobs.SLOPolicy("x", "throughput", target=0.9)
    with pytest.raises(ValueError):
        tobs.SLOPolicy("x", "availability", target=1.0)
    with pytest.raises(ValueError):
        tobs.SLOPolicy("x", "ttft", target=0.95)
    with pytest.raises(ValueError):
        tobs.SLOPolicy("x", "availability", target=0.9, fast_window_s=60.0,
                       slow_window_s=60.0)
    with pytest.raises(ValueError):
        tobs.SLOMonitor()
    p = tobs.SLOPolicy("dup", "availability", target=0.9)
    with pytest.raises(ValueError):
        tobs.SLOMonitor(policies=[p, p])


def test_slo_monitor_alert_edge_fires_once_and_rearms():
    """One firing per not-alerting -> alerting edge, re-armed by recovery;
    a broken callback never blocks the next; the same on both."""
    def body(_, obs, __):
        clk = FakeClock()
        mon = obs.SLOMonitor({"availability": 0.9}, fast_window_s=10.0,
                             slow_window_s=50.0, burn_threshold=2.0,
                             clock=clk)
        fired = []

        @mon.on_alert
        def _broken(policy):
            raise RuntimeError("alert hook crashed")

        mon.on_alert(lambda policy: fired.append(policy.name))
        trail = []
        for good, n, tenant in ((True, 8, None), (False, 4, None),
                                (False, 1, None)):
            for _ in range(n):
                clk.tick(1.0)
                mon.observe_terminal(good, tenant=tenant)
            trail.append((list(fired), mon.alerting()))
        clk.tick(60.0)
        mon.observe_terminal(True)
        trail.append((list(fired), mon.alerting()))
        for _ in range(4):
            clk.tick(1.0)
            mon.observe_terminal(False, tenant="gold")
        trail.append((list(fired), mon.alerting()))
        return trail, mon.snapshot()
    (jt, jsnap), (tt, tsnap) = _both(body)
    assert jt == tt and jsnap == tsnap
    assert tt[1] == (["availability"], ["availability"])
    assert tt[2][0] == ["availability"] and tt[3][1] == []
    assert tt[4][0] == ["availability", "availability"]
    assert tsnap["recent_bad"][-1]["tenant"] == "gold"


def test_slo_monitor_bind_metrics_gauges_and_idempotency():
    def body(_, obs, m):
        reg = m.MetricsRegistry()
        clk = FakeClock()
        mon = obs.SLOMonitor({"ttft_p95_ms": 100.0, "availability": 0.99},
                             fast_window_s=10.0, slow_window_s=50.0,
                             clock=clk)
        mon.bind_metrics(reg)
        mon.bind_metrics(reg)
        text1 = m.render_prometheus(reg)
        for _ in range(5):
            clk.tick(1.0)
            mon.observe_ttft(0.500)
        return text1, m.render_prometheus(reg)
    (j1, j2), (t1, t2) = _both(body)
    assert (j1, j2) == (t1, t2)
    assert 'paddle_slo_error_budget_remaining{slo="ttft_p95_ms"} 1' in t1
    assert 'paddle_slo_burn_rate{slo="availability",window="slow"} 0' in t1
    assert 'paddle_slo_error_budget_remaining{slo="ttft_p95_ms"} 0' in t2
    assert 'paddle_slo_error_budget_remaining{slo="availability"} 1' in t2


# ---------------------------------------------------------- flight recorder
def test_flight_recorder_ring_bounds_dump_and_registry():
    def body(_, obs, __):
        clk = FakeClock()
        rec = obs.FlightRecorder(capacity=4, clock=clk,
                                 name=f"ringtest-{obs.__name__}")
        for i in range(10):
            clk.tick(0.5)
            rec.record({"i": i})
        out = [(rec.capacity, rec.occupancy, rec.dropped), rec.dump(),
               rec.dump(last=2)]
        rec.mark_alert("ttft_p95_ms", state="alerting")
        out.append(json.loads(rec.dump_json(last=1)))
        assert any(r is rec for r in obs.live_recorders())
        out.append(obs.dump_all(last=1)[rec.name]["recorded"])
        rec.clear()
        out.append((rec.occupancy, rec.dump()["alerts"]))
        with pytest.raises(ValueError):
            obs.FlightRecorder(capacity=0)
        for d in out[1:4]:
            d.pop("name")
        return out
    j, t = _both(body)
    assert j == t
    assert t[0] == (4, 4, 6)
    assert [x["tick"] for x in t[1]["ticks"]] == [7, 8, 9, 10]
    assert [x["tick"] for x in t[2]["ticks"]] == [9, 10]
    assert t[3]["alerts"][0]["at_tick"] == 10 and t[4] == 10
    assert t[5] == (0, [])


# ----------------------------------------------------------------- live legs
@pytest.fixture(scope="module")
def tm():
    jm, cfg = jax_gpt(11)
    return port_of(jm, cfg)


def test_serving_per_tenant_ttft_tpot_and_share_tags(tm):
    """Retirement samples per-tenant TTFT / TPOT, the terminal spans carry
    shares summing to 1, the monitor sees every stream, and the ring holds
    slot maps with the ledger's fair ratios."""
    led = TenantLedger()
    led.register("gold", weight=2.0)
    led.register("bronze", weight=1.0)
    mon = SLOMonitor({"ttft_p95_ms": 60000.0, "tpot_p99_ms": 60000.0,
                      "availability": 0.99})
    gp = continuous(tm, qos=led, slo=mon, flight_recorder=True)
    try:
        rng = np.random.default_rng(5)
        tenants = ["gold", "bronze", "gold", "bronze"]
        prompts = [rng.integers(0, 160, n).astype("int64")
                   for n in (3, 5, 7, 4)]
        results = {}
        ts = [threading.Thread(target=lambda i=i: results.update(
            {i: gp.infer(prompts[i], timeout=300, tenant=tenants[i])}))
            for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        assert len(results) == 4
        tagged = [s.tags for s in gp.tracer.spans()
                  if s.name == "request" and "queue_share" in s.tags]
        assert len(tagged) == 4
        for tags in tagged:
            assert (tags["queue_share"] + tags["prefill_share"]
                    + tags["paused_share"] + tags["decode_share"]) \
                == pytest.approx(1.0, abs=5e-6)
            assert tags["paused_share"] == 0.0
        text = render_prometheus(gp.metrics.registry)
        for tenant in ("gold", "bronze"):
            for fam in ("ttft", "tpot"):
                assert (f'paddle_serving_{fam}_seconds_count{{'
                        f'component="continuous",tenant="{tenant}"}} 2'
                        in text), (fam, tenant)
        for line in text.splitlines():
            if line.startswith(("paddle_serving_ttft_seconds",
                                "paddle_serving_tpot_seconds")):
                assert 'tenant="gold"' in line or 'tenant="bronze"' in line
        assert ('paddle_trace_dropped_spans_total{component="continuous"} 0'
                in text)
        assert ('paddle_slo_error_budget_remaining{slo="ttft_p95_ms"} 1'
                in text)
        assert ('paddle_flightrec_ticks{component="continuous",'
                'state="capacity"} 512') in text
        snap = mon.snapshot()
        assert snap["alerting"] == []
        for pol in ("availability", "ttft_p95_ms", "tpot_p99_ms"):
            assert snap["policies"][pol]["total_events"] == 4
        assert snap["policies"]["availability"]["bad_events"] == 0
        d = gp.flight.dump()
        assert d["recorded"] > 0
        tick = d["ticks"][-1]
        assert {"tick", "t", "slots", "width", "kv", "paused", "pending",
                "fair_ratios"} <= set(tick)
        assert len(tick["slots"]) == gp.max_slots
        assert set(tick["width"]) == {"prefill", "decode", "free"}
        assert set(tick["kv"]) == {"in_use", "free", "evictable"}
        assert set(tick["fair_ratios"]) >= {"gold", "bronze"}
        assert any(sl and sl["tenant"] in ("gold", "bronze")
                   for t_ in d["ticks"] for sl in t_["slots"])
    finally:
        gp.close()


def test_door_rejection_is_all_queue_and_never_samples_ttft(tm):
    mon = SLOMonitor({"ttft_p95_ms": 60000.0, "availability": 0.5})
    gp = continuous(tm, slo=mon,
                    admission=AdmissionController(max_queue_depth=0))
    try:
        with pytest.raises(ServerBusy):
            gp.infer(np.arange(3, dtype="int64"), timeout=30)
        spans = [s for s in gp.tracer.spans() if s.name == "request"]
        tags = spans[-1].tags
        assert tags["outcome"] == "rejected" and tags["status"] == 429
        assert (tags["queue_share"], tags["prefill_share"],
                tags["paused_share"], tags["decode_share"]) == (
                    1.0, 0.0, 0.0, 0.0)
        text = render_prometheus(gp.metrics.registry)
        assert "paddle_serving_ttft_seconds_bucket" not in text
        assert "paddle_serving_ttft_seconds_count" not in text
        assert "paddle_serving_tpot_seconds_count" not in text
        pol = mon.snapshot()["policies"]["availability"]
        assert pol["total_events"] == 1 and pol["bad_events"] == 0
    finally:
        gp.close()


def test_server_slo_and_debug_ticks_endpoints(tm):
    mon = SLOMonitor({"ttft_p95_ms": 60000.0, "availability": 0.99})
    gp = continuous(tm, slo=mon, flight_recorder=8)
    srv = InferenceServer(gp, device="cpu").start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        assert post_npz(base, "/generate", np.arange(5, dtype="int64"))[0] \
            == 200
        status, body, hdrs = get(base, "/slo")
        assert status == 200 and hdrs["Content-Type"] == "application/json"
        slo = json.loads(body)
        assert set(slo["policies"]) == {"ttft_p95_ms", "availability"}
        assert slo["alerting"] == []
        assert slo["policies"]["availability"]["total_events"] == 1
        status, body, _ = get(base, "/debug/ticks")
        assert status == 200
        dumps = json.loads(body)
        assert list(dumps) == [gp.flight.name]
        d = dumps[gp.flight.name]
        assert d["capacity"] == 8 and d["recorded"] > 0
        assert len(d["ticks"]) <= 8
        status, body, _ = get(base, "/debug/ticks?last=1")
        assert status == 200
        assert len(json.loads(body)[gp.flight.name]["ticks"]) == 1
        assert get(base, "/debug/ticks?last=soon")[0] == 400
        status, body, _ = get(base, "/metrics")
        snap = json.loads(body)
        assert snap["tracer"]["generator"]["dropped"] == 0
        assert snap["tracer"]["generator"]["recorded_spans"] > 0
        assert snap["flight_recorder"]["capacity"] == 8
        assert snap["flight_recorder"]["occupancy"] > 0
    finally:
        srv.stop()
        gp.close()


def test_server_endpoints_404_without_slo_or_recorder():
    srv = InferenceServer(None, device="cpu").start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        status, body, _ = get(base, "/slo")
        assert status == 404 and b"no SLO policy" in body
        status, body, _ = get(base, "/debug/ticks")
        assert status == 404 and b"no flight recorder" in body
        status, body, _ = get(base, "/utilization")
        assert status == 404 and b"no utilization ledger" in body
    finally:
        srv.stop()


class _SkewEachLaunch(FaultInjector):
    """Each step launch advances the scheduler's clock by ``dt``: TTFT
    grows past a tight objective without any wall wait."""

    def __init__(self, dt, times):
        super().__init__()
        self._dt, self._left = float(dt), int(times)

    def check(self, site):
        super().check(site)
        if site == "predictor.generate" and self._left > 0:
            self._left -= 1
            self.skew_clock(self._dt)


def test_slo_breach_marks_alert_in_flight_dump(tm):
    """A forced breach (each launch adds 50 ms to the scheduler's clock
    against a 1 ms TTFT objective) fires the alert edge; the scheduler
    marks it in the ring, whose ticks hold the breaching tenant's slots."""
    f = _SkewEachLaunch(0.05, times=6)
    led = TenantLedger()
    led.register("gold", weight=2.0)
    seen = []
    mon = SLOMonitor({"ttft_p95_ms": 1.0, "availability": 0.99},
                     fast_window_s=1.0, slow_window_s=30.0,
                     burn_threshold=1.0)
    mon.on_alert(lambda p: seen.append(p.name))
    gp = continuous(tm, faults=f, qos=led, slo=mon, flight_recorder=True)
    try:
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, 160, n).astype("int64") for n in (5, 6)]
        results = {}
        ts = [threading.Thread(target=lambda i=i: results.update(
            {i: gp.infer(prompts[i], timeout=300, tenant="gold")}))
            for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        assert len(results) == 2
        assert "ttft_p95_ms" in seen
        d = gp.flight.dump()
        alerts = [a for a in d["alerts"] if a["slo"] == "ttft_p95_ms"]
        assert alerts and alerts[0]["state"] == "alerting"
        assert 0 <= alerts[0]["at_tick"] <= d["recorded"]
        assert alerts[0]["burn_fast"] >= 1.0
        assert any(sl is not None and sl["tenant"] == "gold"
                   for t_ in d["ticks"] for sl in t_["slots"])
    finally:
        gp.close()
