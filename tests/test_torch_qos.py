"""Multi-tenant QoS in the port (``inference/qos.py`` and the scheduler's
``qos=`` knob), held against the JAX package (``tests/test_qos.py``'s
bodies).

Host-side logic runs the same operations on both packages' ledgers and
autoscalers, on the same fake clocks, and compares every number: bucket
math, the computed ``Retry-After``, fair ratios, the rendered series, the
autoscaler's decisions. Serving legs hold the port's scheduler: a paused
and resumed sequence (greedy, seeded-sampled, and one admitted through a
prefix hit) is token for token its unpaused run, greedy tokens equal
JAX's dense references under the margin guard of ``serving_port``, and
pausing captures nothing. Interleavings are forced by a gate on the
``predictor.generate`` fault site (an event, never a timed sleep); the
autoscaler is driven by explicit ``tick()`` calls.
"""
import itertools
import math
import threading
import time

import numpy as np
import pytest

from paddle_tpu.inference import qos as jqos
from paddle_tpu.inference import serving as jserving
from paddle_tpu.inference.resilience import ServerBusy as JaxServerBusy
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu_torch.inference import FaultInjector, InferenceServer
from paddle_tpu_torch.inference import qos as tqos
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference.resilience import ServerBusy
from paddle_tpu_torch.inference.serving import ReplicaFleet
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability.metrics import render_prometheus
from serving_port import (
    GateInjector,
    continuous,
    jax_dense_ref,
    jax_gpt,
    one_torch_thread,
    out0,
    port_of,
    post_npz,
    same_tokens,
    storm,
    wait_for,
)

VOCAB = 128
_one_thread = pytest.fixture(autouse=True)(one_torch_thread)
BOTH = [(jqos, JaxServerBusy, jmetrics), (tqos, ServerBusy, tmetrics)]


def _both(fn):
    """fn(qos module, ServerBusy, metrics module) on JAX, then the port:
    the two results, which the caller compares."""
    return [fn(*mods) for mods in BOTH]


# ================================================== ledger units (no model)
def test_tenant_spec_validation():
    for q, _, _ in BOTH:
        s = q.TenantSpec("gold", weight=3.0, priority=0, rate=100.0)
        assert s.burst == 400.0
        assert q.TenantSpec("free").rate is None
        for kw, what in ((dict(weight=0.0), "weight"),
                         (dict(priority=-1), "priority"),
                         (dict(rate=0.0), "rate"),
                         (dict(rate=0.01), "burst")):
            with pytest.raises(ValueError, match=what):
                q.TenantSpec("t", **kw)


def test_ledger_resolve_strict_unknown_and_default():
    def body(q, _, __):
        led = q.TenantLedger()
        assert led.resolve(None).name == "default"
        with pytest.raises(ValueError, match="unknown tenant 'ghost'"):
            led.resolve("ghost")
        led.register("gold", weight=3.0, priority=0)
        return (led.resolve("gold").weight, led.tenant_names(),
                led.priority_of("gold"))
    j, t = _both(body)
    assert j == t == (3.0, ["default", "gold"], 0)


def test_ledger_bucket_math_and_computed_retry_after_on_fake_clock():
    """The same charges on the same fake clock: the same sheds, the same
    computed Retry-After, the same snapshot."""
    def body(q, busy, _):
        clk = [0.0]
        led = q.TenantLedger(clock=lambda: clk[0])
        led.register("bronze", rate=10.0, burst=40.0)
        hints = []
        led.charge("bronze", 40)
        with pytest.raises(busy) as ei:
            led.charge("bronze", 10)
        hints.append((ei.value.retry_after, ei.value.status))
        clk[0] += 1.0
        led.charge("bronze", 10)
        with pytest.raises(busy) as ei:
            led.charge("bronze", 25)
        hints.append((ei.value.retry_after, ei.value.status))
        clk[0] += 0.3
        with pytest.raises(busy) as ei:
            led.charge("bronze", 7)
        hints.append((ei.value.retry_after, ei.value.status))
        led.register("bronze", weight=2.0, rate=10.0, burst=40.0)
        with pytest.raises(busy):
            led.charge("bronze", 40)
        return hints, led.snapshot()
    (jh, js), (th, ts) = _both(body)
    assert jh == th
    assert th[0][0] == pytest.approx(1.0) and th[1][0] == pytest.approx(2.5)
    assert th[0][1] == 429
    assert js == ts and ts["bronze"]["rate_limited"] == 4


def test_retry_after_header_floor_ceil_and_cap():
    for v in (None, 0.0, 0.004, 1.0, 1.0001, 2.3, 59.2, 60.0, 61.0, 1e9):
        assert (tserving.retry_after_header(v)
                == jserving.retry_after_header(v)), v
    assert tserving.retry_after_header(7.2, cap=5.0) == "5"
    assert tserving.retry_after_header(1e9) == str(
        int(math.ceil(tserving.RETRY_AFTER_CAP)))
    assert tserving.RETRY_AFTER_CAP == jserving.RETRY_AFTER_CAP


def test_ledger_fair_ratio_tracks_weighted_virtual_service():
    def body(q, _, __):
        led = q.TenantLedger()
        led.register("gold", weight=3.0)
        led.register("bronze", weight=1.0)
        seen = []
        led.acquire("gold", cost=30.0)
        seen.append(led.fair_ratio("gold"))
        led.acquire("bronze", cost=30.0)
        seen.append(led.fair_ratio("bronze"))
        led.acquire("gold", cost=60.0)
        seen.append((led.fair_ratio("gold"), led.fair_ratio("bronze")))
        led.release("gold")
        led.acquire("gold")
        seen.append(led.fair_ratio("gold"))
        led.release("gold")
        led.release("gold")
        led.release("bronze")
        led.acquire("gold", cost=30.0)
        led.register("silver", weight=1.0)
        led.acquire("silver", cost=1.0)
        seen.append(led.fair_ratio("silver"))
        with pytest.raises(ValueError):
            led.acquire("ghost")
        return seen, led.fair_snapshot()
    (js, jf), (ts, tf) = _both(body)
    assert js == ts and jf == tf
    assert ts[0] == pytest.approx(10.0) and ts[-1] == pytest.approx(31.0)
    assert ts[2][0] == ts[2][1]


def test_ledger_metrics_bind_idempotent_and_render():
    def body(q, _, m):
        reg = m.MetricsRegistry()
        led = q.TenantLedger()
        led.register("gold", weight=3.0)
        led.bind_metrics(reg)
        led.bind_metrics(reg)
        led.note_admitted("gold")
        led.account("gold", 7)
        led.acquire("gold")
        return m.render_prometheus(reg)
    j, t = _both(body)
    assert j == t
    for line in ('paddle_tenant_requests_total{tenant="gold"} 1',
                 'paddle_tenant_tokens_total{tenant="gold"} 7',
                 'paddle_tenant_inflight{tenant="gold"} 1',
                 "paddle_qos_ledger_degraded_total 0"):
        assert line in t


# ======================================= autoscaler control loop (fake fleet)
class _FakePredictor:
    def __init__(self):
        self.kv_util = 0.0
        self.backlog = {}
        self._pending = 0

    @property
    def kv_cache(self):
        pred = self

        class KV:
            live_utilization = pred.kv_util
        return KV()

    def tenant_backlog(self):
        return dict(self.backlog)

    def pending(self):
        return self._pending


class _FakeRep:
    def __init__(self, name):
        self.name = name
        self.state = "ready"
        self.predictor = _FakePredictor()


class _FakeFleet:
    def __init__(self, metrics):
        self.registry = metrics.MetricsRegistry()
        self.reps = [_FakeRep("r0")]
        self.pending_v = 0
        self.added = []
        self.retired = []

    def pending(self):
        return self.pending_v

    def _snapshot(self):
        return list(self.reps)

    def _refresh(self, rep):
        return rep.state

    def add_replica(self, **kw):
        self.added.append(kw)
        self.reps.append(_FakeRep(f"r{len(self.reps)}"))

    def retire_replica(self, name, drain_timeout):
        self.retired.append((name, drain_timeout))
        self.reps = [r for r in self.reps if r.name != name]


def test_autoscaler_thresholds_cooldown_and_clamps():
    """JAX's control-loop body on both packages: the same decisions at
    every tick of the same fake clock and signals."""
    def body(q, _, m):
        clk = [0.0]
        fleet = _FakeFleet(m)
        auto = q.FleetAutoscaler(
            fleet, min_replicas=1, max_replicas=3, scale_up_pending=8,
            scale_up_kv_util=0.85, scale_up_backlog=16, scale_down_pending=0,
            scale_down_kv_util=0.25, cooldown_s=5.0, drain_timeout=0.0,
            replica_overrides={"warmup": True}, clock=lambda: clk[0])
        out = [auto.tick()]
        fleet.pending_v = 8
        out += [auto.tick(), auto.tick()]
        clk[0] += 6.0
        fleet.pending_v = 0
        fleet.reps[0].predictor.kv_util = 0.9
        out.append(auto.tick())
        clk[0] += 6.0
        fleet.reps[0].predictor.kv_util = 0.0
        fleet.reps[0].predictor.backlog = {"bronze": 20}
        out.append(auto.tick())
        out.append((len(fleet.reps), list(fleet.retired)))
        auto.max_replicas = 4
        out.append(auto.tick())
        fleet.reps[0].predictor.backlog = {}
        clk[0] += 6.0
        out.append(auto.tick())
        out.append(list(fleet.retired))
        clk[0] += 6.0
        fleet.reps = fleet.reps[:1]
        out.append(auto.tick())
        out.append(fleet.added)
        out.append(m.render_prometheus(fleet.registry))
        with pytest.raises(ValueError):
            q.FleetAutoscaler(fleet, min_replicas=3, max_replicas=2)
        return out
    j, t = _both(body)
    assert j == t
    assert t[:4] == [None, "up", None, "up"]
    assert t[4] is None and t[5] == (3, [])
    assert t[6] == "up" and t[7] == "down" and t[8] == [("r0", 0.0)]
    assert t[9] is None and t[10][0] == {"warmup": True}


# ============================================================ serving legs
@pytest.fixture(scope="module")
def pair():
    jm, cfg = jax_gpt(7, vocab=VOCAB, max_position=64)
    return jm, cfg, port_of(jm, cfg)


@pytest.fixture(scope="module")
def jax_refs(pair):
    """JAX's dense greedy answers, once for the module."""
    jm = pair[0]
    rng17 = np.random.default_rng(17)
    vp17, hp17 = (rng17.integers(0, VOCAB, 6).astype("int64"),
                  rng17.integers(0, VOCAB, 5).astype("int64"))
    rng29 = np.random.default_rng(29)
    vp29, hp29 = (rng29.integers(0, VOCAB, 6).astype("int64"),
                  rng29.integers(0, VOCAB, 5).astype("int64"))
    p = np.arange(2, 7, dtype="int64")
    crowd = np.random.default_rng(0).integers(0, VOCAB, 5).astype("int64")
    return {"g": (vp17, hp17, jax_dense_ref(jm, vp17, 5),
                  jax_dense_ref(jm, hp17, 3)),
            "px": (vp29, hp29, jax_dense_ref(jm, hp29, 3)),
            "door": (p, jax_dense_ref(jm, p, 3)),
            "crowd": (crowd, jax_dense_ref(jm, crowd, 3))}


def _sched(tm, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_new_tokens", 3)
    kw.setdefault("num_blocks", 16)
    kw.setdefault("max_seq_len", 16)
    return continuous(tm, **kw)


def _two_tier_ledger():
    led = tqos.TenantLedger()
    led.register("bg", weight=1.0, priority=2)    # preemptible background
    led.register("fg", weight=1.0, priority=0)    # latency-critical
    return led


def _preempt_round(gp, f, vp, hp, v_new, h_new, v_knobs=None):
    """The victim ('bg') stalls at its first decode launch (the gate), the
    interloper ('fg', strictly more urgent) is queued meanwhile, the gate
    opens: the next tick pauses the victim, serves the interloper, then
    resumes the victim (max_slots=1)."""
    res = {}

    def victim():
        res["v"] = np.asarray(gp.infer(vp, timeout=120, max_new_tokens=v_new,
                                       tenant="bg", **(v_knobs or {})))

    def interloper():
        res["h"] = np.asarray(gp.infer(hp, timeout=120, max_new_tokens=h_new,
                                       tenant="fg"))

    tv = threading.Thread(target=victim)
    tv.start()
    assert f.stalled.wait(60), "the victim never reached its decode launch"
    th = threading.Thread(target=interloper)
    th.start()
    wait_for(lambda: gp._queue.qsize() >= 1, "the interloper never queued")
    f.release()
    tv.join(timeout=120)
    th.join(timeout=120)
    assert not tv.is_alive() and not th.is_alive()
    return res["v"], res["h"]


def test_greedy_preempt_pause_resume_bit_parity(pair, jax_refs):
    """A more urgent arrival pauses the running decode (blocks kept, slot
    freed); the victim resumes to the tokens of an uninterrupted run (JAX's
    dense greedy ones), with no new program captured."""
    tm = port_of(pair[0], pair[1])
    vp, hp, vref, href = jax_refs["g"]
    f = GateInjector("predictor.generate", at=2)
    gp = _sched(tm, faults=f, qos=_two_tier_ledger(), max_slots=1,
                prefill_chunk=8, max_new_tokens=6)
    try:
        v_out, h_out = _preempt_round(gp, f, vp, hp, v_new=5, h_new=3)
        same_tokens(tm, v_out, vref, len(vp))
        same_tokens(tm, h_out, href, len(hp))
        assert gp.metrics.get("preempted_seqs") == 1
        assert gp.metrics.get("resumed_seqs") == 1
        mm = gp.metrics
        assert (mm.get("completed") + mm.get("failed")
                + mm.get("timeouts")) == mm.get("accepted") == 2
        assert len(tm._runner_cache()) == 2     # prefill + decode, no more
        for prog in ("prefill_chunk", "decode_step"):
            assert gp._recompile_counter.labels(
                gp._component, prog).value == 0, prog
        assert gp.kv_cache.blocks_in_use == 0
        gp.kv_cache.check_conservation()
    finally:
        gp.close()


def test_sampled_preempt_pause_resume_bit_parity(pair):
    """Seeded sampling: the scheduler draws one seed per launch, so the
    paused victim consumes seeds [1, 2, 5] (the interloper burns 3 and 4);
    an uninterrupted run rigged to the same seeds gives the same tokens,
    bit for bit."""
    tm = pair[2]
    rng = np.random.default_rng(23)
    vp = rng.integers(0, VOCAB, 6).astype("int64")
    hp = rng.integers(0, VOCAB, 5).astype("int64")
    knobs = dict(temperature=0.9, top_k=4)
    ref_gp = _sched(tm, max_slots=1, prefill_chunk=8, max_new_tokens=6)
    try:
        ref_gp._seed = iter(itertools.chain([1, 2], itertools.count(5)))
        ref = np.asarray(ref_gp.infer(vp, timeout=120, max_new_tokens=5,
                                      **knobs))
    finally:
        ref_gp.close()
    f = GateInjector("predictor.generate", at=2)
    gp = _sched(tm, faults=f, qos=_two_tier_ledger(), max_slots=1,
                prefill_chunk=8, max_new_tokens=6)
    try:
        v_out, _ = _preempt_round(gp, f, vp, hp, v_new=5, h_new=3,
                                  v_knobs=knobs)
        np.testing.assert_array_equal(v_out, ref)
        assert gp.metrics.get("preempted_seqs") == 1
        assert gp.metrics.get("resumed_seqs") == 1
        assert gp.kv_cache.blocks_in_use == 0
        gp.kv_cache.check_conservation()
    finally:
        gp.close()


def test_preempt_resume_across_prefix_cache_hit(pair, jax_refs):
    """A sequence admitted through a prefix hit (shared blocks, a nonzero
    start) is paused mid-decode and resumed: still its cold run's tokens;
    the shared blocks' refcounts survive the pause."""
    tm = pair[2]
    vp, hp, href = jax_refs["px"]
    f = GateInjector("predictor.generate", at=5)
    gp = _sched(tm, faults=f, qos=_two_tier_ledger(), max_slots=1,
                prefill_chunk=8, max_new_tokens=6, block_size=4,
                prefix_cache=True)
    try:
        cold = np.asarray(gp.infer(vp, timeout=120, max_new_tokens=5,
                                   tenant="bg"))   # launches 1-3
        assert f.calls("predictor.generate") == 3
        v_out, h_out = _preempt_round(gp, f, vp, hp, v_new=5, h_new=3)
        np.testing.assert_array_equal(v_out, cold)
        same_tokens(tm, h_out, href, len(hp))
        assert gp.metrics.get("prefix_hit_tokens") == 4     # (6-1)//4 * 4
        assert gp.metrics.get("preempted_seqs") == 1
        assert gp.metrics.get("resumed_seqs") == 1
        gp.kv_cache.check_conservation()
    finally:
        gp.close()


def test_qos_ledger_fault_degrades_to_admit_all(pair, jax_refs):
    """An injected ``qos.ledger`` fault degrades the rate limit to admit-
    all and is counted; once the fault clears the limit holds again."""
    tm = pair[2]
    prompt, ref = jax_refs["door"]
    f = FaultInjector()
    led = tqos.TenantLedger(clock=lambda: 0.0, faults=f)
    led.register("limited", rate=1.0, burst=1.0)
    gp = _sched(tm, faults=f, qos=led)
    try:
        with pytest.raises(ServerBusy) as ei:
            gp.infer(prompt, timeout=120, tenant="limited")
        assert ei.value.retry_after == pytest.approx(7.0)
        f.install("qos.ledger", error=RuntimeError("ledger backend down"),
                  times=2)
        for _ in range(2):
            same_tokens(tm, gp.infer(prompt, timeout=120, tenant="limited"),
                        ref, len(prompt))
        assert led.degraded == 2
        with pytest.raises(ServerBusy):
            gp.infer(prompt, timeout=120, tenant="limited")
        assert gp.metrics.get("completed") == 2
        assert gp.kv_cache.blocks_in_use == 0
        gp.kv_cache.check_conservation()
    finally:
        gp.close()


def test_x_tenant_header_taxonomy_and_computed_retry_after(pair, jax_refs):
    """X-Tenant: routed when valid, 400 on empty / unknown names and on a
    ledger-less generator; over its budget a 429 whose Retry-After is the
    bucket's computed time to refill (7 s here)."""
    tm = pair[2]
    prompt, ref = jax_refs["door"]
    led = tqos.TenantLedger(clock=lambda: 0.0)
    led.register("gold", weight=3.0, priority=0)
    led.register("bronze", rate=1.0, burst=1.0)
    gp = _sched(tm, qos=led)
    srv = InferenceServer(gp, device="cpu").start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        status, body, _ = post_npz(base, "/generate", prompt,
                                   {"X-Tenant": "gold"})
        assert status == 200
        same_tokens(tm, out0(body), ref, len(prompt))
        assert post_npz(base, "/generate", prompt,
                        {"X-Tenant": "  gold  "})[0] == 200
        for hdrs in ({"X-Tenant": ""}, {"X-Tenant": "   "},
                     {"X-Tenant": "ghost"}):
            assert post_npz(base, "/generate", prompt, hdrs)[0] == 400, hdrs
        status, _, hdrs = post_npz(base, "/generate", prompt,
                                   {"X-Tenant": "bronze"})
        assert status == 429 and hdrs["Retry-After"] == "7"
        assert led.snapshot()["bronze"]["rate_limited"] == 1
        srv.stop(drain_timeout=10)
    finally:
        srv.stop(drain_timeout=2)
        gp.close()
    gp2 = _sched(tm)
    assert gp2.supports_tenants is False
    srv2 = InferenceServer(gp2, device="cpu").start()
    try:
        with pytest.raises(ValueError, match="TenantLedger"):
            gp2.infer(prompt, timeout=60, tenant="gold")
        assert post_npz(f"http://127.0.0.1:{srv2.port}", "/generate",
                        prompt, {"X-Tenant": "gold"})[0] == 400
    finally:
        srv2.stop(drain_timeout=2)
        gp2.close()


FLEET = dict(max_slots=2, prefill_chunk=4, decode_steps=2, max_new_tokens=3,
             block_size=8, num_blocks=16, max_seq_len=16, device="cpu")


def test_fleet_scale_up_fault_leaves_survivors_serving(pair, jax_refs):
    """An injected ``fleet.scale_up`` fault: the provision fails, counts
    ``error``, the fleet serves on the survivor; the retry lands the
    replica (its own pool), and the quiet fleet drains back down."""
    tm = pair[2]
    prompt, ref = jax_refs["crowd"]
    f = FaultInjector()
    fleet = ReplicaFleet.build(tm, n_replicas=1, **FLEET)
    auto = tqos.FleetAutoscaler(fleet, min_replicas=1, max_replicas=2,
                                scale_up_pending=0, cooldown_s=0.0,
                                drain_timeout=5.0, faults=f)
    try:
        f.install("fleet.scale_up", error=RuntimeError("provision failed"),
                  times=1)
        assert auto.tick() == "up_failed"
        assert list(fleet.replica_states()) == ["r0"]
        same_tokens(tm, fleet.infer(prompt, timeout=120), ref, len(prompt))
        assert auto.tick() == "up"
        states = fleet.replica_states()
        assert len(states) == 2 and states["r0"] == "ready"
        np.testing.assert_array_equal(fleet.infer(prompt, timeout=120), ref)
        auto.scale_up_pending = 8
        assert auto.tick() == "down"
        assert sum(1 for s in fleet.replica_states().values()
                   if s == "ready") == 1
        np.testing.assert_array_equal(fleet.infer(prompt, timeout=120), ref)
        prom = render_prometheus(fleet.registry)
        for direction, outcome in (("up", "error"), ("up", "ok"),
                                   ("down", "ok")):
            line = ('paddle_fleet_scale_events_total{direction="'
                    f'{direction}",outcome="{outcome}"}} 1')
            assert line in prom, line
        snap = dict(fleet.metrics.snapshot())
        assert snap.get("accepted") == snap.get("completed") == 3
    finally:
        auto.stop()
        fleet.close()


def test_autoscale_flash_crowd_warmup_gated_then_drain_down(pair, jax_refs):
    """A crowd held at r0's first launch (the gate) drives the pending
    depth over the threshold -> ``tick()`` scales up a WARMING replica,
    which takes no traffic until its programs are built -> the gate opens,
    every client completes exactly once -> the quiet fleet drains down."""
    tm = pair[2]
    prompt, ref = jax_refs["crowd"]
    led = tqos.TenantLedger()
    led.register("crowd", weight=1.0, priority=1)
    f = GateInjector("predictor.generate", at=1)
    fleet = ReplicaFleet.build(tm, n_replicas=1, qos=led,
                               replica_kwargs=[dict(faults=f)], **FLEET)
    auto = tqos.FleetAutoscaler(fleet, min_replicas=1, max_replicas=2,
                                scale_up_pending=4, scale_down_pending=0,
                                scale_down_kv_util=0.25, cooldown_s=0.0,
                                drain_timeout=5.0,
                                replica_overrides={"warmup": True},
                                ledger=led)
    N = 6
    box = {}
    try:
        t = threading.Thread(target=lambda: box.update(outs=storm(
            lambda i: np.asarray(fleet.infer(prompt, timeout=300,
                                             tenant="crowd")), N, 300)))
        t.start()
        assert f.stalled.wait(60)
        wait_for(lambda: fleet.pending() >= auto.scale_up_pending,
              "the crowd never queued")
        assert auto.signals()["pending"] >= auto.scale_up_pending
        assert auto.tick() == "up"
        r1 = fleet._by_name("r1")
        while not r1.predictor.ready():
            prom = render_prometheus(fleet.registry)
            dispatched = [ln for ln in prom.splitlines()
                          if ln.startswith("paddle_fleet_dispatch_total")
                          and 'replica="r1"' in ln
                          and not ln.rstrip().endswith(" 0")]
            assert dispatched == [], dispatched
            time.sleep(0.005)
        assert r1.predictor.warm_stats()["missing"] == []
        f.release()
        t.join(timeout=300)
        assert not t.is_alive()
        for o in box["outs"]:
            assert isinstance(o, np.ndarray), o
            same_tokens(tm, o, ref, len(prompt))
        snap = dict(fleet.metrics.snapshot())
        assert snap.get("accepted") == snap.get("completed") == N
        assert snap.get("failed", 0) == 0 and snap.get("timeouts", 0) == 0
        wait_for(lambda: fleet.pending() == 0, "the fleet never drained")
        assert auto.tick() == "down"
        assert sum(1 for s in fleet.replica_states().values()
                   if s == "ready") == 1
        np.testing.assert_array_equal(
            fleet.infer(prompt, timeout=120, tenant="crowd"), ref)
        assert led.snapshot()["crowd"]["tokens_done"] == 3 * (N + 1)
        for rep in fleet._snapshot():
            if fleet._refresh(rep) == "ready":
                assert rep.predictor.kv_cache.blocks_in_use == 0
                rep.predictor.kv_cache.check_conservation()
        assert ('paddle_fleet_scale_events_total'
                '{direction="up",outcome="ok"} 1') in render_prometheus(
                    fleet.registry)
    finally:
        f.release()
        auto.stop()
        fleet.close()
