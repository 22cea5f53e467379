"""The utilization ledger in the port (``observability/utilization.py``,
``observability/device.py`` and the scheduler's ``utilization=`` knob),
held against the JAX package (``tests/test_utilization.py``'s bodies).

Pure legs run ``attribute_launch`` and ``UtilizationLedger`` of both
packages on the same inputs and fake clocks and compare every integer and
reading (exact conservation: issued == useful + pad + spec_waste, the
tenant bills summing to useful). Live legs hold the port's scheduler to
conservation after every tick under mixed greedy / sampled / speculative
traffic, to never billing a paused tenant (the pause forced by a gate on
the launch site, no timed sleep), to the absent-iff-off series, and the
``/utilization`` and ``/debug/profile`` endpoints (a ``torch.profiler``
capture). The device table: the H100's 989e12 bf16 peak by name, None for
a CPU or an unknown card, and the MFU gauge only with a peak.
"""
import json
import os
import random
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.inference.speculative import SpecStats as JaxSpecStats
from paddle_tpu.observability import UtilizationLedger as JaxLedger
from paddle_tpu.observability import attribute_launch as jax_attribute
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu_torch.inference import InferenceServer
from paddle_tpu_torch.inference.qos import TenantLedger
from paddle_tpu_torch.inference.serving import PROFILE_MS_CAP
from paddle_tpu_torch.inference.speculative import SpecStats
from paddle_tpu_torch.observability import (
    UtilizationLedger,
    attribute_launch,
    cost_flops,
    device_peak_flops,
    memory_stats,
)
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability.metrics import render_prometheus
from serving_port import (
    FakeClock,
    GateInjector,
    continuous,
    get,
    jax_gpt,
    one_torch_thread,
    port_of,
    post_npz,
    wait_for,
)

_one_thread = pytest.fixture(autouse=True)(one_torch_thread)


def _conserved(issued, useful, pad, spec, bills):
    assert issued == useful + pad + spec
    assert sum(bills.values()) == useful
    assert min([issued, useful, pad, spec] + list(bills.values()),
               default=0) >= 0


LAUNCHES = [(3200, 32, [("gold", 8), ("bronze", 3)], 0),
            (800, 8, [(None, 2), (None, 2), ("gold", 1)], 0),
            (8000, 8, [("a", 3), ("b", 1)], 3)]


def test_attribute_launch_exact_shares_per_program_shape():
    for flops, total, slots, spec in LAUNCHES:
        got = attribute_launch(flops, total, slots, spec_units=spec)
        assert got == jax_attribute(flops, total, slots, spec_units=spec)
        _conserved(*got)
    assert attribute_launch(*LAUNCHES[0][:3])[:4] == (3200, 1100, 2100, 0)
    assert attribute_launch(*LAUNCHES[2][:3], spec_units=3)[4] == {
        "a": 3000, "b": 1000}


def test_attribute_launch_conservation_property_sweep():
    rng = random.Random(0x19)
    for _ in range(500):
        total = rng.randint(1, 64)
        budget = total
        slots = []
        for _ in range(rng.randint(0, 6)):
            u = rng.randint(0, max(0, budget))
            budget -= u
            slots.append((rng.choice([None, "a", "b", "c"]), u))
        spec = rng.randint(0, max(0, budget))
        flops = rng.choice([0, 1, rng.randint(1, 10**9),
                            float(rng.randint(0, 10**12))])
        got = attribute_launch(flops, total, slots, spec_units=spec)
        assert got == jax_attribute(flops, total, slots, spec_units=spec)
        _conserved(*got)
        assert got[0] == max(0, int(round(flops)))


def test_attribute_launch_guards():
    for args in ((None, 8, [("a", 3)]), (0.0, 8, [("a", 3)]),
                 (-5.0, 8, [("a", 3)]), (100, 0, [("a", 3)]),
                 (3, 8, [("a", 0), ("b", 4)])):
        assert attribute_launch(*args) == jax_attribute(*args)
    assert attribute_launch(100, 0, [("a", 3)]) == (100, 0, 100, 0, {})


def test_spec_stats_unit_split_matches_ledger_convention():
    for cls in (SpecStats, JaxSpecStats):
        st = cls()
        st.launches, st.emitted, st.drafted, st.accepted = 3, 7, 9, 4
        assert st.unit_split(4) == (7, 5, 0)
        assert cls().unit_split(4) == (0, 0, 0)


def _tick_math(cls):
    clk = FakeClock()
    led = cls(peak_flops=10_000.0, clock=clk)
    led.tick_begin()
    led.record_launch("prefill_chunk", 3200, 0.25, 32,
                      [("gold", 8), ("bronze", 3)])
    led.record_launch("decode_step", 800, 0.15, 8, [("gold", 2)])
    clk.tick(1.0)
    t = led.tick_end()
    return t, led.mfu(), led.snapshot(), led.metrics_block()


def test_ledger_tick_math_on_fake_clock():
    got, ref = _tick_math(UtilizationLedger), _tick_math(JaxLedger)
    assert got == ref
    t, mfu, snap, blk = got
    assert t["issued"] == 4000 and t["useful"] == 1300
    assert t["tenants"] == {"gold": 1000, "bronze": 300}
    assert t["host_gap_s"] == pytest.approx(0.60)
    assert mfu == pytest.approx(0.13)
    assert snap["flops"] == {"issued": 4000, "useful": 1300,
                             "pad_waste": 2700, "spec_waste": 0}
    assert blk["flops"]["issued"] == 4000


def test_ledger_warmup_and_clamp_guards():
    def body(cls):
        clk = FakeClock()
        led = cls(peak_flops=None, clock=clk)
        led.record_launch("prefill_chunk", 999, 0.1, 8, [(None, 8)])
        out = [(led.issued, led.last_tick)]
        led.tick_begin()
        led.record_launch("decode_step", 100, 5.0, 8, [(None, 2)])
        clk.tick(0.5)
        out += [led.tick_end()["host_gap_s"], led.tick_end(), led.mfu(),
                led.snapshot()["mfu"]]
        return out
    assert body(UtilizationLedger) == body(JaxLedger) == [
        (0, None), 0.0, None, 0.0, None]


def test_ledger_mfu_window_prunes_old_ticks():
    def body(cls):
        clk = FakeClock()
        led = cls(peak_flops=1000.0, clock=clk, mfu_window_s=10.0)
        led.tick_begin()
        led.record_launch("decode_step", 500, 0.1, 8, [(None, 8)])
        clk.tick(1.0)
        led.tick_end()
        out = [led.mfu()]
        clk.tick(5.0)
        out.append(led.mfu())
        clk.tick(20.0)
        return out + [led.mfu(), led.useful, led.issued]
    got = body(UtilizationLedger)
    assert got == body(JaxLedger)
    assert got[:3] == [pytest.approx(0.5), pytest.approx(500 / 6000.0), 0.0]


def test_ledger_series_render_and_mfu_gauge_absent_iff_no_peak():
    def body(cls, m):
        clk = FakeClock()
        reg = m.MetricsRegistry()
        led = cls(peak_flops=2000.0, clock=clk)
        led.bind_metrics(reg, component="continuous")
        texts = []
        for _ in range(2):
            led.tick_begin()
            led.record_launch("verify_step", 1000, 0.2, 8, [("gold", 3)],
                              spec_units=2)
            clk.tick(0.5)
            led.tick_end()
            texts.append(m.render_prometheus(reg))
        reg2 = m.MetricsRegistry()
        cls(peak_flops=None, clock=clk, device=()).bind_metrics(
            reg2, component="c2")
        return texts + [m.render_prometheus(reg2)]
    got = body(UtilizationLedger, tmetrics)
    assert got == body(JaxLedger, jmetrics)
    assert ('paddle_serving_flops_total{component="continuous",'
            'kind="spec_waste"} 250') in got[0]
    assert 'paddle_serving_mfu{component="continuous"}' in got[0]
    assert "paddle_serving_flops_total" in got[2]
    assert "paddle_serving_mfu" not in got[2]


def test_device_peak_table_and_memory_stats_off_the_card():
    """The peak comes from the H100 data sheet by the card's name (989e12
    bf16); a CPU device and an unknown card give None, so the MFU gauge is
    absent; a ledger over the H100's name reads MFU off 989e12."""
    assert device_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert device_peak_flops("NVIDIA A100-SXM4-80GB") is None
    assert device_peak_flops("cpu") is None
    reg = tmetrics.MetricsRegistry()
    clk = FakeClock()
    led = UtilizationLedger(device="NVIDIA H100 80GB HBM3", clock=clk)
    assert led.peak_flops == 989e12
    led.bind_metrics(reg, component="c")
    led.tick_begin()
    led.record_launch("decode_step", 989e9, 0.001, 8, [(None, 8)])
    clk.tick(1.0)
    led.tick_end()
    assert led.mfu() == pytest.approx(1e-3)
    assert 'paddle_serving_mfu{component="c"} 0.001' in render_prometheus(
        reg)
    if not torch.cuda.is_available():
        assert memory_stats() == {}
        assert UtilizationLedger().peak_flops is None


def test_cost_flops_reads_the_count_a_body_run_took():
    """``cost_flops`` is the runner's own count: 0.0 until a run counted
    its program, then the aten products of one body run."""
    from paddle_tpu_torch.jit.graphs import StepRunner

    w = torch.randn(8, 16)

    def body(inp, out):
        out["y"].copy_(inp["x"] @ w)
    run = StepRunner("cpu", {"x": ((4, 8), torch.float32)},
                     {"y": ((4, 16), torch.float32)}, {"step": body})
    run.fill(x=np.ones((4, 8), np.float32))
    run.run("step")
    assert cost_flops(run) == 0.0
    run.run("step", count_flops=True)
    assert cost_flops(run) == 2 * 4 * 8 * 16
    assert cost_flops(run, "other") == 0.0


# ----------------------------------------------------------------- live legs
@pytest.fixture(scope="module")
def tm():
    jm, cfg = jax_gpt(19)
    return port_of(jm, cfg)


def _record_ticks(sched):
    """Every tick's decomposition, with the paused tenants at its close."""
    seen = []
    orig = sched.util.tick_end

    def wrapped():
        paused = {s.tenant for s in sched._paused}
        t = orig()
        if t is not None:
            seen.append((t, paused))
        return t

    sched.util.tick_end = wrapped
    return seen


def test_scheduler_conservation_after_every_tick_mixed_traffic(tm):
    """Mixed greedy / sampled / speculative traffic: conservation holds
    exactly after every tick and per program, tenant bills close on useful,
    rejected drafts land in spec_waste, the flight ring carries each tick's
    split, and greedy output is the same with speculation on and off."""
    ledger = TenantLedger()
    ledger.register("gold", weight=2.0)
    ledger.register("bronze", weight=1.0)
    sched = continuous(tm, spec_k=3, qos=ledger, flight_recorder=16,
                       utilization=True)
    ticks = _record_ticks(sched)
    rng = np.random.RandomState(19)
    prompts = [rng.randint(0, 160, (rng.randint(3, 9),)).astype("int64")
               for _ in range(8)]
    try:
        outs = {}

        def client(i):
            kw = {"tenant": "gold" if i % 2 else "bronze"}
            if i % 3 == 1:
                kw.update(temperature=0.8, top_k=5)
            if i % 4 == 3:
                kw["spec"] = False
            outs[i] = sched.infer(prompts[i], timeout=120, **kw)

        ts = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert len(outs) == 8 and ticks
        for t, _ in ticks:
            assert t["issued"] == t["useful"] + t["pad"] + t["spec_waste"]
            assert sum(t["tenants"].values()) == t["useful"]
            for p in t["programs"].values():
                assert p["issued"] == (p["useful"] + p["pad"]
                                       + p["spec_waste"])
            assert t["wall_s"] >= 0 and t["host_gap_s"] >= 0
        snap = sched.util.snapshot()
        fl = snap["flops"]
        assert fl["issued"] == sum(t["issued"] for t, _ in ticks)
        assert fl["issued"] == (fl["useful"] + fl["pad_waste"]
                                + fl["spec_waste"])
        assert sum(snap["tenants"].values()) == fl["useful"]
        assert set(snap["tenants"]) <= {"gold", "bronze"}
        assert fl["useful"] > 0 and fl["pad_waste"] > 0
        assert fl["spec_waste"] > 0
        assert snap["mfu"] is None          # the CPU: no peak, no MFU
        utils = [tk["util"] for tk in sched.flight.dump()["ticks"]
                 if "util" in tk]
        assert utils and all(
            u["issued"] == u["useful"] + u["pad"] + u["spec_waste"]
            for u in utils)
        # one FLOP count per program key, kept on its runner
        for run in tm._runner_cache().values():
            assert set(run.flops) <= {"step"}
            assert cost_flops(run) == run.flops.get("step", 0.0)
        a = sched.infer(prompts[0], timeout=120, spec=True)
        b = sched.infer(prompts[0], timeout=120, spec=False)
        np.testing.assert_array_equal(a, b)
    finally:
        sched.close()


def test_preemption_pause_never_bills_the_paused_tenant(tm):
    """A paused sequence is off-slot: no tick that closes while it is
    parked bills its tenant. The pause is forced: the low-priority
    sequence's second launch waits on a gate until the high-priority
    request is queued."""
    ledger = TenantLedger()
    ledger.register("low", weight=1.0, priority=2)
    ledger.register("high", weight=1.0, priority=0)
    f = GateInjector("predictor.generate", at=2)
    sched = continuous(tm, max_slots=1, max_new_tokens=16, max_seq_len=64,
                       qos=ledger, utilization=True, faults=f)
    ticks = _record_ticks(sched)
    rng = np.random.RandomState(7)
    ids = {n: rng.randint(0, 160, (6,)).astype("int64")
           for n in ("low", "high")}
    try:
        done = {}

        def run(name):
            done[name] = sched.infer(ids[name], timeout=120, tenant=name)

        t_low = threading.Thread(target=run, args=("low",))
        t_low.start()
        assert f.stalled.wait(60)
        t_high = threading.Thread(target=run, args=("high",))
        t_high.start()
        wait_for(lambda: sched._queue.qsize() >= 1, "high never queued")
        f.release()
        t_low.join(timeout=120)
        t_high.join(timeout=120)
        assert set(done) == {"low", "high"}
        assert sched.metrics.get("preempted_seqs") > 0
        assert any(paused for _, paused in ticks)
        for t, paused in ticks:
            assert not (set(t["tenants"]) & paused), (t["tenants"], paused)
        snap = sched.util.snapshot()
        assert sum(snap["tenants"].values()) == snap["flops"]["useful"]
        assert snap["tenants"]["low"] > 0 and snap["tenants"]["high"] > 0
    finally:
        f.release()
        sched.close()


def test_scheduler_off_means_off(tm):
    sched = continuous(tm)
    try:
        assert sched.util is None
        assert not getattr(sched._timing_hook, "wants_flops", False)
        sched.infer(np.arange(4, dtype="int64"), timeout=60)
        text = render_prometheus(sched.metrics.registry)
        for fam in ("paddle_serving_flops_total", "paddle_tenant_flops_total",
                    "paddle_serving_mfu", "paddle_serving_host_gap_seconds"):
            assert fam not in text
    finally:
        sched.close()


def test_server_utilization_endpoint_and_metrics_block(tm):
    sched = continuous(tm, utilization=True)
    srv = InferenceServer(sched, device="cpu").start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        assert post_npz(base, "/generate",
                        np.arange(5, dtype="int64"))[0] == 200
        status, body, hdrs = get(base, "/utilization")
        assert status == 200 and hdrs["Content-Type"] == "application/json"
        snaps = json.loads(body)
        assert list(snaps) == ["continuous"]
        fl = snaps["continuous"]["flops"]
        assert fl["issued"] == (fl["useful"] + fl["pad_waste"]
                                + fl["spec_waste"]) > 0
        assert sum(snaps["continuous"]["tenants"].values()) == fl["useful"]
        snap = json.loads(get(base, "/metrics")[1])
        assert snap["utilization"]["flops"]["issued"] == fl["issued"]
        assert "mfu" in snap["utilization"]
        assert snap["generator"]["utilization"]["flops"]["issued"] \
            == fl["issued"]
    finally:
        srv.stop()
        sched.close()


def test_server_utilization_404_without_ledger(tm):
    sched = continuous(tm)
    srv = InferenceServer(sched, device="cpu").start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        status, body, _ = get(base, "/utilization")
        assert status == 404 and b"no utilization ledger" in body
        assert "utilization" not in json.loads(get(base, "/metrics")[1])
    finally:
        srv.stop()
        sched.close()


def test_server_debug_profile_taxonomy_and_capture(tm, tmp_path):
    """/debug/profile: 400 on a missing / malformed / zero / oversized
    duration, 409 while a capture runs, 200 with a ``torch.profiler``
    trace and a chrome view joined with the tracer's spans."""
    sched = continuous(tm)
    srv = InferenceServer(sched, device="cpu",
                          profile_dir=str(tmp_path)).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        for q in ("", "?ms=soon", "?ms=0", f"?ms={PROFILE_MS_CAP + 1}"):
            assert get(base, "/debug/profile" + q)[0] == 400, q
        assert srv._profile_lock.acquire(blocking=False)
        try:
            status, body, hdrs = get(base, "/debug/profile?ms=50")
            assert status == 409 and b"already in flight" in body
            assert hdrs["Retry-After"] == "1"
        finally:
            srv._profile_lock.release()
        assert post_npz(base, "/generate",
                        np.arange(5, dtype="int64"))[0] == 200
        status, body, _ = get(base, "/debug/profile?ms=50")
        assert status == 200
        out = json.loads(body)
        assert out["ms"] == 50
        assert out["trace_dir"].startswith(str(tmp_path))
        assert os.path.isfile(out["trace"])
        joined = json.load(open(out["joined_chrome"]))["traceEvents"]
        assert any(e["name"] == "request" for e in joined)
        ts = [e["ts"] for e in joined]
        assert ts == sorted(ts)
    finally:
        srv.stop()
        sched.close()
