"""The replica fleet of the port (``inference/serving.py`` ``ReplicaFleet``)
held to the JAX package's fleet contract (``tests/test_chaos_serving.py``'s
replica-kill leg, ``tests/test_qos.py``'s fleet legs are in
``test_torch_qos.py``): least-loaded routing with failover, drain /
undrain / retire, a killed replica's work re-dispatched to its sibling
with exactly-once terminals, the ``supports_*`` gates, and the server's
debug views per replica.

The port's difference: replicas do not share step programs. A captured
program holds its pool's addresses and its key names the pool, so each
replica builds one set of programs over its own pool, once, and serving
after warmup builds none.
"""
import json
import threading

import numpy as np
import pytest

from paddle_tpu_torch.inference import (
    AdapterRegistry,
    FaultInjector,
    InferenceServer,
    ReplicaFleet,
    ThreadDeath,
)
from paddle_tpu_torch.inference.qos import TenantLedger
from paddle_tpu_torch.inference.resilience import ServiceUnavailable
from paddle_tpu_torch.inference.warmup import program_keys
from paddle_tpu_torch.observability import SLOMonitor
from paddle_tpu_torch.observability.metrics import render_prometheus
from serving_port import (
    GateInjector,
    get,
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

_one_thread = pytest.fixture(autouse=True)(one_torch_thread)
KW = dict(max_slots=2, prefill_chunk=4, decode_steps=2, max_new_tokens=3,
          block_size=8, num_blocks=16, max_seq_len=16, device="cpu")


@pytest.fixture(scope="module")
def small_gpt():
    jm, cfg = jax_gpt(7, vocab=128, max_position=64)
    prompt = np.random.default_rng(0).integers(0, 128, 5).astype("int64")
    return jm, cfg, prompt, jax_dense_ref(jm, prompt, 3)


def test_replica_kill_mid_storm_siblings_absorb_no_stranding(small_gpt):
    """ThreadDeath into one replica's tick loop mid-storm with no restart
    budget: the fleet sees the permanent 503, marks it dead, re-dispatches
    its work to the sibling; every client gets the right tokens, the fleet
    conserves (accepted == completed) and the survivor's pool is clean."""
    jm, cfg, prompt, ref = small_gpt
    tm = port_of(jm, cfg)
    f = FaultInjector()
    fleet = ReplicaFleet.build(
        tm, n_replicas=2, replica_kwargs=[dict(faults=f, max_restarts=0), {}],
        **KW)
    try:
        same_tokens(tm, fleet.infer(prompt, timeout=120), ref, len(prompt))
        f.install("batcher.tick", error=ThreadDeath("chaos-kill"), after=2)
        outs = storm(lambda i: np.asarray(fleet.infer(prompt, timeout=300)),
                     8, 300)
        for o in outs:
            assert isinstance(o, np.ndarray), o
            np.testing.assert_array_equal(o, ref)
        states = fleet.replica_states()
        assert states["r0"] == "dead" and states["r1"] == "ready", states
        snap = dict(fleet.metrics.snapshot())
        assert snap.get("accepted") == snap.get("completed") == 9
        assert snap.get("failed", 0) == 0 and snap.get("timeouts", 0) == 0
        surv = fleet._by_name("r1").predictor
        assert surv.kv_cache.blocks_in_use == 0
        surv.kv_cache.check_conservation()
        text = render_prometheus(fleet.registry)
        assert 'paddle_fleet_replicas{state="dead"} 1' in text
        assert 'paddle_fleet_dispatch_total{replica="r0",outcome="dead"}' \
            in text or 'outcome="ok"' in text
    finally:
        fleet.close()


def test_one_capture_set_per_replica_and_none_after_warmup(small_gpt):
    """Two warmed replicas over one model: each builds the keys of its own
    pool (two programs each), and traffic through both builds nothing
    more."""
    jm, cfg, prompt, ref = small_gpt
    tm = port_of(jm, cfg)
    fleet = ReplicaFleet.build(tm, n_replicas=2, warmup=True, **KW)
    try:
        reps = [r.predictor for r in fleet._snapshot()]
        wait_for(lambda: all(p.ready() for p in reps), "warmup never ended")
        keys = [set(program_keys(p)) for p in reps]
        assert len(keys[0]) == len(keys[1]) == 2
        assert not keys[0] & keys[1]               # pools differ: keys too
        assert keys[0] | keys[1] == set(tm._runner_cache())
        assert reps[0].kv_cache.uid != reps[1].kv_cache.uid
        outs = storm(lambda i: np.asarray(fleet.infer(prompt, timeout=120)),
                     6, 120)
        for o in outs:
            np.testing.assert_array_equal(o, ref)
        assert set(tm._runner_cache()) == keys[0] | keys[1]
        for p in reps:
            assert p.warm_stats()["missing"] == []
            for prog in ("prefill_chunk", "decode_step"):
                assert p._recompile_counter.labels(
                    p._component, prog).value == 0
    finally:
        fleet.close()


def test_routing_drain_undrain_retire_and_failover(small_gpt):
    """Least-loaded routing skips a draining replica and an open breaker,
    fails over past a busy one, and a retired replica reads dead."""
    jm, cfg, prompt, ref = small_gpt
    tm = port_of(jm, cfg)
    fleet = ReplicaFleet.build(tm, n_replicas=2, **KW)
    try:
        fleet.drain_replica("r0")
        assert fleet._pick().name == "r1"
        np.testing.assert_array_equal(fleet.infer(prompt, timeout=120), ref)
        fleet.undrain_replica("r0")
        assert fleet.replica_states() == {"r0": "ready", "r1": "ready"}
        br = fleet._by_name("r1").predictor.breaker
        for _ in range(br.failure_threshold):
            br.record_failure()
        assert br.state == "open" and fleet._pick().name == "r0"
        br.record_success()
        fleet.retire_replica("r1", drain_timeout=5)
        assert fleet.replica_states()["r1"] == "dead"
        assert fleet.ready() and fleet._pick().name == "r0"
        fleet.retire_replica("r0", drain_timeout=5)
        assert not fleet.ready()
        with pytest.raises(ServiceUnavailable):
            fleet.infer(prompt, timeout=10)
        snap = dict(fleet.metrics.snapshot())
        assert snap.get("rejected_unavailable") == 1
        assert snap.get("accepted") == snap.get("completed") == 1
    finally:
        fleet.close()


def test_supports_gates_and_headers_through_a_fleet_server(small_gpt):
    """A fleet answers X-Adapter / X-Tenant iff its replicas carry a
    registry and a ledger (one shared by all); the server's debug views
    list every replica's recorder and ledger, /slo the shared monitor."""
    jm, cfg, prompt, ref = small_gpt
    tm = port_of(jm, cfg)
    plain = ReplicaFleet.build(tm, n_replicas=1, **KW)
    try:
        assert not plain.supports_adapters and not plain.supports_tenants
    finally:
        plain.close()
    reg = AdapterRegistry(tm, max_adapters=2)
    rs = np.random.RandomState(3)
    reg.register("ad", {p: (rs.randn(reg.dims(p)[0], 2).astype(np.float32)
                            * 0.3,
                            rs.randn(2, reg.dims(p)[1]).astype(np.float32)
                            * 0.3) for p in reg.target_paths()})
    led = TenantLedger()
    led.register("gold", priority=0)
    mon = SLOMonitor({"availability": 0.99})
    fleet = ReplicaFleet.build(tm, n_replicas=2, adapters=reg, qos=led,
                               slo=mon, flight_recorder=8, utilization=True,
                               **KW)
    srv = InferenceServer(fleet, device="cpu").start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        assert fleet.supports_adapters and fleet.supports_tenants
        status, body, _ = post_npz(base, "/generate", prompt,
                                   {"X-Tenant": "gold"})
        assert status == 200
        np.testing.assert_array_equal(out0(body), ref)
        status, body, _ = post_npz(base, "/generate", prompt,
                                   {"X-Adapter": "ad"})
        assert status == 200
        assert post_npz(base, "/generate", prompt,
                        {"X-Adapter": "ghost"})[0] == 400
        assert post_npz(base, "/generate", prompt,
                        {"X-Tenant": "ghost"})[0] == 400
        assert get(base, "/readyz")[0] == 200
        ticks = json.loads(get(base, "/debug/ticks")[1])
        assert len(ticks) == 2
        util = json.loads(get(base, "/utilization")[1])
        assert set(util) == {"r0", "r1"}
        slo = json.loads(get(base, "/slo")[1])
        assert slo["policies"]["availability"]["total_events"] == 2
        snap = json.loads(get(base, "/metrics")[1])
        assert snap["replicas"] == {"r0": "ready", "r1": "ready"}
        for rep in fleet._snapshot():
            p = rep.predictor
            assert p.adapters is reg and p.qos is led
    finally:
        srv.stop(drain_timeout=5)
        reg.close()


def test_stream_is_pinned_to_the_replica_that_accepted_it(small_gpt):
    """A streamed request fails over only at admission; its tokens come
    from the replica that accepted it, whose concatenation is infer()'s
    suffix; the fleet counts one completed terminal."""
    jm, cfg, prompt, ref = small_gpt
    tm = port_of(jm, cfg)
    f = GateInjector("batcher.tick", at=1)
    fleet = ReplicaFleet.build(tm, n_replicas=2,
                               replica_kwargs=[dict(faults=f), {}], **KW)
    try:
        assert f.stalled.wait(30)               # r0's loop is held
        fleet.drain_replica("r1")
        it = fleet.infer_stream(prompt, timeout=120)
        toks = []
        t = threading.Thread(target=lambda: toks.extend(
            int(x) for c in it for x in np.asarray(c).reshape(-1)))
        t.start()
        wait_for(lambda: fleet._by_name("r0").predictor._queue.qsize()
                 == 1, "the stream never queued on r0")
        f.release()
        t.join(timeout=60)
        assert toks == list(ref[len(prompt):])
        snap = dict(fleet.metrics.snapshot())
        assert snap.get("accepted") == snap.get("completed") == 1
    finally:
        f.release()
        fleet.close()
