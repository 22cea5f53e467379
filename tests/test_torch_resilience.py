"""The serving resilience primitives of the port (``inference/
resilience.py``: ``Deadline``, ``CircuitBreaker``, ``AdmissionController``,
``Supervisor``, ``ServingMetrics``) and the paged pool's atomicity, held
against the JAX package (``tests/test_resilience.py``'s bodies).

Time-dependent behaviour runs on fake clocks, the same operations on both
packages, and every state and hint is compared; the concurrency leg
asserts conservation invariants that hold for every interleaving.
"""
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.inference import resilience as jres
from paddle_tpu_torch.inference import resilience as tres
from paddle_tpu_torch.inference.kv_cache import CacheOutOfBlocks, PagedKVCache
from paddle_tpu_torch.inference.resilience import (
    AdmissionController,
    CircuitBreaker,
    Deadline,
    DeadlineExceeded,
    ServerBusy,
    ServiceUnavailable,
    ServingMetrics,
    Supervisor,
)
from serving_port import FakeClock, jax_gpt, port_of


def _both(fn):
    return fn(jres), fn(tres)


# --------------------------------------------------------------- Deadline
def test_deadline_counts_down_on_injected_clock():
    def body(res):
        clk = FakeClock(0.0)
        dl = res.Deadline.after(5.0, clk)
        out = [(dl.remaining(), dl.expired())]
        for t in (4.999, 5.0):
            clk.t = t
            out.append((dl.remaining(), dl.expired()))
        return out
    j, t = _both(body)
    assert j == t
    assert t[0] == (5.0, False) and t[1][1] is False and t[2] == (0.0, True)


def test_deadline_exceeded_is_a_timeout_error():
    assert issubclass(DeadlineExceeded, TimeoutError)
    assert issubclass(ServerBusy, tres.Rejected)
    assert (ServerBusy("x").status, ServiceUnavailable("x").status) == (
        jres.ServerBusy("x").status, jres.ServiceUnavailable("x").status)
    assert ServiceUnavailable("x", permanent=True).permanent


# --------------------------------------------------------- CircuitBreaker
def test_breaker_trips_half_opens_and_recovers():
    def body(res):
        clk = FakeClock(0.0)
        br = res.CircuitBreaker(failure_threshold=2, reset_after=10.0,
                                clock=clk)
        trail = [(br.state, br.allow())]
        br.record_failure()
        trail.append((br.state, br.allow()))
        br.record_failure()
        trail.append((br.state, br.allow(), br.trips, br.retry_after()))
        clk.t = 10.0
        trail.append((br.state, br.allow(), br.allow()))
        br.record_failure()
        trail.append((br.state, br.allow()))
        clk.t = 20.0
        trail.append(br.allow())
        br.record_success()
        trail.append((br.state, br.allow()))
        return trail
    j, t = _both(body)
    assert j == t
    assert t[2] == ("open", False, 1, 10.0)
    assert t[3] == ("half-open", True, False)
    assert t[4] == ("open", False) and t[6] == ("closed", True)


def test_breaker_success_resets_failure_streak():
    br = CircuitBreaker(failure_threshold=2, reset_after=10.0,
                        clock=FakeClock())
    br.record_failure()
    br.record_success()
    br.record_failure()
    assert br.state == "closed"


# ----------------------------------------------------- AdmissionController
class _PoolStub:
    num_blocks = 8
    live_utilization = 0.0


def test_admission_rejects_full_queue_with_retry_after():
    adm = AdmissionController(max_queue_depth=2, retry_after=0.7)
    adm.admit(1)
    with pytest.raises(ServerBusy) as ei:
        adm.admit(2)
    assert ei.value.retry_after == pytest.approx(0.7)
    assert ei.value.status == 429


def test_admission_rejects_oversized_request_as_permanent():
    with pytest.raises(ValueError):
        AdmissionController().admit(0, cache=_PoolStub(), blocks_needed=9)


def test_admission_sheds_on_pool_high_water():
    adm = AdmissionController(high_water=0.9)
    pool = _PoolStub()
    pool.live_utilization = 0.95
    with pytest.raises(ServerBusy):
        adm.admit(0, cache=pool, blocks_needed=1)
    pool.live_utilization = 0.5
    adm.admit(0, cache=pool, blocks_needed=1)


# --------------------------------------------------------------- Supervisor
def test_supervisor_restarts_dead_worker_then_gives_up():
    spawned = []

    def factory():
        t = threading.Thread(target=lambda: None, daemon=True)
        spawned.append(t)
        return t

    sup = Supervisor(factory, name="w", max_restarts=2)
    sup.start()
    sup.thread.join()
    assert sup.heal() is True and sup.restarts == 1
    sup.thread.join()
    assert sup.heal() is True and sup.restarts == 2
    sup.thread.join()
    assert sup.dead()
    with pytest.raises(ServiceUnavailable) as ei:
        sup.heal()
    assert ei.value.permanent
    assert len(spawned) == 3


def test_supervisor_heal_is_noop_while_alive():
    stop = threading.Event()
    sup = Supervisor(lambda: threading.Thread(target=stop.wait, daemon=True),
                     max_restarts=1)
    sup.start()
    try:
        assert sup.heal() is False and sup.restarts == 0
        assert sup.alive() and not sup.dead()
    finally:
        stop.set()
        sup.thread.join(timeout=2)


# ------------------------------------------------------------ ServingMetrics
def test_metrics_counters_and_latency_tail():
    def body(res):
        m = res.ServingMetrics()
        m.inc("accepted", 3)
        m.inc("completed")
        for ms in range(1, 101):
            m.observe_latency(ms / 1000.0)
        return (m.get("accepted"), m.get("missing"), m.snapshot())
    j, t = _both(body)
    assert j == t
    snap = t[2]
    assert t[:2] == (3, 0)
    assert snap["p50_ms"] == pytest.approx(50.0, abs=2.0)
    assert snap["p99_ms"] == pytest.approx(99.0, abs=2.0)
    assert snap["p50_ms"] <= snap["p95_ms"] <= snap["p99_ms"]
    assert isinstance(ServingMetrics(), tres.ServingMetrics)


# ------------------------------------------------- PagedKVCache atomicity
def _cache(num_blocks=8, block_size=4):
    return PagedKVCache(1, 2, 8, block_size=block_size,
                        num_blocks=num_blocks, dtype=torch.float32,
                        device="cpu")


def test_reserve_failure_is_atomic_no_partial_eviction():
    cache = _cache()
    cache.reserve("live", 16)
    cache.reserve("done1", 8)
    cache.mark_done("done1")
    cache.reserve("done2", 8)
    cache.mark_done("done2")
    assert cache.free_blocks == 0 and cache.evictable_blocks == 4
    with pytest.raises(CacheOutOfBlocks):
        cache.reserve("big", 24)
    assert set(cache._requests) == {"live", "done1", "done2"}
    assert cache.blocks_in_use == 8
    cache.reserve("ok", 12)
    assert cache.blocks_in_use == 7 and cache.evictable_blocks <= 1


def test_live_utilization_ignores_retained_done_requests():
    cache = _cache()
    cache.reserve("a", 16)
    cache.reserve("b", 16)
    assert cache.utilization == pytest.approx(1.0)
    assert cache.live_utilization == pytest.approx(1.0)
    cache.mark_done("b")
    assert cache.utilization == pytest.approx(1.0)
    assert cache.live_utilization == pytest.approx(0.5)


def test_paged_kv_concurrent_reserve_release_evict_conserves():
    cache = _cache(num_blocks=32)
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for it in range(60):
                rid = (seed, it)
                n = int(rng.integers(1, 9))
                try:
                    cache.reserve(rid, n * 4)
                except CacheOutOfBlocks:
                    continue
                if rng.random() < 0.5:
                    cache.mark_done(rid)
                else:
                    cache.release(rid)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    for rid in list(cache._requests):
        cache.release(rid)
    assert cache.blocks_in_use == 0 and cache.free_blocks == 32
    free = cache.allocator._free
    assert len(free) == 32 and len(set(free)) == 32


def test_generate_refuses_expired_deadline_before_launch():
    jm, cfg = jax_gpt(7, vocab=64, max_position=32)
    tm = port_of(jm, cfg)
    expired = Deadline(at=99.0, clock=FakeClock(100.0))
    with pytest.raises(DeadlineExceeded):
        tm.generate(np.zeros((1, 4), np.int64), max_new_tokens=2,
                    dtype=None, deadline=expired)
