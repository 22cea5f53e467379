"""Deterministic fault injection against the port's serving stack
(``inference/faults.py`` at every site the JAX package checks), held to
the JAX package's chaos contract (``tests/test_chaos_serving.py``'s
bodies): under injected allocator OOM, predictor failures, slow calls and
batcher-thread death the server never deadlocks, sheds with 429 / 503 and
``Retry-After``, restarts its batcher (``Supervisor``), and every accepted
request reaches exactly one terminal outcome within its deadline.

Served tokens are JAX's dense greedy ones under the margin guard of
``serving_port``. Orderings the JAX bodies got from timed delays come from
a gate on a fault site here (``GateInjector``: one thread waits on an
event until the test releases it), and deadlines expire by skewing the
injected clock. The storms keep short delays: they assert only what holds
for every interleaving. Every test runs with the port's lock witness
(``paddle_tpu_torch/analysis/lockwitness.py``) active, as JAX's conftest
arms its own for the chaos legs: every lock the runtime makes during the
test is wrapped, and an acquisition-order inversion fails the test. JAX's
replica-kill leg is in ``test_torch_fleet.py``.
"""
import json
import threading

import numpy as np
import pytest
import torch

from paddle_tpu_torch.analysis import lockwitness
from paddle_tpu_torch.inference.faults import FaultInjector, ThreadDeath
from paddle_tpu_torch.inference.kv_cache import CacheOutOfBlocks, PagedKVCache
from paddle_tpu_torch.inference.resilience import (
    AdmissionController,
    CircuitBreaker,
    Rejected,
    ServerBusy,
    ServiceUnavailable,
)
from paddle_tpu_torch.inference.serving import (
    BatchingPredictor,
    GenerateBatchingPredictor,
    InferenceServer,
)
from serving_port import (
    Doubler,
    GateInjector,
    continuous,
    drain_outcomes,
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


@pytest.fixture(autouse=True)
def _port_lock_witness():
    """The port's witness, active for the whole test: every lock the
    serving runtime makes meanwhile records its acquisition order, and an
    inversion fails the test (JAX's conftest does this for its chaos legs
    with JAX's witness; the ``chaos`` marker would arm that one, which
    guards nothing here)."""
    w = lockwitness.activate(lockwitness.LockWitness())
    try:
        yield w
    finally:
        lockwitness.deactivate()
    if w.inversions:
        pytest.fail("lock witness observed acquisition-order inversions: "
                    f"{w.inversions}")


def _in_thread(fn):
    """Start ``fn`` on a thread; returns (thread, box): ``box["r"]`` its
    result or ``box["e"]`` what it raised."""
    box = {}

    def run():
        try:
            box["r"] = fn()
        except Exception as e:      # the caller inspects it
            box["e"] = e

    t = threading.Thread(target=run)
    t.start()
    return t, box


# ------------------------------------------------------- timeout cancellation
def test_timed_out_request_is_cancelled_not_computed():
    """A request that times out in the queue is cancelled: the batcher
    skips it and never computes it."""
    f = GateInjector("predictor.run", at=1)
    pred = Doubler()
    bp = BatchingPredictor(pred, max_batch_size=1, max_delay_ms=1, faults=f)
    try:
        ta, box = _in_thread(lambda: bp.infer(np.ones(2), timeout=10))
        assert f.stalled.wait(30)
        with pytest.raises(TimeoutError):
            bp.infer(np.full(2, 3.0), timeout=0.05)
        f.release()
        ta.join(timeout=10)
        assert box["r"][0][0] == 2.0
        assert bp.infer(np.full(2, 5.0), timeout=10)[0][0] == 10.0
        assert pred.calls == 2
        assert bp.metrics.get("cancelled_skipped") == 1
        assert bp.metrics.get("accepted") == 3
        assert drain_outcomes(bp.metrics) == 3
    finally:
        f.release()
        bp.close()


def test_clock_skew_expires_deadline_without_sleeping():
    """Deadlines ride the injected clock: skewing it expires a queued
    request at once, nowhere near its nominal minute."""
    f = GateInjector("predictor.run", at=1)
    bp = BatchingPredictor(Doubler(), max_batch_size=1, max_delay_ms=1,
                           faults=f)
    try:
        tb, bbox = _in_thread(lambda: bp.infer(np.ones(2),
                                                      timeout=30))
        assert f.stalled.wait(30)
        tv, vbox = _in_thread(lambda: bp.infer(np.ones(2),
                                                      timeout=60))
        wait_for(lambda: bp._queue.qsize() == 1, "the victim never queued")
        f.skew_clock(120.0)
        tv.join(timeout=5)
        assert not tv.is_alive()
        assert isinstance(vbox["e"], TimeoutError)
        f.release()
        tb.join(timeout=5)
        assert not tb.is_alive()
    finally:
        f.release()
        bp.close()


# -------------------------------------------------------- batcher thread death
def test_batcher_thread_death_is_healed_and_strands_no_request():
    f = FaultInjector()
    bp = BatchingPredictor(Doubler(), max_batch_size=2, max_delay_ms=1,
                           faults=f)
    try:
        f.install("batcher.batch", error=ThreadDeath(), times=1)
        assert bp.infer(np.ones(2), timeout=10)[0][0] == 2.0
        f.install("batcher.tick", error=ThreadDeath(), times=1)
        wait_for(lambda: not bp._sup.alive() or f.fired("batcher.tick"),
                 "the tick kill never landed")
        assert bp.infer(np.full(2, 2.0), timeout=10)[0][0] == 4.0
        assert bp.metrics.get("batcher_restarts") == bp._sup.restarts >= 2
        assert drain_outcomes(bp.metrics) == bp.metrics.get("accepted") == 2
    finally:
        bp.close()


def test_dead_batcher_past_restart_budget_sheds_503_not_deadlock():
    f = FaultInjector()
    f.install("batcher.tick", error=ThreadDeath(), times=10)
    bp = BatchingPredictor(Doubler(), max_batch_size=1, max_delay_ms=1,
                           faults=f, max_restarts=1)
    try:
        with pytest.raises((ServiceUnavailable, TimeoutError)):
            bp.infer(np.ones(2), timeout=3)
        assert not bp.ready()
    finally:
        bp.close()


def test_cancelled_mid_batch_result_is_discarded():
    """The client gives up while the predictor runs: the computed result
    loses the terminal CAS and is counted wasted."""
    f = GateInjector("predictor.run", at=1)
    pred = Doubler()
    bp = BatchingPredictor(pred, max_batch_size=1, max_delay_ms=1, faults=f)
    try:
        with pytest.raises(TimeoutError):
            bp.infer(np.ones(2), timeout=0.1)
        f.release()
        wait_for(lambda: bp.pending() == 0, "the batch never ended")
        assert pred.calls == 1
        assert bp.metrics.get("wasted_results") == 1
        assert bp.metrics.get("completed") == 0
        assert drain_outcomes(bp.metrics) == bp.metrics.get("accepted") == 1
    finally:
        f.release()
        bp.close()


# ----------------------------------------------------- predictor failure paths
def test_predictor_failure_retries_batch_then_succeeds():
    """Three requests in one batch (held at the loop's top until all three
    queued), the batch fails once and re-runs: each request retried once."""
    f = GateInjector("batcher.tick", at=1)
    bp = BatchingPredictor(Doubler(), max_batch_size=4, max_delay_ms=20,
                           faults=f, max_retries=1)
    try:
        f.install("predictor.run", error=RuntimeError("injected crash"),
                  times=1)
        assert f.stalled.wait(30)
        box = {}
        ts = [_in_thread(lambda i=i: box.setdefault(
            i, bp.infer(np.full(2, float(i)), timeout=20)))[0]
            for i in range(3)]
        wait_for(lambda: bp._queue.qsize() == 3, "the three never queued")
        f.release()
        for t in ts:
            t.join(timeout=20)
        for i in range(3):
            assert box[i][0][0] == 2.0 * i
        assert bp.metrics.get("batch_failures") == 1
        assert bp.metrics.get("retries") == 3
        assert drain_outcomes(bp.metrics) == 3
    finally:
        f.release()
        bp.close()


def test_circuit_breaker_trips_fails_fast_and_half_open_recovers():
    f = FaultInjector()
    breaker = CircuitBreaker(failure_threshold=2, reset_after=30.0,
                             clock=f.monotonic)
    bp = BatchingPredictor(Doubler(), max_batch_size=1, max_delay_ms=1,
                           faults=f, breaker=breaker, max_retries=0)
    try:
        f.install("predictor.run", error=RuntimeError("injected crash"),
                  times=2)
        for _ in range(2):
            with pytest.raises(RuntimeError):
                bp.infer(np.ones(2), timeout=10)
        assert breaker.state == "open"
        with pytest.raises(ServiceUnavailable) as ei:
            bp.infer(np.ones(2), timeout=10)
        assert ei.value.retry_after > 0
        assert bp.metrics.get("rejected_unavailable") == 1
        f.skew_clock(30.0)
        assert breaker.state == "half-open"
        assert bp.infer(np.ones(2), timeout=10)[0][0] == 2.0
        assert breaker.state == "closed"
    finally:
        bp.close()


def test_every_request_reaches_exactly_one_terminal_outcome_in_storm():
    """Crashes, slow calls, a thread death and tight deadlines: every
    client sees exactly one outcome, its own, the counters conserve, and
    the predictor serves afterwards."""
    f = FaultInjector()
    bp = BatchingPredictor(Doubler(), max_batch_size=4, max_delay_ms=2,
                           faults=f, max_retries=1,
                           breaker=CircuitBreaker(failure_threshold=4,
                                                  reset_after=0.2,
                                                  clock=f.monotonic))
    try:
        f.install("predictor.run", error=RuntimeError("crash"), after=2,
                  times=2)
        f.install("predictor.run", delay=0.05, after=6, times=2)
        f.install("batcher.batch", error=ThreadDeath(), after=4, times=1)
        outs = storm(lambda i: bp.infer(
            np.full(2, float(i)), timeout=(0.15 if i % 5 == 0 else 30)), 24,
            timeout=60)
        for i, o in enumerate(outs):
            assert isinstance(o, (list, TimeoutError, Rejected, Exception))
            if isinstance(o, list):
                assert o[0][0] == 2.0 * i
        assert bp.metrics.get("accepted") == drain_outcomes(bp.metrics)
        assert bp.infer(np.ones(2), timeout=10)[0][0] == 2.0
    finally:
        bp.close()


# --------------------------------------------------- generate (paged KV) legs
@pytest.fixture(scope="module")
def small_gpt():
    jm, cfg = jax_gpt(7, vocab=128, max_position=64)
    prompt = np.random.default_rng(0).integers(0, 128, 5).astype("int64")
    return port_of(jm, cfg), prompt, jax_dense_ref(jm, prompt, 3)


def _gen(tm, **kw):
    kw.setdefault("max_batch_size", 2)
    kw.setdefault("max_delay_ms", 5)
    kw.setdefault("block_size", 8)
    kw.setdefault("num_blocks", 16)
    return GenerateBatchingPredictor(tm, max_new_tokens=3, device="cpu",
                                     **kw)


def test_injected_allocator_oom_defers_and_completes(small_gpt):
    tm, prompt, ref = small_gpt
    f = FaultInjector()
    gp = _gen(tm, faults=f)
    try:
        f.install("kv.reserve", error=CacheOutOfBlocks("injected pool-dry"),
                  times=1)
        same_tokens(tm, gp.infer(prompt, timeout=120), ref, len(prompt))
        assert gp.metrics.get("deferred") == 1
        assert gp.kv_cache.blocks_in_use == 0
    finally:
        gp.close()


def test_allocator_oom_sheds_429_after_defer_budget(small_gpt):
    tm, prompt, _ = small_gpt
    f = FaultInjector()
    gp = _gen(tm, faults=f, max_defers=0)
    try:
        f.install("kv.allocate", error=CacheOutOfBlocks("injected pool-dry"),
                  times=1)
        with pytest.raises(ServerBusy) as ei:
            gp.infer(prompt, timeout=120)
        assert ei.value.status == 429 and ei.value.retry_after is not None
        assert f.fired("kv.allocate") == 1
        assert gp.metrics.get("shed_busy") == 1
        assert gp.kv_cache.blocks_in_use == 0
    finally:
        gp.close()


def test_oom_isolated_one_request_fails_alone_batch_completes(small_gpt):
    """A pool sized for one request: two concurrent requests both complete
    (one defers) — a dry pool never takes its batchmates down."""
    tm, prompt, ref = small_gpt
    gp = _gen(tm, max_delay_ms=30, num_blocks=1)
    try:
        outs = storm(lambda i: gp.infer(prompt, timeout=180), 2, 180)
        for o in outs:
            same_tokens(tm, o, ref, len(prompt))
        assert gp.metrics.get("deferred") >= 1
        assert gp.kv_cache.blocks_in_use == 0
    finally:
        gp.close()


def test_generate_timeout_frees_blocks_and_refuses_expired_launch(small_gpt):
    """The client times out while its batch is held before the launch; the
    launch's deadline gate then refuses it and every block returns."""
    tm, prompt, _ = small_gpt
    f = GateInjector("predictor.generate", at=1)
    gp = _gen(tm, faults=f)
    try:
        with pytest.raises(TimeoutError):
            gp.infer(prompt, timeout=0.1)
        f.release()
        wait_for(lambda: gp.pending() == 0, "the batch never ended")
        assert gp.metrics.get("timeouts") == 1
        assert gp.metrics.get("completed") == 0
        assert gp.metrics.get("wasted_results") == 0
        assert gp.kv_cache.blocks_in_use == 0
        assert drain_outcomes(gp.metrics) == gp.metrics.get("accepted") == 1
    finally:
        f.release()
        gp.close()


def test_generate_predictor_failure_retries_then_succeeds(small_gpt):
    tm, prompt, ref = small_gpt
    f = FaultInjector()
    gp = _gen(tm, faults=f, max_retries=1)
    try:
        f.install("predictor.generate",
                  error=RuntimeError("injected predictor crash"), times=1)
        same_tokens(tm, gp.infer(prompt, timeout=120), ref, len(prompt))
        assert gp.metrics.get("batch_failures") == 1
        assert gp.metrics.get("retries") == 1
        assert gp.kv_cache.blocks_in_use == 0
    finally:
        gp.close()


def test_signature_mismatch_degrades_to_dense_with_parity(small_gpt):
    tm, prompt, ref = small_gpt
    cache = PagedKVCache(2, 4, 16, block_size=8, num_blocks=16,
                         dtype=torch.float32, device="cpu")
    gp = _gen(tm, kv_cache=cache)
    try:
        assert gp.fallback_dense
        same_tokens(tm, gp.infer(prompt, timeout=120), ref, len(prompt))
        assert gp.metrics.get("dense_fallback_batches") == 1
        assert cache.blocks_in_use == 0
    finally:
        gp.close()


def test_generate_storm_exactly_one_terminal_and_pool_conserved(small_gpt):
    tm, prompt, ref = small_gpt
    f = FaultInjector()
    gp = _gen(tm, max_delay_ms=10, num_blocks=4, faults=f, max_retries=1,
              max_defers=32)
    try:
        f.install("kv.reserve", error=CacheOutOfBlocks("injected"), after=1,
                  times=1)
        f.install("predictor.generate", error=RuntimeError("injected"),
                  after=2, times=1)
        outs = storm(lambda i: gp.infer(prompt, timeout=300), 6, 300)
        for o in outs:
            if isinstance(o, np.ndarray):
                np.testing.assert_array_equal(o, ref)
        assert gp.metrics.get("accepted") == drain_outcomes(gp.metrics)
        assert gp.kv_cache.blocks_in_use == 0
    finally:
        gp.close()


# ------------------------------------------------------------ HTTP server legs
def test_server_readyz_backpressure_and_drain(small_gpt):
    tm, prompt, ref = small_gpt
    gp = _gen(tm)
    srv = InferenceServer(gp, device="cpu").start()
    base = f"http://127.0.0.1:{srv.port}"
    stopped = False
    try:
        assert get(base, "/health")[0] == 200
        assert get(base, "/readyz")[0] == 200
        status, body, _ = post_npz(base, "/generate", prompt)
        assert status == 200
        same_tokens(tm, out0(body), ref, len(prompt))
        assert json.loads(get(base, "/metrics")[1])["generator"][
            "completed"] == 1
        gp.admission = AdmissionController(max_queue_depth=0, retry_after=0.5)
        status, _, hdrs = post_npz(base, "/generate", prompt)
        assert status == 429 and int(hdrs["Retry-After"]) >= 1
        gp.admission = AdmissionController()
        assert post_npz(base, "/generate",
                        np.arange(300).astype("int64"))[0] == 400
        srv._draining.set()
        assert get(base, "/readyz")[0] == 503
        status, _, hdrs = post_npz(base, "/generate", prompt)
        assert status == 503 and "Retry-After" in hdrs
        srv._draining.clear()
        t, box = _in_thread(lambda: post_npz(base, "/generate",
                                                       prompt))
        srv.stop(drain_timeout=30)
        stopped = True
        t.join(timeout=30)
        if "r" not in box:      # refused at the socket: the loop was down
            assert isinstance(box["e"], OSError), box
        else:
            status, body, _ = box["r"]
            assert status in (200, 503)     # served or cleanly refused
            if status == 200:
                np.testing.assert_array_equal(out0(body), ref)
    finally:
        if not stopped:
            srv.stop(drain_timeout=2)


def test_server_maps_timeout_to_504(small_gpt):
    tm, prompt, _ = small_gpt
    f = GateInjector("predictor.generate", at=1)
    gp = _gen(tm, faults=f)
    srv = InferenceServer(gp, device="cpu").start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        status, _, _ = post_npz(base, "/generate", prompt,
                                {"X-Timeout-Ms": "100"})
        assert status == 504
    finally:
        f.release()
        srv.stop(drain_timeout=5)


# ------------------------------------------- continuous-scheduler chaos legs
def _cont(tm, faults=None, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_new_tokens", 3)
    kw.setdefault("num_blocks", 16)
    kw.setdefault("max_seq_len", 16)
    return continuous(tm, faults=faults, **kw)


def test_continuous_injected_reserve_oom_defers_and_completes(small_gpt):
    tm, prompt, ref = small_gpt
    f = FaultInjector()
    gp = _cont(tm, faults=f)
    try:
        f.install("kv.reserve", error=CacheOutOfBlocks("injected pool-dry"),
                  times=1)
        same_tokens(tm, gp.infer(prompt, timeout=120), ref, len(prompt))
        assert gp.metrics.get("deferred") == 1
        assert gp.kv_cache.blocks_in_use == 0
        gp.kv_cache.check_conservation()
    finally:
        gp.close()


def test_continuous_reserve_oom_sheds_429_after_defer_budget(small_gpt):
    tm, prompt, _ = small_gpt
    f = FaultInjector()
    gp = _cont(tm, faults=f, max_defers=0)
    try:
        f.install("kv.reserve", error=CacheOutOfBlocks("injected pool-dry"),
                  times=1)
        with pytest.raises(ServerBusy) as ei:
            gp.infer(prompt, timeout=120)
        assert ei.value.status == 429 and ei.value.retry_after is not None
        assert gp.metrics.get("shed_busy") == 1
        assert gp.kv_cache.blocks_in_use == 0
    finally:
        gp.close()


def test_continuous_batcher_thread_death_heals_and_strands_no_sequence(
        small_gpt):
    """A thread death mid-decode releases every slot's blocks and re-queues
    the pending sequences; the healed loop re-runs them to the same
    tokens."""
    tm, prompt, ref = small_gpt
    f = FaultInjector()
    gp = _cont(tm, faults=f)
    try:
        f.install("predictor.generate", error=ThreadDeath(), after=1,
                  times=1)
        same_tokens(tm, gp.infer(prompt, timeout=120), ref, len(prompt))
        f.install("batcher.tick", error=ThreadDeath(), times=1)
        wait_for(lambda: f.fired("batcher.tick") == 1,
                 "the tick kill never landed")
        np.testing.assert_array_equal(gp.infer(prompt, timeout=120), ref)
        assert gp._sup.restarts >= 2
        assert gp.kv_cache.blocks_in_use == 0
        gp.kv_cache.check_conservation()
        assert drain_outcomes(gp.metrics) == gp.metrics.get("accepted") == 2
    finally:
        gp.close()


def test_continuous_clock_skew_expires_deadline_mid_decode(small_gpt):
    """Skew the injected clock while a sequence is held at its decode
    launch: the next tick retires it with one DeadlineExceeded, frees its
    blocks, and serving goes on."""
    tm, prompt, ref = small_gpt
    # 5 prompt tokens in chunks of 4 and 2 new tokens in one decode
    # launch: 3 launches a request; the second's decode launch is the 6th
    f = GateInjector("predictor.generate", at=6)
    gp = _cont(tm, faults=f, max_new_tokens=3)
    try:
        np.testing.assert_array_equal(gp.infer(prompt, timeout=120), ref)
        assert f.calls("predictor.generate") == 3
        t, box = _in_thread(lambda: gp.infer(prompt, timeout=60))
        assert f.stalled.wait(30)
        f.skew_clock(120.0)
        t.join(timeout=30)
        assert isinstance(box.get("e"), TimeoutError), box
        f.release()
        wait_for(lambda: gp.pending() == 0, "the expired slot never freed")
        assert gp.kv_cache.blocks_in_use == 0
        gp.kv_cache.check_conservation()
        np.testing.assert_array_equal(gp.infer(prompt, timeout=120), ref)
        assert gp.metrics.get("timeouts") == 1
        assert drain_outcomes(gp.metrics) == gp.metrics.get("accepted") == 3
    finally:
        f.release()
        gp.close()


def test_continuous_storm_exactly_one_terminal_and_pool_conserved(small_gpt):
    tm, prompt, ref = small_gpt
    f = FaultInjector()
    gp = _cont(tm, faults=f, num_blocks=8, max_retries=1, max_defers=64)
    try:
        f.install("kv.reserve", error=CacheOutOfBlocks("injected"), after=1,
                  times=1)
        f.install("predictor.generate", error=RuntimeError("injected"),
                  after=2, times=1)
        f.install("predictor.generate", error=ThreadDeath(), after=5,
                  times=1)
        outs = storm(lambda i: gp.infer(
            prompt, timeout=(0.25 if i == 3 else 300)), 6, 300)
        for o in outs:
            if isinstance(o, np.ndarray):
                np.testing.assert_array_equal(o, ref)
        assert gp.metrics.get("accepted") == drain_outcomes(gp.metrics)
        assert gp.kv_cache.blocks_in_use == 0
        gp.kv_cache.check_conservation()
        np.testing.assert_array_equal(gp.infer(prompt, timeout=120), ref)
    finally:
        gp.close()


def test_chaos_lock_witness_ends_clean_and_matches_static_graph(
        small_gpt, _port_lock_witness):
    """JAX's runtime lock-witness leg: a fault-storm tick loop under the
    active witness, then (a) the witness saw the runtime's locks under
    JAX's names, (b) no order inversion, (c) the observed order unioned
    with the port's static lock graph stays acyclic."""
    from paddle_tpu_torch.analysis.threads import lock_order_graph

    w = _port_lock_witness
    tm, prompt, ref = small_gpt
    f = FaultInjector()
    gp = _cont(tm, faults=f, max_slots=2, num_blocks=8)
    try:
        f.install("kv.reserve", error=CacheOutOfBlocks("injected"), after=1,
                  times=1)
        f.install("predictor.generate", error=ThreadDeath(), after=2,
                  times=1)
        outs = storm(lambda i: gp.infer(prompt, timeout=300), 4, 300)
        for o in outs:
            if isinstance(o, np.ndarray):
                np.testing.assert_array_equal(o, ref)
        gp.kv_cache.check_conservation()
    finally:
        gp.close()
    witnessed = {a for edge in w.edges for a in edge}
    assert "kv_cache.PagedKVCache._lock" in witnessed, sorted(witnessed)
    assert w.acquisitions > 0 and w.edges
    assert w.inversions == []
    assert w.check_static(lock_order_graph()) == []


def test_prefix_lookup_fault_is_a_miss_never_a_failure(small_gpt):
    """``kv.prefix_match``: a failed lookup admits the request cold — same
    tokens, no failure, the lookup span tagged with the error."""
    tm, prompt, ref = small_gpt
    f = FaultInjector()
    gp = _cont(tm, faults=f, prefix_cache=True, block_size=4)
    try:
        f.install("kv.prefix_match", error=RuntimeError("index down"),
                  times=1)
        np.testing.assert_array_equal(
            gp.infer(prompt, timeout=120, trace_id="px-1"), ref)
        assert f.fired("kv.prefix_match") == 1
        spans = gp.tracer.trace("px-1")
        assert any(s.name == "prefix_lookup" and "index down"
                   in s.tags.get("error", "") for s in spans)
        assert gp.metrics.get("failed") == 0
    finally:
        gp.close()


def test_warmed_scheduler_survives_thread_death_with_nothing_captured(
        small_gpt):
    """A warmed scheduler through a batcher kill: the healed loop serves
    the re-queued sequence through the programs warmup built."""
    tm0, prompt, ref = small_gpt
    tm = port_of(*jax_gpt(7, vocab=128, max_position=64))
    f = FaultInjector()
    gp = _cont(tm, faults=f, warmup=True)
    try:
        wait_for(gp.ready, "warmup never finished", 90)
        assert gp.warm_stats()["missing"] == []
        n = len(tm._runner_cache())
        np.testing.assert_array_equal(gp.infer(prompt, timeout=120), ref)
        f.install("batcher.tick", error=ThreadDeath(), times=1)
        wait_for(lambda: f.fired("batcher.tick") == 1,
                 "the tick kill never landed")
        np.testing.assert_array_equal(gp.infer(prompt, timeout=120), ref)
        assert len(tm._runner_cache()) == n
        for prog in ("prefill_chunk", "decode_step"):
            assert gp._recompile_counter.labels(
                gp._component, prog).value == 0, prog
        assert gp.kv_cache.blocks_in_use == 0
        gp.kv_cache.check_conservation()
    finally:
        gp.close()
