"""Serving front: the request CAS, the batching predictors, the HTTP
endpoint and the replica fleet — the counterpart of
``paddle_tpu/inference/serving.py``.

Every request carries one deadline from the HTTP header through the queue
into the launch and reaches exactly one terminal outcome (result | failure
| cancel) through a compare-and-swap on its state. Overload is rejected at
the door (429 / 503 with ``Retry-After``), a dead batcher thread is
restarted by the clients waiting on it (``Supervisor``), repeated launch
failures trip a ``CircuitBreaker``, and ``inference/faults.py`` injects
deterministic faults at the seams for the chaos tests.

* ``BatchingPredictor`` coalesces single requests into batched
  ``predictor.run`` calls (``POST /predict``);
* ``GenerateBatchingPredictor`` batches whole generation requests over a
  shared paged KV pool (``POST /generate``); the continuous scheduler
  (``inference/scheduler.py``) is its subclass;
* ``InferenceServer`` speaks the JAX package's protocol: npz bodies, Server-
  Sent Events, the per-request headers ``X-Temperature`` / ``X-Top-K`` /
  ``X-Spec`` / ``X-Adapter`` / ``X-Tenant`` (a malformed value, or a header
  the generator cannot honour, is a 400), ``GET /health``, ``/readyz``,
  ``/metrics`` (JSON or Prometheus text), ``/slo``, ``/debug/ticks``,
  ``/utilization`` and ``/debug/profile?ms=N`` (a ``torch.profiler``
  capture joined with the tracer's spans);
* ``ReplicaFleet`` routes to the least-loaded of N continuous schedulers
  over one model. Unlike the JAX fleet, replicas do not share step
  programs: a captured program holds its pool's addresses, so each
  replica captures its own set over its own pool.
"""
from __future__ import annotations

import io
import itertools
import json
import math
import os
import queue
import tempfile
import threading
import time

import numpy as np
import torch

from ..framework import resolve_device
from ..observability.metrics import MetricsRegistry, render_prometheus
from ..observability.trace import RequestTrace, Tracer, new_trace_id
from .faults import ThreadDeath
from .kv_cache import CacheOutOfBlocks, PagedKVCache
from .resilience import (
    AdmissionController,
    CircuitBreaker,
    Deadline,
    DeadlineExceeded,
    Rejected,
    ServerBusy,
    ServiceUnavailable,
    ServingMetrics,
    Supervisor,
)

__all__ = ["BatchingPredictor", "GenerateBatchingPredictor",
           "InferenceServer", "ReplicaFleet", "retry_after_header",
           "RETRY_AFTER_CAP", "PROFILE_MS_CAP"]

# Retry-After ceiling (seconds): a rate-limited tenant with a deep token
# debt re-probes within a minute instead of sleeping out the whole debt
RETRY_AFTER_CAP = 60.0

# /debug/profile duration ceiling (ms): larger requests are a 400
PROFILE_MS_CAP = 10_000

_PENDING, _DONE, _CANCELLED = "pending", "done", "cancelled"


def retry_after_header(retry_after, cap=RETRY_AFTER_CAP) -> str:
    """Retry-After value of a shed's computed hint: ceil to whole seconds,
    floor 1 (0 invites a retry storm), cap at ``cap``; a hint-less shed
    (None) gets the 1 s floor."""
    if retry_after is None:
        return "1"
    return str(int(min(max(1, math.ceil(float(retry_after))),
                       math.ceil(cap))))


class _Request:
    """One in-flight request with compare-and-swap terminal semantics:
    exactly one of finish()/fail()/cancel() wins; the losers see False."""

    __slots__ = ("arrays", "event", "result", "error", "deadline", "retries",
                 "defers", "t0", "trace", "enq_us", "max_new", "temperature",
                 "top_k", "spec", "adapter", "tenant", "on_tokens",
                 "attribution", "_lock", "_state")

    def __init__(self, arrays, deadline=None, trace=None):
        self.arrays = arrays
        self.deadline = deadline
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.retries = 0        # failed-batch re-runs consumed
        self.defers = 0         # pool-full deferrals consumed
        self.t0 = None
        self.trace = trace      # observability.trace.RequestTrace | None
        self.enq_us = None      # queue-entry stamp (tracer µs) of this pass
        self.max_new = None     # per-request token budget (continuous)
        self.temperature = None
        self.top_k = None
        self.spec = None        # speculation opt-out (None: the default)
        self.adapter = None     # LoRA adapter name (continuous)
        self.tenant = None      # QoS tenant name (continuous)
        self.on_tokens = None   # streaming flush callback (infer_stream)
        # {queue,prefill,paused,decode}_share, set by the continuous
        # scheduler so the terminal span carries where the time went
        self.attribution = None
        self._lock = threading.Lock()
        self._state = _PENDING

    @property
    def state(self):
        return self._state

    def finish(self, result) -> bool:
        with self._lock:
            if self._state != _PENDING:
                return False
            self.result = result
            self._state = _DONE
            self.event.set()
            return True

    def fail(self, error) -> bool:
        with self._lock:
            if self._state != _PENDING:
                return False
            self.error = error
            self._state = _DONE
            self.event.set()
            return True

    def cancel(self) -> bool:
        with self._lock:
            if self._state != _PENDING:
                return False
            self._state = _CANCELLED
            self.event.set()
            return True


class BatchingPredictor:
    """Coalesce concurrent single requests into batched ``predictor.run``
    calls (JAX ``serving.py:165-580``).

    Requests are stacked and padded to the next power-of-two bucket (at
    most ``max_batch_size``) by repeating the first row. ``admission``
    sheds at submit time (ServerBusy -> 429), ``breaker`` fails fast after
    repeated predictor failures (ServiceUnavailable -> 503),
    ``max_retries`` re-runs the requests of a failed batch, and a
    ``Supervisor`` restarts the batcher thread if it dies: clients waiting
    in ``_await`` drive the restart, so no watchdog thread is needed.
    ``faults`` (a ``FaultInjector``) checks ``batcher.tick``,
    ``batcher.batch`` and ``predictor.run``, and its clock replaces the
    monotonic one. ``tracer`` records request-scoped spans (pass
    ``Tracer(enabled=False)`` to serve untraced); ``registry`` /
    ``component`` place the metrics series (replicas of a fleet share one
    registry under distinct components)."""

    supports_sampler_knobs = False  # per-request headers: continuous only
    supports_streaming = False      # SSE: continuous only
    supports_adapters = False       # X-Adapter: continuous + registry
    supports_tenants = False        # X-Tenant: continuous + ledger

    _component = "batcher"      # prometheus `component` label value

    def __init__(self, predictor, max_batch_size=8, max_delay_ms=2.0,
                 faults=None, admission=None, breaker=None, max_retries=1,
                 max_restarts=5, tracer=None, registry=None, component=None):
        self.predictor = predictor
        if component is not None:
            self._component = str(component)
        self.max_batch_size = int(max_batch_size)
        self.max_delay = max_delay_ms / 1000.0
        self.max_retries = int(max_retries)
        self._faults = faults
        self._clock = (faults.monotonic if faults is not None
                       else time.monotonic)
        self.tracer = tracer if tracer is not None else Tracer()
        self.metrics = ServingMetrics(registry=registry,
                                      component=self._component)
        self.metrics.registry.counter(
            "paddle_trace_dropped_spans_total",
            "Spans evicted from the tracer ring buffer (raise Tracer "
            "capacity= if this grows during an incident window)",
            labels=("component",)).labels(self._component).set_function(
                lambda: float(self.tracer.dropped))
        self.admission = admission if admission is not None \
            else AdmissionController()
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            failure_threshold=5, reset_after=1.0, clock=self._clock)
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._busy = False
        self.batch_sizes: list[int] = []
        self._sup = Supervisor(
            self._make_thread,
            name=f"{type(self).__name__}[{self._component}]",
            max_restarts=max_restarts)
        self._start_worker()

    def _start_worker(self):
        """Start the batcher thread (subclasses finish their own set-up
        first)."""
        self._sup.start()

    def _make_thread(self):
        return threading.Thread(target=self._thread_main, daemon=True,
                                name=f"batching-predictor[{self._component}]")

    def _thread_main(self):
        try:
            self._loop()
        except ThreadDeath:
            pass    # the worker dies; the supervisor heals it

    # ---------------------------------------------------------------- client
    def infer(self, *arrays, timeout=None, deadline=None, trace_id=None):
        """One sample in (arrays without the batch dim), one out.
        ``timeout`` seconds become a Deadline that rides the request;
        expiry anywhere raises DeadlineExceeded (a TimeoutError) here,
        exactly once. ``trace_id`` joins an existing trace."""
        req = self._make_request([np.asarray(a) for a in arrays],
                                 timeout, deadline, trace_id)
        return self._submit(req)

    def _make_request(self, arrays, timeout, deadline, trace_id=None):
        if deadline is None and timeout is not None:
            deadline = Deadline.after(float(timeout), self._clock)
        return _Request(arrays, deadline,
                        trace=RequestTrace(self.tracer, trace_id))

    def _admission_check(self, arrays, req=None):
        self.admission.admit(self._queue.qsize())

    def _enqueue(self, req):
        """Queue entry (first pass and every defer / retry / death re-pass):
        stamps the queue-wait span's start."""
        req.enq_us = req.trace.now_us() if req.trace is not None else None
        self._queue.put(req)

    def _submit(self, req):
        self._start(req)
        return self._await(req)

    def _start(self, req):
        """Synchronous admission: shed / breaker / validation outcomes
        raise here (before any response byte of a stream), then the
        accepted request enters the queue."""
        tr = req.trace
        t_adm = tr.now_us()
        try:
            if self._stop.is_set() or self._draining.is_set():
                raise ServiceUnavailable("predictor is shutting down",
                                         retry_after=None)
            if self._sup.heal():
                self.metrics.inc("batcher_restarts")
            if not self.breaker.allow():
                raise ServiceUnavailable(
                    "circuit open after repeated predictor failures",
                    retry_after=self.breaker.retry_after())
            self._admission_check(req.arrays, req)
        except Rejected as e:
            self.metrics.inc("rejected_busy" if isinstance(e, ServerBusy)
                             else "rejected_unavailable")
            # a door rejection is a terminal for the availability SLO too:
            # 429 is the client's backpressure (good), 503 is ours (bad)
            slo = getattr(self, "slo", None)
            if slo is not None:
                slo.observe_terminal(e.status < 500,
                                     tenant=getattr(req, "tenant", None))
            tr.child("admission", t_adm, tr.now_us(), error=repr(e))
            tr.finish("rejected", status=e.status, error=repr(e),
                      queue_share=1.0, prefill_share=0.0,
                      paused_share=0.0, decode_share=0.0)
            raise
        except ValueError as e:  # malformed / oversized: no retry can fix it
            self.metrics.inc("rejected_invalid")
            tr.child("admission", t_adm, tr.now_us(), error=repr(e))
            tr.finish("rejected", status=400, error=repr(e))
            raise
        tr.child("admission", t_adm, tr.now_us())
        self.metrics.inc("accepted")
        req.t0 = self._clock()
        self._enqueue(req)

    def _await(self, req):
        """Wait for the terminal outcome, healing a dead batcher meanwhile;
        a client-side deadline cancels."""
        while True:
            if req.deadline is None:
                step = 0.1
            else:
                rem = req.deadline.remaining()
                if rem <= 0:
                    if req.cancel():
                        self.metrics.inc("timeouts")
                        self._observe(req)
                        if req.trace is not None:
                            req.trace.finish("timeout", cas="timeout",
                                             where="client_wait")
                        raise DeadlineExceeded("inference request timed out")
                    break   # lost the race: a terminal outcome just landed
                step = min(0.1, rem)
            if req.event.wait(step):
                break
            try:
                if self._sup.heal():
                    self.metrics.inc("batcher_restarts")
            except ServiceUnavailable as e:
                self._fail(req, e)
                raise
        if req.error is not None:
            raise req.error
        return req.result

    # --------------------------------------------------------- terminal CAS
    def _observe(self, req):
        if req.t0 is not None:
            self.metrics.observe_latency(self._clock() - req.t0)

    def _finish_req(self, req, result) -> bool:
        if req.finish(result):
            self.metrics.inc("completed")
            self._observe(req)
            if req.trace is not None:
                req.trace.finish("result", cas="result",
                                 **(req.attribution or {}))
            return True
        self.metrics.inc("wasted_results")  # the client already gave up
        if req.trace is not None:
            req.trace.event("wasted_result")
        return False

    def _fail(self, req, error) -> bool:
        if not req.fail(error):
            return False
        if isinstance(error, DeadlineExceeded):
            self.metrics.inc("timeouts")
            terminal = "timeout"
        else:
            self.metrics.inc("failed")
            terminal = "error"
            if isinstance(error, ServerBusy):
                self.metrics.inc("shed_busy")
                terminal = "shed"
            elif isinstance(error, ServiceUnavailable):
                self.metrics.inc("shed_unavailable")
                terminal = "shed"
        self._observe(req)
        if req.trace is not None:
            req.trace.finish(terminal, cas=terminal, error=repr(error),
                             **(req.attribution or {}))
        return True

    def _fail_or_retry(self, req, error):
        """Give the request another batch unless the error is terminal by
        construction (shed / deadline) or its deadline has passed."""
        retryable = not isinstance(error, (Rejected, DeadlineExceeded))
        if (retryable and req.retries < self.max_retries
                and not self._stop.is_set()
                and not (req.deadline is not None
                         and req.deadline.expired())):
            req.retries += 1
            self.metrics.inc("retries")
            if req.trace is not None:
                req.trace.event("retry", attempt=req.retries,
                                error=repr(error))
            self._enqueue(req)
        else:
            self._fail(req, error)

    def _usable(self, req) -> bool:
        """Collection-time filter: cancelled requests are skipped, expired
        ones failed here; neither costs a batch slot."""
        state = req.state
        if state != _PENDING:
            if state == _CANCELLED:
                self.metrics.inc("cancelled_skipped")
            return False
        if req.deadline is not None and req.deadline.expired():
            if req.trace is not None and req.enq_us is not None:
                req.trace.child("queue_wait", req.enq_us,
                                req.trace.now_us(), expired=True)
                req.enq_us = None
            if self._fail(req, DeadlineExceeded("deadline expired in queue")):
                self.metrics.inc("expired_in_queue")
            return False
        return True

    # ---------------------------------------------------------------- worker
    def _bucket(self, n):
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch_size)

    def _loop(self):
        while not self._stop.is_set():
            if self._faults is not None:
                self._faults.check("batcher.tick")  # ThreadDeath escapes
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            self._busy = True
            try:
                t_as = self.tracer.now_us() if self.tracer.enabled else 0.0
                batch = self._collect(first)
                if self.tracer.enabled and batch:
                    t_as1 = self.tracer.now_us()
                    for r in batch:
                        if r.trace is not None:
                            r.trace.child("batch_assembly", t_as, t_as1,
                                          batch_size=len(batch))
                try:
                    self._run_batch(batch)
                except ThreadDeath:
                    for r in batch:     # the dying thread strands no work
                        if r.state == _PENDING:
                            self._enqueue(r)
                    raise
            finally:
                self._busy = False

    def _collect(self, first):
        """Up to max_batch_size usable requests within the max_delay
        window, waking early once the batch fills."""
        batch = [first] if self._usable(first) else []
        deadline = self._clock() + self.max_delay
        while len(batch) < self.max_batch_size:
            remaining = deadline - self._clock()
            if remaining <= 0:
                break
            try:
                r = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if self._usable(r):
                batch.append(r)
        return batch

    def _end_queue_wait(self, batch):
        """Close each collected request's queue-wait span."""
        if not self.tracer.enabled:
            return
        now = self.tracer.now_us()
        for r in batch:
            if r.trace is not None and r.enq_us is not None:
                r.trace.child("queue_wait", r.enq_us, now)
                r.enq_us = None

    def _span_each(self, batch, name, start_us, end_us, **tags):
        """One batch-level interval under every member's trace."""
        if not self.tracer.enabled:
            return
        for r in batch:
            if r.trace is not None:
                r.trace.child(name, start_us, end_us, **tags)

    def _run_batch(self, batch):
        if self._faults is not None:
            self._faults.check("batcher.batch")  # ThreadDeath escapes
        batch = [r for r in batch if self._usable(r)]
        if not batch:
            return
        self._end_queue_wait(batch)
        t_launch0 = self.tracer.now_us() if self.tracer.enabled else 0.0
        try:
            n = len(batch)
            bucket = self._bucket(n)
            self.batch_sizes.append(n)
            stacked = []
            for i in range(len(batch[0].arrays)):
                arr = np.stack([r.arrays[i] for r in batch])
                if bucket > n:  # pad to the bucket to bound the shapes
                    pad = np.repeat(arr[:1], bucket - n, axis=0)
                    arr = np.concatenate([arr, pad], axis=0)
                stacked.append(arr)
            if self._faults is not None:
                self._faults.check("predictor.run")
            t_dec = self.tracer.now_us() if self.tracer.enabled else 0.0
            outs = self.predictor.run(stacked)
            self.breaker.record_success()
            self._span_each(batch, "decode_launch", t_launch0, t_dec,
                            batch_size=n, bucket=bucket)
            self._span_each(batch, "decode", t_dec, self.tracer.now_us(),
                            batch_size=n)
            for j, r in enumerate(batch):
                self._finish_req(r, [o[j] for o in outs])
        except Exception as e:
            self.breaker.record_failure()
            self.metrics.inc("batch_failures")
            self._span_each(batch, "decode", t_launch0, self.tracer.now_us(),
                            error=repr(e))
            for r in batch:
                self._fail_or_retry(r, e)

    # ------------------------------------------------------------- lifecycle
    def ready(self) -> bool:
        """Serving: not closed and the worker not dead for good."""
        return not self._stop.is_set() and not self._sup.dead()

    def pending(self) -> int:
        """Queued + in-flight work (the drain condition)."""
        return self._queue.qsize() + (1 if self._busy else 0)

    def drain(self):
        """Refuse new requests; queued / in-flight ones keep running."""
        self._draining.set()

    def close(self):
        self._stop.set()
        t = self._sup.thread
        if t is not None:
            t.join(timeout=10)      # a launch cannot be cut short
        while True:     # nobody hangs on a closed predictor
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            self._fail(r, ServiceUnavailable("predictor closed",
                                             retry_after=None))


class GenerateBatchingPredictor(BatchingPredictor):
    """Dynamic whole-batch generation over a SHARED paged KV pool (JAX
    ``serving.py:582-797``).

    A batcher thread collects up to ``max_batch_size`` requests within
    ``max_delay_ms`` (waking early once the batch fills) and serves them in
    one ``generate_paged`` call: the batch padded to the power of two at
    or above its size (at most ``max_batch_size``; a padding row writes
    only the pool's scratch page and its tokens are dropped), prompts
    right-padded to the power of two at or above the batch's longest (at
    most the model's ``max_position``), so batches of nearby sizes and
    lengths replay one captured program, each request reserving only
    ceil((len + max_new_tokens) / block_size) blocks of the pool. A request
    that cannot reserve RIGHT NOW is deferred to a later batch at most
    ``max_defers`` times, then shed with ServerBusy; the rest of its batch
    proceeds. Every reserved block is released whatever the batch did.

    When the pool's (layers, kv heads, head dim) do not match the model's,
    paged calls would write into the wrong shapes, so the predictor serves
    each request through dense ``generate()`` instead (``fallback_dense``;
    counted as ``dense_fallback_batches``), in the pool's dtype.

    ``device`` defaults to CUDA and raises on a machine without it unless
    the caller passes ``device="cpu"``; it must be the model's device, and
    the pool's. ``faults`` also checks ``predictor.generate`` before each
    launch and is handed to a pool built here.

    ``metrics.registry`` holds the predictor's series under the
    ``component`` label: the serving events, the pool's state, the
    launch-latency histogram and the generated-token counter."""

    _component = "generator"
    decode_kernel = "kernel"        # the step programs' attention route

    def __init__(self, model, max_batch_size=8, max_delay_ms=2.0,
                 max_new_tokens=32, kv_cache=None, block_size=32,
                 num_blocks=64, admission=None, max_retries=1, max_defers=8,
                 device="cuda", faults=None, breaker=None, max_restarts=5,
                 tracer=None, registry=None, component=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, predictor asked for "
                             f"{self.device}")
        spec = tuple(int(x) for x in model._decode_cache_spec())
        if kv_cache is None:
            kv_cache = PagedKVCache(*spec, block_size=block_size,
                                    num_blocks=num_blocks,
                                    device=self.device, faults=faults,
                                    tp_group=model._tp() or False)
        if kv_cache.device != self.device:
            raise ValueError(f"KV pool on {kv_cache.device}, predictor on "
                             f"{self.device}")
        self.fallback_dense = (kv_cache.num_layers, kv_cache.num_kv_heads,
                               kv_cache.head_dim) != spec
        self.model = model
        self._max_position = int(getattr(getattr(model, "config", None),
                                         "max_position", 1 << 62))
        self.kv_cache = kv_cache
        self.max_new_tokens = int(max_new_tokens)
        self.max_defers = int(max_defers)
        self._rid = itertools.count(1)      # atomic id draws
        super().__init__(predictor=None, max_batch_size=max_batch_size,
                         max_delay_ms=max_delay_ms, faults=faults,
                         admission=admission, breaker=breaker,
                         max_retries=max_retries, max_restarts=max_restarts,
                         tracer=tracer, registry=registry,
                         component=component)

    def _start_worker(self):
        """The pool and launch series bind before the batcher thread
        starts."""
        reg = self.metrics.registry
        self.kv_cache.bind_metrics(reg, pool=self._component)
        self._decode_hist = reg.histogram(
            "paddle_decode_launch_seconds",
            "Host wall of one decode launch (prefill + compiled scan "
            "dispatch) by path", labels=("component", "path"))
        self._tokens_total = reg.counter(
            "paddle_generated_tokens_total", "Tokens generated (batch * new)",
            labels=("component",))
        super()._start_worker()

    def _gen_timing(self, info):
        """The generation timing hook -> the registry's series."""
        self._decode_hist.labels(self._component, info["path"]).observe(
            info["launch_s"])
        self._tokens_total.labels(self._component).inc(
            info["batch"] * info["new_tokens"])

    # ---------------------------------------------------------------- client
    def infer(self, ids, timeout=None, deadline=None, trace_id=None):
        """One prompt (1-D int ids) in -> prompt + generated ids out."""
        return self._submit(self._make_request([np.asarray(ids)], timeout,
                                               deadline, trace_id))

    def _admission_check(self, arrays, req=None):
        need = self.kv_cache.blocks_for(len(arrays[0]) + self.max_new_tokens)
        self.admission.admit(self._queue.qsize(), cache=self.kv_cache,
                             blocks_needed=need)

    # ---------------------------------------------------------------- worker
    def _shed_or_defer(self, req, error):
        """Pool-full isolation: THIS request alone waits for blocks or
        sheds with ServerBusy."""
        if req.deadline is not None and req.deadline.expired():
            self._fail(req, DeadlineExceeded(
                "deadline expired waiting for KV blocks"))
        elif req.defers >= self.max_defers:
            self._fail(req, ServerBusy(
                f"KV pool exhausted after {req.defers} deferrals: {error}",
                retry_after=self.admission.retry_after))
        else:
            req.defers += 1
            self.metrics.inc("deferred")
            if req.trace is not None:
                req.trace.event("deferred", attempt=req.defers,
                                error=repr(error))
            self._enqueue(req)

    def _run_batch(self, batch):
        if self._faults is not None:
            self._faults.check("batcher.batch")  # ThreadDeath escapes
        batch = [r for r in batch if self._usable(r)]
        if not batch:
            return
        if self.fallback_dense:
            return self._run_dense(batch)
        self._end_queue_wait(batch)
        traced = self.tracer.enabled
        t_launch0 = self.tracer.now_us() if traced else 0.0
        cache = self.kv_cache
        admitted: list[tuple] = []
        try:
            for r in batch:
                plen = len(r.arrays[0])
                rid = ("req", next(self._rid))
                t_kv = self.tracer.now_us() if traced else 0.0
                try:
                    cache.reserve(rid, plen + self.max_new_tokens)
                except CacheOutOfBlocks as e:
                    if traced and r.trace is not None:
                        r.trace.child("kv_reserve", t_kv,
                                      self.tracer.now_us(), error=repr(e))
                    self._shed_or_defer(r, e)
                    continue
                if traced and r.trace is not None:
                    r.trace.child(
                        "kv_reserve", t_kv, self.tracer.now_us(),
                        blocks=cache.blocks_for(plen + self.max_new_tokens))
                admitted.append((rid, r))
            if not admitted:
                return
            n = len(admitted)
            self.batch_sizes.append(n)
            # the batch padded to a power-of-two size and the prompts
            # right-padded to a power-of-two width (masked by plens), so
            # that batches of nearby sizes and lengths replay one program.
            # A padding row has a 1-token prompt, no reservation, and a
            # table of the scratch page only: every row it writes lands
            # there, and its tokens are dropped.
            B = max(n, min(1 << (n - 1).bit_length(), self.max_batch_size))
            plens = np.ones(B, np.int64)
            plens[:n] = [len(r.arrays[0]) for _, r in admitted]
            P = int(plens.max())
            P = max(P, min(1 << (P - 1).bit_length(), self._max_position))
            prompts = np.zeros((B, P), np.int64)
            for i, (_, r) in enumerate(admitted):
                prompts[i, :plens[i]] = r.arrays[0]
            nb = cache.blocks_for(P + self.max_new_tokens)
            tbl = np.full((B, nb), cache.scratch_slot // cache.block_size,
                          np.int32)
            for i, (rid, _) in enumerate(admitted):
                tbl[i] = cache.block_table(rid, pad_to=nb)
            if self._faults is not None:
                self._faults.check("predictor.generate")
            dls = [r.deadline for _, r in admitted]
            batch_dl = (max(dls, key=lambda d: d.remaining())
                        if all(d is not None for d in dls) else None)
            t_dec = self.tracer.now_us() if traced else 0.0
            toks = self.model.generate_paged(
                prompts, plens, cache, tbl,
                max_new_tokens=self.max_new_tokens,
                decode_kernel=self.decode_kernel, deadline=batch_dl,
                timing_hook=self._gen_timing)
            self.breaker.record_success()
            adm = [r for _, r in admitted]
            self._span_each(adm, "decode_launch", t_launch0, t_dec,
                            batch_size=n)
            self._span_each(adm, "decode", t_dec, self.tracer.now_us(),
                            batch_size=n, path="paged",
                            kernel=self.decode_kernel)
            self.metrics.inc("generated_tokens", n * self.max_new_tokens)
            for i, (rid, r) in enumerate(admitted):
                cache.set_length(rid, int(plens[i]) + self.max_new_tokens)
                self._finish_req(r, np.concatenate(
                    [r.arrays[0], toks[i].astype(r.arrays[0].dtype)]))
        except Exception as e:      # this batch fails, not the loop
            self.breaker.record_failure()
            self.metrics.inc("batch_failures")
            self._span_each([r for _, r in admitted], "decode", t_launch0,
                            self.tracer.now_us(), error=repr(e))
            for _, r in admitted:
                self._fail_or_retry(r, e)
        finally:
            # all-paths release guard: no reserved block can leak
            for rid, _ in admitted:
                try:
                    cache.mark_done(rid)
                    cache.release(rid)
                except KeyError:    # already released
                    pass

    def _run_dense(self, batch):
        """Degradation for a pool that cannot serve this model: per-request
        dense ``generate()`` (correct, without shared memory)."""
        self.metrics.inc("dense_fallback_batches")
        self.batch_sizes.append(len(batch))
        self._end_queue_wait(batch)
        dtype = (None if self.kv_cache.dtype == torch.float32
                 else self.kv_cache.dtype)
        for r in batch:
            t_dec = self.tracer.now_us() if self.tracer.enabled else 0.0
            try:
                if self._faults is not None:
                    self._faults.check("predictor.generate")
                out = self.model.generate(
                    r.arrays[0][None], max_new_tokens=self.max_new_tokens,
                    dtype=dtype, decode_kernel=self.decode_kernel,
                    deadline=r.deadline, timing_hook=self._gen_timing)
                self.breaker.record_success()
                self.metrics.inc("generated_tokens", self.max_new_tokens)
                self._span_each([r], "decode", t_dec, self.tracer.now_us(),
                                path="dense_fallback")
                self._finish_req(r, out[0].cpu().numpy().astype(
                    r.arrays[0].dtype))
            except Exception as e:  # this request fails, not the loop
                self.breaker.record_failure()
                self.metrics.inc("batch_failures")
                self._span_each([r], "decode", t_dec, self.tracer.now_us(),
                                error=repr(e))
                self._fail_or_retry(r, e)


def _http_status(e):
    """Exception -> (HTTP status, load-shed?): 429/503 shed (Retry-After),
    504 a deadline, 503 a dry pool, 400 a malformed request, 500 the rest."""
    if isinstance(e, Rejected):
        return e.status, True
    if isinstance(e, TimeoutError):
        return 504, False
    if isinstance(e, CacheOutOfBlocks):
        return 503, True
    if isinstance(e, ValueError):
        return 400, False
    return 500, False


class InferenceServer:
    """HTTP npz endpoint over a generation predictor and, optionally, a
    batched ``predictor`` (JAX ``serving.py:799-1406``):

    * ``POST /generate``: npz {ids} -> npz {out0}; ``X-Timeout-Ms`` caps the
      wait; ``X-Temperature`` / ``X-Top-K`` / ``X-Spec`` (on|off) are the
      request's sampler knobs, ``X-Adapter`` routes through a registered
      LoRA adapter and ``X-Tenant`` bills a ``TenantLedger`` tenant: a
      malformed or empty value is a 400, and so is a header the generator
      cannot honour (``supports_*``); ``X-Stream: sse`` (or ``Accept:
      text/event-stream`` without ``X-Stream: off``) answers Server-Sent
      Events — ``tokens`` events as the scheduler flushes them, then
      ``done`` (or ``error`` with the status), each with the trace id;
    * ``POST /predict`` (with ``predictor=``): npz of inputs (x0, x1, ...)
      -> npz of outputs, through a ``BatchingPredictor`` (``max_batch_size``,
      ``max_delay_ms``);
    * ``GET /health``; ``GET /readyz``, 200 only while started, not
      draining and the workers ``ready()``;
    * ``GET /metrics``: the JSON counters (with the tracer, flight
      recorder and utilization blocks), or the Prometheus text of every
      registry with ``?format=prom`` or an Accept header naming text/plain
      or openmetrics;
    * ``GET /slo`` (the SLO monitor's burn rates and budgets),
      ``/debug/ticks?last=N`` (flight-recorder dumps) and ``/utilization``
      (the utilization ledgers): 404 when none is installed;
    * ``GET /debug/profile?ms=N``: a ``torch.profiler`` capture of N ms
      (1..``PROFILE_MS_CAP``) into ``profile_dir`` (a fresh temporary
      directory when unset), with a chrome trace joined to the tracer's
      spans; one at a time (409 while one runs), 400 on a malformed
      duration, 503 when the profiler fails.

    Overload answers 429 / 503 with ``Retry-After`` (the shed's computed
    hint, ``retry_after_header``), deadline expiry 504, a malformed request
    400; every response carries ``X-Trace-Id`` (the client's, or minted
    here).

    ``device`` defaults to CUDA and raises on a machine without it unless
    the caller passes ``device="cpu"``; it must be the generator's."""

    def __init__(self, generator=None, host="127.0.0.1", port=0,
                 default_timeout=30.0, device="cuda", *, predictor=None,
                 max_batch_size=8, max_delay_ms=2.0, profile_dir=None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        dev = resolve_device(device)
        if generator is not None and generator.device != dev:
            raise ValueError(f"generator on {generator.device}, server asked "
                             f"for {dev}")
        self.device = dev
        self.generator = generator
        self.batcher = (None if predictor is None else
                        BatchingPredictor(predictor, max_batch_size,
                                          max_delay_ms))
        self.default_timeout = float(default_timeout)
        self.profile_dir = profile_dir
        self._profile_lock = threading.Lock()
        self._profile_seq = itertools.count(1)
        self._ready = threading.Event()
        self._draining = threading.Event()
        self.registry = MetricsRegistry()
        self.registry.gauge(
            "paddle_server_draining",
            "1 while draining (readyz answers 503)").set_function(
                lambda: 1 if self._draining.is_set() else 0)
        self._http_responses = self.registry.counter(
            "paddle_http_responses_total", "HTTP responses by path and status",
            labels=("path", "status"))
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _trace_id(self):
                tid = getattr(self, "_tid", None)
                if tid is None:
                    tid = self.headers.get("X-Trace-Id") or new_trace_id()
                    self._tid = tid
                return tid

            def _metric_path(self):
                p = self.path.split("?", 1)[0]
                return p if p in ("/health", "/readyz", "/metrics",
                                  "/predict", "/generate", "/slo",
                                  "/debug/ticks", "/utilization",
                                  "/debug/profile") else "other"

            def _count(self, status):
                # counted before any byte is written: a client that saw the
                # response never scrapes a page that has not counted it
                outer._http_responses.labels(self._metric_path(),
                                             str(status)).inc()

            def _reply(self, status, body, headers=()):
                self._count(status)
                self.send_response(status)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("X-Trace-Id", self._trace_id())
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj):
                self._reply(200, json.dumps(obj).encode(),
                            [("Content-Type", "application/json")])

            def _fail_http(self, e):
                """Every load-shed status carries Retry-After: the shed's
                computed hint (a tenant bucket's time to refill), or the
                1 s floor."""
                status, shed = _http_status(e)
                hint = e.retry_after if isinstance(e, Rejected) else None
                self._reply(status, repr(e).encode(),
                            [("Retry-After", retry_after_header(hint))]
                            if shed else [])

            def _timeout(self):
                ms = self.headers.get("X-Timeout-Ms")
                if ms is None:
                    return outer.default_timeout
                try:
                    return min(outer.default_timeout, float(ms) / 1000.0)
                except ValueError:
                    return outer.default_timeout

            def _named_header(self, name, gate, knob):
                """X-Adapter / X-Tenant: a stripped non-empty name, and a
                generator that routes it; else ValueError (400). An
                unknown name is a 400 from the scheduler's own check."""
                v = self.headers.get(name)
                if v is None:
                    return None
                v = v.strip()
                if not v:
                    raise ValueError(f"malformed {name} (empty name)")
                if not getattr(outer.generator, gate, False):
                    raise ValueError(
                        f"{name} needs the continuous scheduler with {knob}; "
                        "this server's generator cannot route it")
                return v

            def _sampler_knobs(self):
                """X-Temperature / X-Top-K / X-Spec / X-Adapter / X-Tenant
                -> infer() kwargs; a malformed value raises ValueError
                (400), as does a header the generator cannot honour."""
                kw = {}
                t = self.headers.get("X-Temperature")
                if t is not None:
                    try:
                        tv = float(t)
                    except ValueError:
                        raise ValueError(
                            f"malformed X-Temperature {t!r}") from None
                    if not math.isfinite(tv) or tv < 0:
                        raise ValueError(
                            f"X-Temperature out of range: {t!r} "
                            "(need a finite value >= 0)")
                    kw["temperature"] = tv
                k = self.headers.get("X-Top-K")
                if k is not None:
                    try:
                        kv = int(k)
                    except ValueError:
                        raise ValueError(
                            f"malformed X-Top-K {k!r}") from None
                    if kv < 0:
                        raise ValueError(
                            f"X-Top-K out of range: {k!r} (need >= 0)")
                    kw["top_k"] = kv
                sp = self.headers.get("X-Spec")
                if sp is not None:
                    sv = sp.strip().lower()
                    if sv not in ("on", "off"):
                        raise ValueError(
                            f"malformed X-Spec {sp!r} (on|off)")
                    kw["spec"] = sv == "on"
                if kw and not getattr(outer.generator,
                                      "supports_sampler_knobs", False):
                    raise ValueError(
                        "per-request sampler headers need the continuous "
                        "scheduler (ContinuousGenerateBatchingPredictor); "
                        "this server's generator batches whole requests "
                        "with a fixed sampler config")
                a = self._named_header("X-Adapter", "supports_adapters",
                                       "an AdapterRegistry (adapters= knob)")
                if a is not None:
                    kw["adapter"] = a
                tn = self._named_header("X-Tenant", "supports_tenants",
                                        "a TenantLedger (qos= knob)")
                if tn is not None:
                    kw["tenant"] = tn
                return kw

            def _wants_stream(self):
                """SSE opt-in: ``X-Stream: sse``, or Accept:
                text/event-stream with no X-Stream; a malformed X-Stream is
                a 400."""
                xs = self.headers.get("X-Stream")
                if xs is not None:
                    sv = xs.strip().lower()
                    if sv not in ("sse", "off"):
                        raise ValueError(
                            f"malformed X-Stream {xs!r} (sse|off)")
                    return sv == "sse"
                return "text/event-stream" in (
                    self.headers.get("Accept") or "")

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/health":
                    self._reply(200, b"ok")
                elif path == "/readyz":
                    workers_ready = all(
                        w.ready() for w in (outer.batcher, outer.generator)
                        if w is not None)
                    if (outer._ready.is_set() and not outer._draining.is_set()
                            and workers_ready):
                        self._reply(200, b"ready")
                    else:
                        body = (b"draining" if outer._draining.is_set()
                                else b"not ready" if outer._ready.is_set()
                                else b"not started")
                        self._reply(503, body, [("Retry-After", "1")])
                elif path == "/metrics":
                    self._do_metrics(query)
                elif path == "/slo":
                    mon = outer._find_slo()
                    if mon is None:
                        self._reply(404, b"no SLO policy installed")
                    else:
                        self._json(mon.snapshot())
                elif path == "/debug/ticks":
                    last = None
                    if "last=" in query:
                        try:
                            last = int(query.split("last=", 1)[1]
                                       .split("&", 1)[0])
                        except ValueError:
                            self._reply(400, b"malformed last= (need int)")
                            return
                    dumps = outer._find_flight_dumps(last)
                    if not dumps:
                        self._reply(404, b"no flight recorder installed")
                    else:
                        self._json(dumps)
                elif path == "/utilization":
                    snaps = outer._find_utilization()
                    if not snaps:
                        self._reply(404, b"no utilization ledger installed")
                    else:
                        self._json(snaps)
                elif path == "/debug/profile":
                    self._do_profile(query)
                else:
                    self._reply(404, b"")

            def _do_metrics(self, query):
                accept = self.headers.get("Accept", "")
                if ("format=prom" in query or "text/plain" in accept
                        or "openmetrics" in accept):
                    try:
                        body = outer.render_prometheus().encode()
                    except ValueError as e:   # conflicting registries
                        self._fail_http(e)
                        return
                    self._reply(200, body, [
                        ("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")])
                    return
                snap = {"draining": outer._draining.is_set()}
                gen = outer.generator
                if outer.batcher is not None:
                    snap["batcher"] = outer.batcher.metrics.snapshot()
                if gen is not None:
                    snap["generator"] = gen.metrics.snapshot()
                    if hasattr(gen, "replica_states"):
                        snap["replicas"] = gen.replica_states()
                tracers = {}
                for wname, w in (("batcher", outer.batcher),
                                 ("generator", gen)):
                    t = getattr(w, "tracer", None)
                    if t is not None:
                        tracers[wname] = {"dropped": t.dropped,
                                          "recorded_spans": len(t.spans())}
                if tracers:
                    snap["tracer"] = tracers
                fl = getattr(gen, "flight", None)
                if fl is not None:
                    snap["flight_recorder"] = {"occupancy": fl.occupancy,
                                               "capacity": fl.capacity,
                                               "dropped": fl.dropped}
                util = getattr(gen, "util", None)
                if util is not None:
                    snap["utilization"] = util.metrics_block()
                self._json(snap)

            def _do_profile(self, query):
                ms = None
                for part in query.split("&"):
                    if part.startswith("ms="):
                        try:
                            ms = int(part[3:])
                        except ValueError:
                            self._reply(400, b"malformed ms= (need int)")
                            return
                if ms is None:
                    self._reply(400, b"missing ms= duration")
                    return
                if ms <= 0 or ms > PROFILE_MS_CAP:
                    self._reply(
                        400,
                        f"ms= out of range: {ms} (need 1..{PROFILE_MS_CAP})"
                        .encode())
                    return
                if not outer._profile_lock.acquire(blocking=False):
                    self._reply(409, b"profile capture already in flight",
                                [("Retry-After", "1")])
                    return
                try:
                    out = outer._capture_profile(ms)
                except Exception as e:
                    self._reply(503, repr(e).encode(),
                                [("Retry-After", "1")])
                    return
                finally:
                    outer._profile_lock.release()
                self._json(out)

            def _generate_sse(self, ids):
                """Server-Sent Events for /generate: admission errors raise
                before any byte is written (so 429/503/400 stay HTTP
                statuses); after the headers a failure travels as an
                ``error`` event with its status. Close-delimited: no
                Content-Length, ``done`` or ``error`` ends the stream."""
                gen = outer.generator
                if not getattr(gen, "supports_streaming", False):
                    raise ValueError(
                        "streaming needs the continuous scheduler "
                        "(ContinuousGenerateBatchingPredictor); this "
                        "server's generator buffers whole responses")
                it = gen.infer_stream(ids, timeout=self._timeout(),
                                      trace_id=self._trace_id(),
                                      **self._sampler_knobs())
                tid = self._trace_id()
                self._count(200)
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("X-Trace-Id", tid)
                self.end_headers()

                def emit(event, payload):
                    payload["trace_id"] = tid
                    self.wfile.write(
                        (f"id: {tid}\nevent: {event}\n"
                         f"data: {json.dumps(payload)}\n\n").encode())
                    self.wfile.flush()

                sent = 0
                try:
                    for chunk in it:
                        toks = [int(t) for t in
                                np.asarray(chunk).reshape(-1)]
                        sent += len(toks)
                        emit("tokens", {"tokens": toks})
                    emit("done", {"generated": sent,
                                  "prompt_len": int(len(ids))})
                except Exception as e:
                    try:
                        emit("error", {"status": _http_status(e)[0],
                                       "error": repr(e)})
                    except OSError:     # the client went away mid-stream
                        pass
                finally:
                    # a broken pipe cancels the sequence now, not at GC
                    it.close()

            def do_POST(self):
                if outer._draining.is_set():
                    self._reply(503, b"draining", [("Retry-After", "1")])
                    return
                if self.path == "/generate" and outer.generator is not None:
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        data = np.load(io.BytesIO(self.rfile.read(n)))
                        ids = data[data.files[0]]
                        if self._wants_stream():
                            self._generate_sse(ids)
                            return
                        out = outer.generator.infer(
                            ids, timeout=self._timeout(),
                            trace_id=self._trace_id(),
                            **self._sampler_knobs())
                        buf = io.BytesIO()
                        np.savez(buf, out0=out)
                        self._reply(200, buf.getvalue(),
                                    [("Content-Type", "application/npz")])
                    except Exception as e:      # every failure answers HTTP
                        self._fail_http(e)
                    return
                if self.path != "/predict" or outer.batcher is None:
                    self._reply(404, b"")
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    data = np.load(io.BytesIO(self.rfile.read(n)))

                    def _num_key(k):
                        digits = "".join(c for c in k if c.isdigit())
                        return (int(digits) if digits else 0, k)

                    arrays = [data[k] for k in sorted(data.files,
                                                      key=_num_key)]
                    outs = outer.batcher.infer(*arrays,
                                               timeout=self._timeout(),
                                               trace_id=self._trace_id())
                    buf = io.BytesIO()
                    np.savez(buf, **{f"out{i}": o
                                     for i, o in enumerate(outs)})
                    self._reply(200, buf.getvalue(),
                                [("Content-Type", "application/npz")])
                except Exception as e:
                    self._fail_http(e)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="inference-server")

    # --------------------------------------------------------- debug views
    def _replica_predictors(self):
        gen = self.generator
        if gen is not None and hasattr(gen, "_snapshot"):
            return [(rep.name, rep.predictor) for rep in gen._snapshot()]
        return []

    def _find_slo(self):
        """The generator's SLOMonitor (a fleet's replicas usually share
        one; the first found wins)."""
        mon = getattr(self.generator, "slo", None)
        for _, pred in self._replica_predictors():
            if mon is not None:
                break
            mon = getattr(pred, "slo", None)
        return mon

    def _find_flight_dumps(self, last):
        """Flight-recorder dumps keyed by recorder name: one for a
        scheduler, one per replica for a fleet."""
        fl = getattr(self.generator, "flight", None)
        if fl is not None:
            return {fl.name: fl.dump(last=last)}
        dumps = {}
        for _, pred in self._replica_predictors():
            f = getattr(pred, "flight", None)
            if f is not None:
                dumps[f.name] = f.dump(last=last)
        return dumps

    def _find_utilization(self):
        """Utilization snapshots keyed by component (or replica name)."""
        u = getattr(self.generator, "util", None)
        if u is not None:
            name = getattr(self.generator, "_component", "generator")
            return {name: u.snapshot()}
        snaps = {}
        for name, pred in self._replica_predictors():
            u = getattr(pred, "util", None)
            if u is not None:
                snaps[name] = u.snapshot()
        return snaps

    def _capture_profile(self, ms):
        """One ``torch.profiler`` capture of ``ms`` milliseconds (run under
        ``_profile_lock``): host activity, and the card's kernels on CUDA,
        into a fresh numbered directory under ``profile_dir``; the raw
        chrome trace and one joined with the tracer's spans
        (``export_joined_chrome``, one ``perf_counter`` timebase)."""
        from torch.profiler import ProfilerActivity, profile

        from ..observability.trace import export_joined_chrome

        base = self.profile_dir
        if base is None:
            base = self.profile_dir = tempfile.mkdtemp(
                prefix="paddle_profile_")
        run_dir = os.path.join(base, f"capture_{next(self._profile_seq):04d}")
        os.makedirs(run_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            time.sleep(ms / 1000.0)
        raw = os.path.join(run_dir, "trace.json")
        prof.export_chrome_trace(raw)
        joined = None
        tracer = next((t for t in (getattr(w, "tracer", None) for w in
                                   (self.generator, self.batcher))
                       if t is not None), None)
        if tracer is not None:
            joined = os.path.join(run_dir, "joined_host_trace.json")
            try:
                export_joined_chrome(joined, tracer=tracer, profiler=prof)
            except Exception:
                joined = None   # the raw trace still stands on its own
        return {"ms": int(ms), "trace_dir": run_dir, "trace": raw,
                "joined_chrome": joined,
                "events": len(prof.events())}

    def render_prometheus(self) -> str:
        """One Prometheus text exposition over the server's, the
        batcher's and the generator's registries."""
        regs = [self.registry]
        for w in (self.batcher, self.generator):
            if w is not None:
                regs.append(w.metrics.registry)
        return render_prometheus(*regs)

    def start(self):
        self._thread.start()
        self._ready.set()
        return self

    def stop(self, drain_timeout=5.0):
        """Graceful drain: /readyz turns 503, new POSTs are refused, queued
        and in-flight requests finish (up to drain_timeout), then the HTTP
        loop and the workers stop."""
        self._draining.set()
        self._ready.clear()
        workers = [w for w in (self.batcher, self.generator)
                   if w is not None]
        for w in workers:
            w.drain()
        deadline = time.monotonic() + float(drain_timeout)
        while (time.monotonic() < deadline
               and any(w.pending() for w in workers)):
            time.sleep(0.01)
        if self._thread.is_alive():
            self._httpd.shutdown()
        self._httpd.server_close()
        for w in workers:
            w.close()
        if self._thread.is_alive():
            self._thread.join(timeout=2)


# ---------------------------------------------------------------------------
# Replica fleet: data-parallel serving over N continuous schedulers
# ---------------------------------------------------------------------------
class _Replica:
    """One fleet member: a continuous scheduler and its routing state
    ("ready" | "draining" | "dead", the fleet's view)."""

    __slots__ = ("name", "predictor", "state")

    def __init__(self, name, predictor):
        self.name = name
        self.predictor = predictor
        self.state = "ready"


# ------------------------------------------ replicas led by other processes
# name -> the continuous scheduler this process leads, for the fleet's
# router to reach through ``distributed.rpc``; answers of submitted
# requests by ticket; the replicas closed by the router
_LED: dict = {}
_ANSWERS: dict = {}
_CLOSED: dict = {}
_ANSWERS_LOCK = threading.Lock()
_ERRORS = {"ServiceUnavailable": ServiceUnavailable,
           "ServerBusy": ServerBusy, "DeadlineExceeded": DeadlineExceeded,
           "ValueError": ValueError}


def _portable_error(e):
    """An exception as (kind, message, retry_after, permanent): the
    serving errors rebuilt on the router with their fields."""
    return (type(e).__name__, str(e), getattr(e, "retry_after", None),
            getattr(e, "permanent", False))


def _rebuilt_error(kind, msg, retry_after, permanent):
    cls = _ERRORS.get(kind, RuntimeError)
    if cls is ServiceUnavailable:
        return cls(msg, retry_after=retry_after, permanent=permanent)
    if cls is ServerBusy:
        return cls(msg, retry_after=retry_after)
    return cls(msg if cls is not RuntimeError else f"{kind}: {msg}")


def _replica_op(name, op, args, kwargs):
    """Run on the process that leads replica ``name`` (through rpc). A
    replica its router closed reads as dead, and closes again as a
    no-op."""
    pred = _LED.get(name)
    if pred is None:
        if op == "close":
            return None
        if op == "state":
            return {"pending": 0, "ready": False, "breaker": "closed",
                    "dead": True}
        raise ServiceUnavailable(f"replica {name} is closed",
                                 retry_after=None, permanent=True)
    if op == "state":
        return {"pending": pred.pending(), "ready": pred.ready(),
                "breaker": pred.breaker.state, "dead": pred._sup.dead()}
    if op == "pool":
        kv = pred.kv_cache
        return {"per_rank": kv.per_chip_pool_bytes(),
                "logical": kv.pool_bytes(), "tp_sharded": kv.tp_sharded}
    if op == "submit":
        ticket = new_trace_id()
        done = threading.Event()
        with _ANSWERS_LOCK:
            _ANSWERS[ticket] = [done, None]

        def run():
            try:
                box = ("ok", np.asarray(pred.infer(*args, **kwargs)))
            except Exception as e:      # answered on the router
                box = ("err", _portable_error(e))
            _ANSWERS[ticket][1] = box
            done.set()

        threading.Thread(target=run, name=f"fleet-{name}-{ticket[:8]}",
                         daemon=True).start()
        return ticket
    if op == "take":
        done, _ = _ANSWERS[args[0]]
        if not done.wait(0.05):
            return ("pending",)
        with _ANSWERS_LOCK:
            return _ANSWERS.pop(args[0])[1]
    if op == "close":
        pred.close()
        _CLOSED[name].set()
        return None
    return getattr(pred, op)(*args, **kwargs)


class _RemoteState:
    """The routing reads of a remote replica (``breaker.state``,
    ``_sup.dead()``), each one rpc round trip."""

    def __init__(self, proxy):
        self._proxy = proxy

    @property
    def state(self):
        return self._proxy._call("state")["breaker"]

    def dead(self):
        return self._proxy._call("state")["dead"]


class _RemotePool:
    def __init__(self, proxy):
        self._proxy = proxy

    def per_chip_pool_bytes(self):
        return self._proxy._call("pool")["per_rank"]

    def pool_bytes(self):
        return self._proxy._call("pool")["logical"]

    @property
    def tp_sharded(self):
        return self._proxy._call("pool")["tp_sharded"]


class _RemoteReplica:
    """Stands for a replica whose tensor-parallel group another process
    leads: the scheduler calls the router makes (``infer``, ``pending``,
    ``ready``, the breaker and supervisor reads, ``drain``, ``close``)
    over ``distributed.rpc`` to that leader. A request is submitted, then
    its answer polled, so the leader's rpc agent stays free for the
    router's other reads while the request runs there."""

    POLL_S = 0.005
    # seconds an rpc to the leader may take
    RPC_TIMEOUT_S = 300.0

    def __init__(self, name, leader_rank):
        self.name = name
        self.leader_rank = int(leader_rank)
        self.breaker = _RemoteState(self)
        self._sup = self.breaker
        self.kv_cache = _RemotePool(self)

    def _call(self, op, *args, **kwargs):
        from ..distributed import rpc

        return rpc.rpc_sync(self.leader_rank, _replica_op,
                            args=(self.name, op, args, kwargs),
                            timeout=self.RPC_TIMEOUT_S)

    def pending(self):
        return self._call("state")["pending"]

    def ready(self):
        return self._call("state")["ready"]

    def infer(self, ids, timeout=None, deadline=None, trace_id=None, **kw):
        if deadline is not None:
            timeout = max(deadline.remaining(), 0.0)
        ticket = self._call("submit", np.asarray(ids), timeout=timeout,
                            trace_id=trace_id, **kw)
        while True:
            got = self._call("take", ticket)
            if got[0] == "ok":
                return got[1]
            if got[0] == "err":
                raise _rebuilt_error(*got[1])
            time.sleep(self.POLL_S)

    def infer_stream(self, ids, **kw):
        raise NotImplementedError(
            "streaming from a replica led by another process: the router "
            "relays whole answers (infer)")

    def drain(self):
        return self._call("drain")

    def close(self):
        return self._call("close")


def _ensure_rpc():
    """Start this process's rpc agent over the launcher's store, or over a
    store rank 0 hosts (its port broadcast over the world) outside a
    launched job. Returns whether it was started here."""
    from ..distributed import env, rpc
    from ..distributed.collective import broadcast_object_list
    from ..distributed.store import TCPStore

    if rpc._agent is not None:
        return False
    rank, world = env.get_rank(), env.get_world_size()
    store = env.store()
    if store is None:
        master = (TCPStore(is_master=True, world_size=world) if rank == 0
                  else None)
        box = [master.port if master is not None else None]
        broadcast_object_list(box, src=0)
        store = master or TCPStore(port=int(box[0]), world_size=world)
    rpc.init_rpc(f"worker{rank}", rank=rank, world_size=world, store=store)
    return True


class ReplicaFleet:
    """Least-loaded router over N data-parallel scheduler replicas (JAX
    ``serving.py:1439-1836``).

    ``build`` makes N ``ContinuousGenerateBatchingPredictor`` replicas over
    one model, one metrics registry and one tracer, each with its own KV
    pool and slot state, labelled ``r0``, ``r1``, ... In the JAX package
    the replicas share the model's compiled programs; here a captured step
    program holds its pool's addresses (its key names the pool), so each
    replica captures its own set, once, over its own pool.

    Routing contract:

    * Admission happens once at the fleet door (aggregate pending depth);
      per-replica admission still applies at dispatch, and a busy replica
      fails over to the next-least-loaded sibling.
    * A replica whose circuit breaker is open is skipped by reading
      ``breaker.state`` — never ``allow()``, which would consume the
      half-open probe the replica's own admission needs.
    * A ``ServiceUnavailable(permanent=True)`` (a supervisor out of
      restarts) marks the replica dead and re-dispatches to a sibling.
    * ``drain_replica`` stops new dispatches (queued work finishes),
      ``undrain_replica`` reverses it, ``retire_replica`` drains, waits and
      closes.

    Over tensor-parallel groups (``build`` of a model whose ``tp_group``
    spans fewer ranks than the world, as under ``serving_mesh(dp, tp)``):
    every rank calls ``build``; replica r is the lockstep group of ranks
    ``[r tp, (r + 1) tp)``, each rank building its scheduler over its
    shards. The router lives on global rank 0: replica 0 is its own
    scheduler, and a replica whose leader is another process is reached
    through a proxy over ``distributed.rpc`` (``_RemoteReplica``: infer,
    load and breaker reads, drain / retire and close), with the routing
    contract unchanged. On the other ranks the fleet only keeps its
    scheduler serving: ``infer`` raises there, and ``close`` returns once
    the router has closed the fleet.

    Series: ``paddle_fleet_replicas{state}``,
    ``paddle_fleet_dispatch_total{replica,outcome}``, a ``fleet_dispatch``
    span per attempt, and fleet-level ``ServingMetrics`` (component
    "fleet") with the conservation contract accepted == completed +
    failed + timeouts."""

    supports_sampler_knobs = True   # replicas are continuous schedulers
    supports_streaming = True

    @property
    def supports_adapters(self):
        """X-Adapter routing works iff the replicas carry a registry
        (``build`` passes one shared ``adapters=`` to all)."""
        return any(getattr(rep.predictor, "supports_adapters", False)
                   for rep in self._snapshot())

    @property
    def supports_tenants(self):
        """X-Tenant twin of supports_adapters (one shared ledger)."""
        return any(getattr(rep.predictor, "supports_tenants", False)
                   for rep in self._snapshot())

    def __init__(self, replicas, *, admission=None, registry=None,
                 tracer=None, clock=time.monotonic):
        self._lock = threading.Lock()
        self._replicas = list(replicas)
        self._next_id = len(self._replicas)
        self._clock = clock
        self.device = (self._replicas[0].predictor.device
                       if self._replicas else None)
        self.tracer = tracer if tracer is not None else Tracer()
        self.registry = registry if registry is not None else MetricsRegistry()
        self.metrics = ServingMetrics(registry=self.registry,
                                      component="fleet")
        self.admission = admission if admission is not None \
            else AdmissionController()
        self._draining = threading.Event()
        self._model = None          # build()-made fleets can add replicas
        self._replica_kwargs = {}
        g = self.registry.gauge(
            "paddle_fleet_replicas",
            "Replica-fleet membership by routing state",
            labels=("state",))
        for st in ("ready", "draining", "dead"):
            g.labels(st).set_function(
                lambda s=st: float(self._count_state(s)))
        self._dispatch_total = self.registry.counter(
            "paddle_fleet_dispatch_total",
            "Fleet dispatch attempts by replica and outcome",
            labels=("replica", "outcome"))

    @classmethod
    def build(cls, model, n_replicas=2, *, registry=None, tracer=None,
              admission=None, replica_kwargs=None, **kwargs):
        """A fleet of ``n_replicas`` continuous schedulers over ONE model,
        one registry and one tracer; ``replica_kwargs`` (a list of dicts)
        overlays per-replica settings on the common ``**kwargs``."""
        from .scheduler import ContinuousGenerateBatchingPredictor

        registry = registry if registry is not None else MetricsRegistry()
        tracer = tracer if tracer is not None else Tracer()
        tp = model._tp() if hasattr(model, "_tp") else None
        if tp is not None:
            from ..distributed import env

            if env.get_world_size() > tp.nranks:
                return cls._build_tp(model, int(n_replicas), tp, registry,
                                     tracer, admission, replica_kwargs,
                                     kwargs)
        per = list(replica_kwargs) if replica_kwargs else []
        replicas = []
        for i in range(int(n_replicas)):
            kw = dict(kwargs)
            if i < len(per) and per[i]:
                kw.update(per[i])
            name = f"r{i}"
            replicas.append(_Replica(name, ContinuousGenerateBatchingPredictor(
                model, registry=registry, tracer=tracer, component=name,
                **kw)))
        fleet = cls(replicas, admission=admission, registry=registry,
                    tracer=tracer)
        fleet.device = model.device
        fleet._model = model
        fleet._replica_kwargs = dict(kwargs)
        return fleet

    @classmethod
    def _build_tp(cls, model, n_replicas, tp, registry, tracer, admission,
                  replica_kwargs, kwargs):
        """``build`` over tensor-parallel groups (see the class)."""
        from ..distributed import env
        from ..distributed.collective import barrier
        from .scheduler import ContinuousGenerateBatchingPredictor

        n, world, rank = tp.nranks, env.get_world_size(), env.get_rank()
        if n_replicas * n != world or tp.ranks != list(
                range(tp.ranks[0], tp.ranks[0] + n)) or tp.ranks[0] % n:
            raise ValueError(
                f"{n_replicas} replicas of tensor-parallel groups of {n} "
                f"ranks must tile the world of {world} in consecutive "
                f"blocks (this rank's group: {tp.ranks})")
        started = _ensure_rpc()
        me = rank // n
        name = f"r{me}"
        kw = dict(kwargs)
        per = list(replica_kwargs) if replica_kwargs else []
        if me < len(per) and per[me]:
            kw.update(per[me])
        pred = ContinuousGenerateBatchingPredictor(
            model, registry=registry, tracer=tracer, component=name, **kw)
        leads = rank == tp.ranks[0]
        if leads:
            _LED[name] = pred
            _CLOSED[name] = threading.Event()
        barrier()                   # every leader reachable
        if rank == 0:
            replicas = [_Replica(name, pred)] + [
                _Replica(f"r{j}", _RemoteReplica(f"r{j}", j * n))
                for j in range(1, n_replicas)]
        else:
            replicas = []
        fleet = cls(replicas, admission=admission, registry=registry,
                    tracer=tracer)
        fleet.device = model.device
        fleet._member = (name, pred, leads, started)
        return fleet

    # ------------------------------------------------------------ membership
    def _snapshot(self):
        with self._lock:
            return list(self._replicas)

    def _by_name(self, name) -> _Replica:
        for rep in self._snapshot():
            if rep.name == name:
                return rep
        raise KeyError(f"no replica named {name!r}")

    def _refresh(self, rep) -> str:
        """Routing state with supervisor death folded in (non-healing)."""
        if rep.state != "dead" and rep.predictor._sup.dead():
            rep.state = "dead"
        return rep.state

    def _count_state(self, state) -> int:
        return sum(1 for rep in self._snapshot()
                   if self._refresh(rep) == state)

    def replica_states(self) -> dict:
        """{name: "ready" | "draining" | "dead"}."""
        return {rep.name: self._refresh(rep) for rep in self._snapshot()}

    def add_replica(self, name=None, **overrides):
        """Admit a new replica (``build`` fleets only) over the shared
        model, registry and tracer, with a pool of its own."""
        from .scheduler import ContinuousGenerateBatchingPredictor

        if self._model is None:
            raise RuntimeError("add_replica needs a ReplicaFleet.build() "
                               "fleet (it owns the shared model handle)")
        with self._lock:
            name = name if name is not None else f"r{self._next_id}"
            self._next_id += 1
        kw = dict(self._replica_kwargs)
        kw.update(overrides)
        pred = ContinuousGenerateBatchingPredictor(
            self._model, registry=self.registry, tracer=self.tracer,
            component=name, **kw)
        with self._lock:
            self._replicas.append(_Replica(name, pred))
        return name

    def drain_replica(self, name):
        """Stop routing NEW requests to ``name``; its queued work
        finishes."""
        rep = self._by_name(name)
        if rep.state == "ready":
            rep.state = "draining"

    def undrain_replica(self, name):
        rep = self._by_name(name)
        if rep.state == "draining":
            rep.state = "ready"

    def retire_replica(self, name, drain_timeout=5.0):
        """Drain, then close: routing stops at once, queued and in-flight
        requests get up to ``drain_timeout``, then the replica's threads
        stop and it reads as dead."""
        rep = self._by_name(name)
        rep.state = "draining"
        rep.predictor.drain()
        deadline = time.monotonic() + float(drain_timeout)
        while time.monotonic() < deadline and rep.predictor.pending():
            time.sleep(0.01)
        rep.predictor.close()
        rep.state = "dead"

    # --------------------------------------------------------------- routing
    def _pick(self, exclude=()):
        """Least-loaded ready replica, skipping draining / dead members,
        open breakers (state read only), replicas still warming up and
        already-tried names."""
        best, best_load = None, None
        for rep in self._snapshot():
            if rep.name in exclude or self._refresh(rep) != "ready":
                continue
            if rep.predictor.breaker.state == "open":
                continue
            if not rep.predictor.ready():
                continue
            load = rep.predictor.pending()
            if best is None or load < best_load:
                best, best_load = rep, load
        return best

    def _dispatched(self, rep, outcome, tr, t_start):
        self._dispatch_total.labels(rep.name, outcome).inc()
        tr.child("fleet_dispatch", t_start, tr.now_us(),
                 replica=rep.name, outcome=outcome)

    def _admit(self, tr, tenant=None):
        t_adm = tr.now_us()
        try:
            if self._draining.is_set():
                raise ServiceUnavailable("fleet is shutting down",
                                         retry_after=None)
            self.admission.admit(self.pending())
            if self._pick() is None:
                raise ServiceUnavailable("no ready replicas",
                                         retry_after=0.5)
        except Rejected as e:
            self.metrics.inc("rejected_busy" if isinstance(e, ServerBusy)
                             else "rejected_unavailable")
            slo = getattr(self, "slo", None)
            if slo is not None:
                slo.observe_terminal(e.status < 500, tenant=tenant)
            tr.child("admission", t_adm, tr.now_us(), error=repr(e))
            tr.finish("rejected", status=e.status, error=repr(e),
                      queue_share=1.0, prefill_share=0.0,
                      paused_share=0.0, decode_share=0.0)
            raise
        tr.child("admission", t_adm, tr.now_us())
        self.metrics.inc("accepted")

    def _terminal(self, outcome, t0, tr, **tags):
        self.metrics.inc(outcome)
        if outcome in ("completed", "timeouts"):
            self.metrics.observe_latency(self._clock() - t0)
        tr.finish({"completed": "result", "timeouts": "timeout",
                   "failed": "error"}[outcome], **tags)

    def _dispatch(self, call, deadline, tr, t0):
        """Failover loop: try least-loaded replicas until one accepts.
        Busy / unavailable fail over, a permanent 503 marks the replica
        dead and fails over, a timeout or malformed request is the
        request's own terminal."""
        tried = set()
        last_busy = None
        while True:
            if deadline is not None and deadline.expired():
                self._terminal("timeouts", t0, tr, where="fleet_dispatch")
                raise DeadlineExceeded("request timed out during fleet "
                                       "dispatch")
            rep = self._pick(exclude=tried)
            if rep is None:
                err = last_busy if last_busy is not None else \
                    ServiceUnavailable("no ready replicas", retry_after=0.5)
                self._terminal("failed", t0, tr, error=repr(err))
                raise err
            t_d = tr.now_us()
            try:
                out = call(rep)
            except DeadlineExceeded:
                self._dispatched(rep, "timeout", tr, t_d)
                self._terminal("timeouts", t0, tr, replica=rep.name)
                raise
            except ServiceUnavailable as e:
                if e.permanent or rep.predictor._sup.dead():
                    rep.state = "dead"
                    self._dispatched(rep, "dead", tr, t_d)
                    continue
                self._dispatched(rep, "unavailable", tr, t_d)
                tried.add(rep.name)
                last_busy = e
            except ServerBusy as e:
                self._dispatched(rep, "busy", tr, t_d)
                tried.add(rep.name)
                last_busy = e
            except ValueError as e:
                self._dispatched(rep, "invalid", tr, t_d)
                self._terminal("failed", t0, tr, error=repr(e))
                raise
            except Exception as e:
                self._dispatched(rep, "error", tr, t_d)
                self._terminal("failed", t0, tr, error=repr(e))
                raise
            else:
                self._dispatched(rep, "ok", tr, t_d)
                return rep, out

    # ---------------------------------------------------------------- client
    def infer(self, ids, timeout=None, deadline=None, trace_id=None, **kw):
        """The continuous scheduler's infer() through the router: ONE
        deadline rides every failover attempt."""
        if getattr(self, "_member", None) is not None and not self._replicas:
            raise RuntimeError("the fleet's router is on global rank 0; "
                               "this rank only serves its replica")
        if deadline is None and timeout is not None:
            deadline = Deadline.after(float(timeout), self._clock)
        tr = RequestTrace(self.tracer, trace_id)
        t0 = self._clock()
        self._admit(tr, kw.get("tenant"))
        rep, out = self._dispatch(
            lambda rep: rep.predictor.infer(ids, deadline=deadline,
                                            trace_id=tr.trace_id, **kw),
            deadline, tr, t0)
        self._terminal("completed", t0, tr, replica=rep.name)
        return out

    def infer_stream(self, ids, timeout=None, deadline=None, trace_id=None,
                     **kw):
        """Streaming dispatch: failover only at admission; once a replica
        accepts, the stream is pinned to it."""
        if deadline is None and timeout is not None:
            deadline = Deadline.after(float(timeout), self._clock)
        tr = RequestTrace(self.tracer, trace_id)
        t0 = self._clock()
        self._admit(tr, kw.get("tenant"))
        rep, gen = self._dispatch(
            lambda rep: rep.predictor.infer_stream(
                ids, deadline=deadline, trace_id=tr.trace_id, **kw),
            deadline, tr, t0)
        return self._stream_relay(rep, gen, tr, t0)

    def _stream_relay(self, rep, gen, tr, t0):
        """Relay the replica's token iterator and land the fleet-level
        terminal."""
        try:
            yield from gen
        except DeadlineExceeded:
            self._terminal("timeouts", t0, tr, replica=rep.name)
            raise
        except GeneratorExit:
            self._terminal("timeouts", t0, tr, replica=rep.name,
                           where="stream_abandoned")
            raise
        except Exception as e:
            self._terminal("failed", t0, tr, replica=rep.name,
                           error=repr(e))
            raise
        else:
            self._terminal("completed", t0, tr, replica=rep.name)

    # ------------------------------------------------------------- lifecycle
    def ready(self) -> bool:
        """At least one replica can take a dispatch right now."""
        return not self._draining.is_set() and self._pick() is not None

    def pending(self) -> int:
        """Aggregate queued + in-flight across live replicas."""
        return sum(rep.predictor.pending() for rep in self._snapshot()
                   if self._refresh(rep) != "dead")

    def drain(self):
        self._draining.set()
        for rep in self._snapshot():
            if rep.state == "ready":
                rep.state = "draining"
            rep.predictor.drain()

    def close(self):
        """Close every replica. Over tensor-parallel groups every rank
        calls it: the router (rank 0) closes the replicas, the other
        leaders' through rpc; a follower's returns when its leader closed,
        a leader's when the router closed it; then the rpc agents stop."""
        self._draining.set()
        member = getattr(self, "_member", None)
        for rep in self._snapshot():
            rep.predictor.close()
            rep.state = "dead"
        if member is None:
            return
        name, pred, leads, started = member
        if leads and self._replicas == []:
            _CLOSED[name].wait()
        elif not leads:
            pred.close()
        _LED.pop(name, None)
        if started:
            from ..distributed import rpc

            rpc.shutdown()
        self._member = None
