"""Serving front: the request CAS, the whole-batch generation predictor
and the HTTP endpoint — the counterpart of the parts of
``paddle_tpu/inference/serving.py`` the generation paths need.

Every request carries one deadline from the HTTP header through the queue
into the scheduler's ticks and reaches exactly one terminal outcome
(result | failure | cancel) through a compare-and-swap on its state.
``InferenceServer`` speaks the JAX package's protocol: ``POST /generate``
with an npz body ``{ids}`` answers npz ``{out0}``, or Server-Sent Events
(``X-Stream: sse`` / ``Accept: text/event-stream``) from a streaming
generator; ``X-Temperature``, ``X-Top-K`` and ``X-Spec`` are per-request
sampler knobs; ``GET /health``, ``GET /readyz`` and ``GET /metrics`` (JSON
counters, or the Prometheus text of every registry with ``?format=prom``
or an Accept header naming text/plain). Not ported: the adapter and tenant
headers, ``/slo``, ``/utilization``, ``/debug/*``, the circuit breaker,
the thread supervisor and ``ReplicaFleet`` (ROADMAP A7).
"""
from __future__ import annotations

import io
import itertools
import json
import math
import os
import queue
import threading
import time

import numpy as np
import torch

from ..framework import resolve_device
from ..observability.metrics import MetricsRegistry, render_prometheus
from .kv_cache import CacheOutOfBlocks, PagedKVCache
from .resilience import (
    AdmissionController,
    Deadline,
    DeadlineExceeded,
    Rejected,
    ServerBusy,
    ServiceUnavailable,
    ServingMetrics,
)

__all__ = ["GenerateBatchingPredictor", "InferenceServer"]

_PENDING, _DONE, _CANCELLED = "pending", "done", "cancelled"


class _Request:
    """One in-flight request with compare-and-swap terminal semantics:
    exactly one of finish()/fail()/cancel() wins; the losers see False."""

    __slots__ = ("arrays", "event", "result", "error", "deadline", "retries",
                 "defers", "t0", "max_new", "temperature", "top_k", "spec",
                 "on_tokens", "_lock", "_state")

    def __init__(self, arrays, deadline=None):
        self.arrays = arrays
        self.deadline = deadline
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.retries = 0        # failed-tick re-runs consumed
        self.defers = 0         # pool-full deferrals consumed
        self.t0 = None
        self.max_new = None     # per-request token budget
        self.temperature = None
        self.top_k = None
        self.spec = None        # speculation opt-out (None: the default)
        self.on_tokens = None   # streaming flush callback (infer_stream)
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


class GenerateBatchingPredictor:
    """Dynamic whole-batch generation over a SHARED paged KV pool (JAX
    ``serving.py:582-797``).

    A batcher thread collects up to ``max_batch_size`` requests within
    ``max_delay_ms`` (waking early once the batch fills) and serves them in
    one ``generate_paged`` call: the batch padded to the power of two at
    or above its size (at most ``max_batch_size``; a padding row writes
    only the pool's scratch page and its tokens are dropped), prompts
    right-padded to the power of two at or above the batch's longest (at
    most the model's ``max_position``), so batches of nearby sizes and
    lengths replay one captured program, each request
    reserving only ceil((len + max_new_tokens) /
    block_size) blocks of the pool. A request that cannot reserve RIGHT NOW
    is deferred to a later batch at most ``max_defers`` times, then shed
    with ServerBusy; the rest of its batch proceeds. Every reserved block is
    released whatever the batch did.

    When the pool's (layers, kv heads, head dim) do not match the model's,
    paged calls would write into the wrong shapes, so the predictor serves
    each request through dense ``generate()`` instead (``fallback_dense``;
    counted as ``dense_fallback_batches``), in the pool's dtype.

    ``device`` defaults to CUDA and raises on a machine without it unless
    the caller passes ``device="cpu"``; it must be the model's device, and
    the pool's. Subclasses may replace ``_loop`` (the batcher thread's
    body), as the continuous scheduler does.

    ``metrics.registry`` (a ``MetricsRegistry``) holds the predictor's
    series under the ``component`` label: the serving events, the pool's
    state, the launch-latency histogram and the generated-token counter
    (JAX ``serving.py:636-652``)."""

    _component = "generator"
    decode_kernel = "kernel"        # the step programs' attention route
    supports_sampler_knobs = False  # per-request headers: continuous only
    supports_streaming = False      # SSE: continuous only

    def __init__(self, model, max_batch_size=8, max_delay_ms=2.0,
                 max_new_tokens=32, kv_cache=None, block_size=32,
                 num_blocks=64, admission=None, max_retries=1, max_defers=8,
                 device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, predictor asked for "
                             f"{self.device}")
        spec = tuple(int(x) for x in model._decode_cache_spec())
        if kv_cache is None:
            kv_cache = PagedKVCache(*spec, block_size=block_size,
                                    num_blocks=num_blocks,
                                    device=self.device)
        if kv_cache.device != self.device:
            raise ValueError(f"KV pool on {kv_cache.device}, predictor on "
                             f"{self.device}")
        self.fallback_dense = (kv_cache.num_layers, kv_cache.num_kv_heads,
                               kv_cache.head_dim) != spec
        self.model = model
        self._max_position = int(getattr(getattr(model, "config", None),
                                         "max_position", 1 << 62))
        self.kv_cache = kv_cache
        self.max_batch_size = int(max_batch_size)
        self.max_delay = float(max_delay_ms) / 1000.0
        self.max_new_tokens = int(max_new_tokens)
        self.max_retries = int(max_retries)
        self.max_defers = int(max_defers)
        self.admission = (admission if admission is not None
                          else AdmissionController())
        self.metrics = ServingMetrics(component=self._component)
        reg = self.metrics.registry
        kv_cache.bind_metrics(reg, pool=self._component)
        self._decode_hist = reg.histogram(
            "paddle_decode_launch_seconds",
            "Host wall of one decode launch (prefill + compiled scan "
            "dispatch) by path", labels=("component", "path"))
        self._tokens_total = reg.counter(
            "paddle_generated_tokens_total", "Tokens generated (batch * new)",
            labels=("component",))
        self.batch_sizes: list[int] = []
        self._clock = time.monotonic
        self._rid = itertools.count(1)      # atomic id draws
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._batch_running = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"batching-predictor[{self._component}]")
        self._thread.start()

    def _gen_timing(self, info):
        """The generation timing hook -> the registry's series."""
        self._decode_hist.labels(self._component, info["path"]).observe(
            info["launch_s"])
        self._tokens_total.labels(self._component).inc(
            info["batch"] * info["new_tokens"])

    # ---------------------------------------------------------------- worker
    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            self._batch_running.set()
            try:
                self._run_batch(self._collect(first))
            finally:
                self._batch_running.clear()

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

    def _run_batch(self, batch):
        batch = [r for r in batch if self._usable(r)]
        if not batch:
            return
        if self.fallback_dense:
            return self._run_dense(batch)
        cache = self.kv_cache
        admitted: list[tuple] = []
        try:
            for r in batch:
                rid = ("req", next(self._rid))
                try:
                    cache.reserve(rid, len(r.arrays[0]) + self.max_new_tokens)
                except CacheOutOfBlocks as e:
                    self._shed_or_defer(r, e)
                    continue
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
            dls = [r.deadline for _, r in admitted]
            batch_dl = (max(dls, key=lambda d: d.remaining())
                        if all(d is not None for d in dls) else None)
            toks = self.model.generate_paged(
                prompts, plens, cache, tbl,
                max_new_tokens=self.max_new_tokens,
                decode_kernel=self.decode_kernel, deadline=batch_dl,
                timing_hook=self._gen_timing)
            self.metrics.inc("generated_tokens", n * self.max_new_tokens)
            for i, (rid, r) in enumerate(admitted):
                cache.set_length(rid, int(plens[i]) + self.max_new_tokens)
                self._finish_req(r, np.concatenate(
                    [r.arrays[0], toks[i].astype(r.arrays[0].dtype)]))
        except Exception as e:      # this batch fails, not the loop
            self.metrics.inc("batch_failures")
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
        dtype = (None if self.kv_cache.dtype == torch.float32
                 else self.kv_cache.dtype)
        for r in batch:
            try:
                out = self.model.generate(
                    r.arrays[0][None], max_new_tokens=self.max_new_tokens,
                    dtype=dtype, decode_kernel=self.decode_kernel,
                    deadline=r.deadline, timing_hook=self._gen_timing)
                self.metrics.inc("generated_tokens", self.max_new_tokens)
                self._finish_req(r, out[0].cpu().numpy().astype(
                    r.arrays[0].dtype))
            except Exception as e:  # this request fails, not the loop
                self.metrics.inc("batch_failures")
                self._fail_or_retry(r, e)

    # ---------------------------------------------------------------- client
    def infer(self, ids, timeout=None, deadline=None):
        """One prompt (1-D int ids) in -> prompt + generated ids out."""
        return self._submit(self._make_request([np.asarray(ids)], timeout,
                                               deadline))

    def _make_request(self, arrays, timeout, deadline):
        if deadline is None and timeout is not None:
            deadline = Deadline.after(float(timeout), self._clock)
        return _Request(arrays, deadline)

    def _admission_check(self, arrays, req=None):
        need = self.kv_cache.blocks_for(len(arrays[0]) + self.max_new_tokens)
        self.admission.admit(self._queue.qsize(), cache=self.kv_cache,
                             blocks_needed=need)

    def _submit(self, req):
        self._start(req)
        return self._await(req)

    def _start(self, req):
        """Admission: shed / validation outcomes raise here, then the
        accepted request enters the queue."""
        try:
            if self._stop.is_set() or self._draining.is_set():
                raise ServiceUnavailable("predictor is shutting down")
            self._admission_check(req.arrays, req)
        except Rejected as e:
            self.metrics.inc("rejected_busy" if isinstance(e, ServerBusy)
                             else "rejected_unavailable")
            raise
        except ValueError:
            self.metrics.inc("rejected_invalid")
            raise
        self.metrics.inc("accepted")
        req.t0 = self._clock()
        self._queue.put(req)

    def _await(self, req):
        """Wait for the terminal outcome; a client-side deadline cancels."""
        while True:
            if req.deadline is None:
                step = 0.1
            else:
                rem = req.deadline.remaining()
                if rem <= 0:
                    if req.cancel():
                        self.metrics.inc("timeouts")
                        self._observe(req)
                        raise DeadlineExceeded("inference request timed out")
                    break   # lost the race: a terminal outcome just landed
                step = min(0.1, rem)
            if req.event.wait(step):
                break
            if not self._thread.is_alive():
                self._fail(req, ServiceUnavailable("batcher thread died"))
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
            return True
        self.metrics.inc("wasted_results")  # the client already gave up
        return False

    def _fail(self, req, error) -> bool:
        if not req.fail(error):
            return False
        self.metrics.inc("timeouts" if isinstance(error, DeadlineExceeded)
                         else "failed")
        self._observe(req)
        return True

    def _fail_or_retry(self, req, error):
        """Give the request another pass unless the error is terminal by
        construction or its deadline has passed."""
        retryable = not isinstance(error, (Rejected, DeadlineExceeded))
        if (retryable and req.retries < self.max_retries
                and not self._stop.is_set()
                and not (req.deadline is not None
                         and req.deadline.expired())):
            req.retries += 1
            self.metrics.inc("retries")
            self._queue.put(req)
        else:
            self._fail(req, error)

    def _usable(self, req) -> bool:
        """Cancelled requests are skipped, expired ones failed here."""
        if req.state != _PENDING:
            if req.state == _CANCELLED:
                self.metrics.inc("cancelled_skipped")
            return False
        if req.deadline is not None and req.deadline.expired():
            if self._fail(req, DeadlineExceeded("deadline expired in queue")):
                self.metrics.inc("expired_in_queue")
            return False
        return True

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
            self._queue.put(req)

    # ------------------------------------------------------------- lifecycle
    def ready(self) -> bool:
        return self._thread.is_alive() and not self._stop.is_set()

    def pending(self) -> int:
        """Queued + in-flight batches (the drain condition)."""
        return self._queue.qsize() + (1 if self._batch_running.is_set()
                                      else 0)

    def drain(self):
        """Refuse new requests; queued / in-flight ones keep running."""
        self._draining.set()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=10)
        while True:     # nobody hangs on a closed predictor
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            self._fail(r, ServiceUnavailable("predictor closed"))


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


_TRACE_SESSION = os.urandom(4).hex()
_TRACE_SEQ = itertools.count(1)


def new_trace_id() -> str:
    """Process-unique trace id: <random session>-<sequence>."""
    return f"{_TRACE_SESSION}-{next(_TRACE_SEQ):08x}"


class InferenceServer:
    """HTTP npz endpoint over a generation predictor (JAX
    ``serving.py:799-1406``, the generation surface):

    * ``POST /generate``: npz {ids} -> npz {out0}; ``X-Timeout-Ms`` caps the
      wait; ``X-Temperature`` / ``X-Top-K`` / ``X-Spec`` (on|off) are the
      request's sampler knobs, a malformed value a 400, and a 400 too on a
      generator that batches whole requests with one sampler; ``X-Stream:
      sse`` (or ``Accept: text/event-stream`` without ``X-Stream: off``)
      answers Server-Sent Events — ``tokens`` events as the scheduler
      flushes them, then ``done`` (or ``error`` with the status), each with
      the trace id in its ``id:`` field and its JSON;
    * ``GET /health``; ``GET /readyz``, 200 only while started, not
      draining and the generator ``ready()`` (a warming scheduler answers
      503);
    * ``GET /metrics``: the JSON counters, or the Prometheus text of the
      server's, the generator's and the pool's series with ``?format=prom``
      or an Accept header naming text/plain or openmetrics.

    Overload answers 429/503 with Retry-After, deadline expiry 504, a
    malformed request 400; every response carries ``X-Trace-Id`` (the
    client's, or minted here).

    ``device`` defaults to CUDA and raises on a machine without it unless
    the caller passes ``device="cpu"``; it must be the generator's."""

    def __init__(self, generator, host="127.0.0.1", port=0,
                 default_timeout=30.0, device="cuda"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        dev = resolve_device(device)
        if generator.device != dev:
            raise ValueError(f"generator on {generator.device}, server asked "
                             f"for {dev}")
        self.generator = generator
        self.default_timeout = float(default_timeout)
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
                                  "/generate") else "other"

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

            def _fail_http(self, e):
                status, shed = _http_status(e)
                self._reply(status, repr(e).encode(),
                            [("Retry-After", "1")] if shed else [])

            def _timeout(self):
                ms = self.headers.get("X-Timeout-Ms")
                if ms is None:
                    return outer.default_timeout
                try:
                    return min(outer.default_timeout, float(ms) / 1000.0)
                except ValueError:
                    return outer.default_timeout

            def _sampler_knobs(self):
                """X-Temperature / X-Top-K / X-Spec -> infer() kwargs; a
                malformed value raises ValueError (400), as does any of
                them on a generator without per-request knobs."""
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
                if kw and not outer.generator.supports_sampler_knobs:
                    raise ValueError(
                        "per-request sampler headers need the continuous "
                        "scheduler (ContinuousGenerateBatchingPredictor); "
                        "this server's generator batches whole requests "
                        "with a fixed sampler config")
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
                    if (outer._ready.is_set() and not outer._draining.is_set()
                            and outer.generator.ready()):
                        self._reply(200, b"ready")
                    else:
                        body = (b"draining" if outer._draining.is_set()
                                else b"not ready" if outer._ready.is_set()
                                else b"not started")
                        self._reply(503, body, [("Retry-After", "1")])
                elif path == "/metrics":
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
                    snap = {"draining": outer._draining.is_set(),
                            "generator": outer.generator.metrics.snapshot()}
                    self._reply(200, json.dumps(snap).encode(),
                                [("Content-Type", "application/json")])
                else:
                    self._reply(404, b"")

            def _generate_sse(self, ids):
                """Server-Sent Events for /generate: admission errors raise
                before any byte is written (so 429/503/400 stay HTTP
                statuses); after the headers a failure travels as an
                ``error`` event with its status. Close-delimited: no
                Content-Length, ``done`` or ``error`` ends the stream."""
                gen = outer.generator
                if not gen.supports_streaming:
                    raise ValueError(
                        "streaming needs the continuous scheduler "
                        "(ContinuousGenerateBatchingPredictor); this "
                        "server's generator buffers whole responses")
                it = gen.infer_stream(ids, timeout=self._timeout(),
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
                if self.path != "/generate":
                    self._reply(404, b"")
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    data = np.load(io.BytesIO(self.rfile.read(n)))
                    ids = data[data.files[0]]
                    if self._wants_stream():
                        self._generate_sse(ids)
                        return
                    out = outer.generator.infer(ids, timeout=self._timeout(),
                                                **self._sampler_knobs())
                    buf = io.BytesIO()
                    np.savez(buf, out0=out)
                    self._reply(200, buf.getvalue(),
                                [("Content-Type", "application/npz")])
                except Exception as e:      # every failure answers HTTP
                    self._fail_http(e)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="inference-server")

    def render_prometheus(self) -> str:
        """One Prometheus text exposition over the server's and the
        generator's registries."""
        return render_prometheus(self.registry,
                                 self.generator.metrics.registry)

    def start(self):
        self._thread.start()
        self._ready.set()
        return self

    def stop(self, drain_timeout=5.0):
        """Graceful drain: /readyz turns 503, new POSTs are refused, queued
        and in-flight requests finish (up to drain_timeout), then the HTTP
        loop and the generator stop."""
        self._draining.set()
        self._ready.clear()
        self.generator.drain()
        deadline = time.monotonic() + float(drain_timeout)
        while time.monotonic() < deadline and self.generator.pending():
            time.sleep(0.01)
        if self._thread.is_alive():
            self._httpd.shutdown()
        self._httpd.server_close()
        self.generator.close()
        if self._thread.is_alive():
            self._thread.join(timeout=2)
