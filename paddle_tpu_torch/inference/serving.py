"""Serving front: the request CAS, the whole-batch generation predictor
and the HTTP endpoint — the counterpart of the parts of
``paddle_tpu/inference/serving.py`` the generation paths need.

Every request carries one deadline from the HTTP header through the queue
into the scheduler's ticks and reaches exactly one terminal outcome
(result | failure | cancel) through a compare-and-swap on its state.
``InferenceServer`` speaks the JAX package's protocol: ``POST /generate``
with an npz body ``{ids}`` answers npz ``{out0}``; ``GET /health`` and
``GET /readyz``. Not ported yet: SSE streaming, the sampler/adapter/tenant
headers, ``/metrics``, ``/debug/*``, the circuit breaker, the thread
supervisor and ``ReplicaFleet``.
"""
from __future__ import annotations

import io
import itertools
import queue
import threading
import time

import numpy as np
import torch

from ..framework import resolve_device
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
                 "defers", "t0", "max_new", "temperature", "top_k", "_lock",
                 "_state")

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
    one ``generate_paged`` call: prompts right-padded to the batch's
    longest, each request reserving only ceil((len + max_new_tokens) /
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
    body), as the continuous scheduler does."""

    _component = "generator"

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
        self.kv_cache = kv_cache
        self.max_batch_size = int(max_batch_size)
        self.max_delay = float(max_delay_ms) / 1000.0
        self.max_new_tokens = int(max_new_tokens)
        self.max_retries = int(max_retries)
        self.max_defers = int(max_defers)
        self.admission = (admission if admission is not None
                          else AdmissionController())
        self.metrics = ServingMetrics()
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
            plens = np.asarray([len(r.arrays[0]) for _, r in admitted],
                               np.int64)
            P = int(plens.max())
            prompts = np.zeros((n, P), np.int64)
            for i, (_, r) in enumerate(admitted):
                prompts[i, :plens[i]] = r.arrays[0]
            nb = max(cache.blocks_for(int(p) + self.max_new_tokens)
                     for p in plens)
            tbl = np.stack([cache.block_table(rid, pad_to=nb)
                            for rid, _ in admitted])
            dls = [r.deadline for _, r in admitted]
            batch_dl = (max(dls, key=lambda d: d.remaining())
                        if all(d is not None for d in dls) else None)
            toks = self.model.generate_paged(
                prompts, plens, cache, tbl,
                max_new_tokens=self.max_new_tokens, deadline=batch_dl)
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
                    dtype=dtype, deadline=r.deadline)
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
    def _finish_req(self, req, result) -> bool:
        if req.finish(result):
            self.metrics.inc("completed")
            return True
        self.metrics.inc("wasted_results")  # the client already gave up
        return False

    def _fail(self, req, error) -> bool:
        if not req.fail(error):
            return False
        self.metrics.inc("timeouts" if isinstance(error, DeadlineExceeded)
                         else "failed")
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


class InferenceServer:
    """HTTP npz endpoint over a generation predictor: ``POST /generate``
    (npz {ids} -> npz {out0}; ``X-Timeout-Ms`` caps the wait),
    ``GET /health`` and ``GET /readyz``. Overload answers 429/503 with
    Retry-After, deadline expiry 504, a malformed request 400.

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
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, status, body, headers=()):
                self.send_response(status)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _fail_http(self, e):
                headers = []
                if isinstance(e, Rejected):
                    status = e.status
                    headers.append(("Retry-After", "1"))
                elif isinstance(e, TimeoutError):
                    status = 504
                elif isinstance(e, CacheOutOfBlocks):
                    status = 503
                    headers.append(("Retry-After", "1"))
                elif isinstance(e, ValueError):
                    status = 400
                else:
                    status = 500
                self._reply(status, repr(e).encode(), headers)

            def _timeout(self):
                ms = self.headers.get("X-Timeout-Ms")
                if ms is None:
                    return outer.default_timeout
                try:
                    return min(outer.default_timeout, float(ms) / 1000.0)
                except ValueError:
                    return outer.default_timeout

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/health":
                    self._reply(200, b"ok")
                elif path == "/readyz":
                    if (outer._ready.is_set() and not outer._draining.is_set()
                            and outer.generator.ready()):
                        self._reply(200, b"ready")
                    else:
                        self._reply(503, b"not ready", [("Retry-After", "1")])
                else:
                    self._reply(404, b"")

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
                    out = outer.generator.infer(ids, timeout=self._timeout())
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
