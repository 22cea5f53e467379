"""Resilience primitives for the serving stack — the port's own copy of
``paddle_tpu/inference/resilience.py`` (pure Python).

* ``Deadline`` — one absolute expiry per request, propagated HTTP -> queue
  -> step launch, so a request times out exactly once.
* ``ServerBusy`` / ``ServiceUnavailable`` — typed load-shed rejections the
  HTTP layer maps to 429 / 503 with ``Retry-After``.
* ``AdmissionController`` — reject at the door (queue depth, KV-pool
  pressure, oversized requests) instead of failing mid-batch.
* ``CircuitBreaker`` — trip after repeated predictor failures, fail fast
  while open, half-open a single probe after a cooldown.
* ``Supervisor`` — restart a dead worker thread, with a capped budget.
* ``ServingMetrics`` — terminal-outcome counters and the latency tail on
  the typed metrics registry (``observability/metrics.py``).

Everything takes an injectable ``clock``, so the chaos tests drive expiry
by skewing time instead of sleeping (``inference/faults.py``).
"""
from __future__ import annotations

import random
import threading
import time

from ..analysis.lockwitness import make_lock
from ..observability.metrics import DEFAULT_LATENCY_BUCKETS, MetricsRegistry

__all__ = [
    "DeadlineExceeded", "Rejected", "ServerBusy", "ServiceUnavailable",
    "Deadline", "AdmissionController", "CircuitBreaker", "Supervisor",
    "ServingMetrics",
]


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed (in queue, mid-batch, or client-side).

    Subclasses TimeoutError so pre-existing callers of
    ``BatchingPredictor.infer(timeout=...)`` keep working unchanged."""


class Rejected(RuntimeError):
    """Base for load-shed rejections; carries the HTTP mapping."""

    status = 503

    def __init__(self, msg, retry_after=None):
        super().__init__(msg)
        self.retry_after = retry_after


class ServerBusy(Rejected):
    """Transient overload (queue full / KV pool exhausted) -> HTTP 429."""

    status = 429


class ServiceUnavailable(Rejected):
    """Not serving (draining, breaker open, worker dead) -> HTTP 503.

    ``permanent=True`` marks a 503 no amount of client retrying will fix —
    today that is exactly one case: a Supervisor whose restart budget is
    spent (the worker is dead for good). The ReplicaFleet router keys replica
    death off this flag instead of string-matching the message."""

    def __init__(self, msg, retry_after=None, permanent=False):
        super().__init__(msg, retry_after=retry_after)
        self.permanent = bool(permanent)


class Deadline:
    """Absolute expiry on an injectable monotonic clock."""

    __slots__ = ("at", "clock")

    def __init__(self, at, clock=time.monotonic):
        self.at = float(at)
        self.clock = clock

    @classmethod
    def after(cls, seconds, clock=time.monotonic):
        return cls(clock() + float(seconds), clock)

    def remaining(self) -> float:
        return self.at - self.clock()

    def expired(self) -> bool:
        return self.clock() >= self.at


class AdmissionController:
    """Admit-or-reject at submission time.

    Rejecting at the door is the whole game: a request that will sit in a
    full queue or OOM the pool mid-batch costs a batch slot, pool churn, and
    a confusing 500; rejecting it here costs one exception and gives the
    client a ``Retry-After`` hint instead."""

    def __init__(self, max_queue_depth=256, high_water=1.0, retry_after=0.5):
        self.max_queue_depth = int(max_queue_depth)
        self.high_water = float(high_water)     # live-utilization shed point
        self.retry_after = float(retry_after)

    def admit(self, queue_depth, cache=None, blocks_needed=None):
        """Raises ServerBusy (retryable) on overload. Oversized requests that
        can NEVER fit raise ValueError (a retry cannot fix the request)."""
        if queue_depth >= self.max_queue_depth:
            raise ServerBusy(
                f"queue full ({queue_depth} >= {self.max_queue_depth})",
                retry_after=self.retry_after)
        if cache is not None and blocks_needed is not None:
            if blocks_needed > cache.num_blocks:
                raise ValueError(
                    f"request needs {blocks_needed} blocks but the whole "
                    f"pool is {cache.num_blocks}; no retry can succeed")
            if cache.live_utilization >= self.high_water:
                raise ServerBusy(
                    f"KV pool at {cache.live_utilization:.0%} live "
                    f"utilization (high water {self.high_water:.0%})",
                    retry_after=self.retry_after)


class CircuitBreaker:
    """closed -> open after N consecutive failures -> half-open after a
    cooldown (one probe) -> closed on probe success, re-open on failure."""

    def __init__(self, failure_threshold=5, reset_after=1.0,
                 clock=time.monotonic):
        self.failure_threshold = int(failure_threshold)
        self.reset_after = float(reset_after)
        self.clock = clock
        self._lock = make_lock("resilience.CircuitBreaker._lock")
        self._failures = 0
        self._opened_at = None
        self._probing = False
        self.trips = 0

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if self.clock() - self._opened_at >= self.reset_after:
                return "half-open"
            return "open"

    def allow(self) -> bool:
        """May a new call proceed? Half-open admits exactly one probe."""
        with self._lock:
            if self._opened_at is None:
                return True
            if self.clock() - self._opened_at < self.reset_after:
                return False
            if self._probing:
                return False
            self._probing = True
            return True

    def retry_after(self) -> float:
        with self._lock:
            if self._opened_at is None:
                return 0.0
            return max(0.0, self.reset_after - (self.clock() - self._opened_at))

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self):
        with self._lock:
            self._failures += 1
            was_open = self._opened_at is not None
            if self._probing or self._failures >= self.failure_threshold:
                self._opened_at = self.clock()   # (re)open; restart cooldown
                self._probing = False
                if not was_open:
                    self.trips += 1


class Supervisor:
    """Restart a dead worker thread, with capped exponential backoff.

    heal() is called from request paths (submit AND the client wait loop), so
    a batcher that dies with requests still queued is restarted by the very
    clients waiting on it — no dedicated watchdog thread to leak."""

    def __init__(self, factory, name="worker", max_restarts=5, backoff=0.0,
                 sleep=time.sleep):
        self._factory = factory         # () -> started-able threading.Thread
        self.name = name
        self.max_restarts = int(max_restarts)
        self.backoff = float(backoff)
        self._sleep = sleep
        self._lock = make_lock("resilience.Supervisor._lock")
        self.restarts = 0
        self.thread = None

    def start(self):
        with self._lock:    # same guard as heal(): `thread` has ONE lockset
            self.thread = self._factory()
            self.thread.start()
            return self.thread

    def alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def dead(self) -> bool:
        """Permanently down: the worker is not running and the restart
        budget is spent (heal() would raise). The fleet's replica-state
        gauge reads this without triggering a heal."""
        return not self.alive() and self.restarts >= self.max_restarts

    def heal(self) -> bool:
        """Restart the worker if it died. True if a restart happened; raises
        ServiceUnavailable once the restart budget is spent (at that point
        the service is genuinely down and clients should go elsewhere)."""
        if self.alive():
            return False
        with self._lock:
            if self.alive():                      # lost the race: healed
                return False
            if self.restarts >= self.max_restarts:
                raise ServiceUnavailable(
                    f"{self.name} dead after {self.restarts} restarts",
                    retry_after=None, permanent=True)
            self.restarts += 1
            if self.backoff:
                self._sleep(min(self.backoff * (2 ** (self.restarts - 1)),
                                1.0))
            self.thread = self._factory()
            self.thread.start()
            return True


class ServingMetrics:
    """Terminal-outcome counters + latency tail, re-based on the typed
    observability registry (observability/metrics.py).

    Conservation contract (pinned by the chaos tests and the pressure
    bench): every ACCEPTED request increments exactly one of
    ``completed`` / ``failed`` / ``timeouts``; admission rejections increment
    ``rejected_busy`` / ``rejected_unavailable`` instead and are never
    accepted. Anything else (deferred, retries, ...) is free-running
    telemetry outside the conservation sum.

    Every ``inc``/``observe_latency`` ALSO lands in the Prometheus registry:
    counters as ``paddle_serving_events_total{component=...,event=...}``
    (the conservation sum is therefore checkable straight off the /metrics
    exposition) and latencies as the
    ``paddle_serving_request_latency_seconds`` histogram. The legacy
    ``snapshot()`` JSON shape is unchanged.

    The latency reservoir is a UNIFORM sample (Vitter's algorithm R): with
    the old append-until-full buffer, sample 4097+ was silently dropped and
    p99 froze minutes into a long run — late-arriving tail latencies now
    displace random earlier samples so the percentiles keep tracking the
    live distribution."""

    _LAT_CAP = 4096

    def __init__(self, registry=None, component="serving", rng=None):
        self._lock = make_lock("resilience.ServingMetrics._lock")
        self._counters: dict[str, int] = {}
        self._latencies: list[float] = []
        self._lat_seen = 0                      # total observations ever
        self._rng = rng if rng is not None else random.Random(0x7A11)
        self.component = str(component)
        self.registry = registry if registry is not None else MetricsRegistry()
        self._prom_events = self.registry.counter(
            "paddle_serving_events_total",
            "Serving lifecycle events by component; conservation: "
            "accepted == completed + failed + timeouts",
            labels=("component", "event"))
        self._prom_latency = self.registry.histogram(
            "paddle_serving_request_latency_seconds",
            "Accepted-request latency to terminal outcome",
            labels=("component",), buckets=DEFAULT_LATENCY_BUCKETS)
        self._utilization = None

    def attach_utilization(self, ledger):
        """ride the utilization ledger's compact block on every
        snapshot() — operators get mfu / flops-by-kind / host-gap tail from
        the JSON /metrics page without a Prometheus scrape (mirrors the
        tracer/flight blocks)."""
        with self._lock:
            self._utilization = ledger

    def inc(self, name, n=1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n
        self._prom_events.labels(self.component, name).inc(n)

    def get(self, name) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def observe_latency(self, seconds):
        v = float(seconds)
        with self._lock:
            self._lat_seen += 1
            if len(self._latencies) < self._LAT_CAP:
                self._latencies.append(v)
            else:
                # Vitter R: keep each of the n samples with P = CAP/n
                j = self._rng.randrange(self._lat_seen)
                if j < self._LAT_CAP:
                    self._latencies[j] = v
        self._prom_latency.labels(self.component).observe(v)

    @staticmethod
    def _pct(sorted_vals, q):
        if not sorted_vals:
            return None
        i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
        return sorted_vals[i]

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            lat = sorted(self._latencies)
        for q, name in ((0.50, "p50_ms"), (0.95, "p95_ms"), (0.99, "p99_ms")):
            v = self._pct(lat, q)
            if v is not None:
                out[name] = round(v * 1000.0, 3)
        if self._utilization is not None:
            out["utilization"] = self._utilization.metrics_block()
        return out
