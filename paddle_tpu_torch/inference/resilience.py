"""Resilience primitives the serving path uses — the counterpart of the
parts of ``paddle_tpu/inference/resilience.py`` that the continuous
scheduler needs: one ``Deadline`` per request, the typed load-shed
rejections the HTTP layer maps to 429/503, door-side admission, and the
terminal-outcome counters on the metrics registry
(``observability/metrics.py``). The circuit breaker and the thread
supervisor are not ported yet.
"""
from __future__ import annotations

import random
import threading
import time

from ..observability.metrics import DEFAULT_LATENCY_BUCKETS, MetricsRegistry

__all__ = ["DeadlineExceeded", "Rejected", "ServerBusy", "ServiceUnavailable",
           "Deadline", "AdmissionController", "ServingMetrics"]


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed (in queue, mid-decode, or client-side)."""


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
    """Not serving (draining, closed, worker dead) -> HTTP 503."""


class Deadline:
    """Absolute expiry on a monotonic clock."""

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
    """Admit-or-reject at submission time: queue depth and KV-pool
    pressure shed with ServerBusy (retryable); a request larger than the
    whole pool raises ValueError (no retry can fix it)."""

    def __init__(self, max_queue_depth=256, high_water=1.0, retry_after=0.5):
        self.max_queue_depth = int(max_queue_depth)
        self.high_water = float(high_water)
        self.retry_after = float(retry_after)

    def admit(self, queue_depth, cache=None, blocks_needed=None):
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


class ServingMetrics:
    """Terminal-outcome counters and the latency tail, on the typed metrics
    registry (JAX ``resilience.py:244-336``). Conservation contract: every
    accepted request increments exactly one of completed / failed /
    timeouts.

    Every ``inc`` / ``observe_latency`` also lands in the registry: counters
    as ``paddle_serving_events_total{component, event}``, latencies in the
    ``paddle_serving_request_latency_seconds`` histogram. ``snapshot()``
    is the legacy JSON: the counters plus p50 / p95 / p99 over a uniform
    reservoir of latencies (Vitter's algorithm R)."""

    _LAT_CAP = 4096

    def __init__(self, registry=None, component="serving", rng=None):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._latencies: list[float] = []
        self._lat_seen = 0
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
                j = self._rng.randrange(self._lat_seen)
                if j < self._LAT_CAP:
                    self._latencies[j] = v
        self._prom_latency.labels(self.component).observe(v)

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            lat = sorted(self._latencies)
        for q, name in ((0.50, "p50_ms"), (0.95, "p95_ms"), (0.99, "p99_ms")):
            if lat:
                i = min(len(lat) - 1, int(round(q * (len(lat) - 1))))
                out[name] = round(lat[i] * 1000.0, 3)
        return out
