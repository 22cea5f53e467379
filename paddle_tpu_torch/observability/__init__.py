"""Observability of the port: the typed metrics registry and its
Prometheus text exposition."""
from .metrics import DEFAULT_LATENCY_BUCKETS, MetricsRegistry, render_prometheus

__all__ = ["MetricsRegistry", "render_prometheus", "DEFAULT_LATENCY_BUCKETS"]
