"""Observability of the port: the typed metrics registry and its
Prometheus text exposition, request-scoped tracing, serving SLOs with
burn-rate alerting, the per-tick flight recorder, the utilization ledger
and the CUDA device introspection they read, and the training monitors
(``StepMonitor`` bound to ``jit.TrainStep``, ``NumericsAnomalyDetector``)."""
from .device import cost_flops, device_peak_flops, memory_stats
from .flightrecorder import FlightRecorder, dump_all, live_recorders
from .metrics import (
    DEFAULT_LATENCY_BUCKETS,
    MetricsRegistry,
    render_prometheus,
)
from .slo import SLOMonitor, SLOPolicy, make_policies
from .trace import (
    RequestTrace,
    Span,
    Tracer,
    current_trace_id,
    export_joined_chrome,
    new_trace_id,
)
from .training import (
    TRAIN_STEP_BUCKETS,
    AnomalyEvent,
    NumericsAnomalyDetector,
    StepMonitor,
)
from .utilization import UtilizationLedger, attribute_launch

__all__ = ["MetricsRegistry", "render_prometheus", "DEFAULT_LATENCY_BUCKETS",
           "FlightRecorder", "dump_all", "live_recorders", "SLOMonitor",
           "SLOPolicy", "make_policies", "RequestTrace", "Span", "Tracer",
           "current_trace_id", "export_joined_chrome", "new_trace_id",
           "UtilizationLedger", "attribute_launch", "AnomalyEvent",
           "NumericsAnomalyDetector", "StepMonitor", "TRAIN_STEP_BUCKETS",
           "cost_flops", "device_peak_flops", "memory_stats"]
