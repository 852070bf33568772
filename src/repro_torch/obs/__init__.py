"""repro_torch.obs — zero-dependency tracing + metrics for the port.

Copies of the reference package's tracer (:mod:`repro_torch.obs.trace`),
metrics registry (:mod:`repro_torch.obs.metrics`), Prometheus/JSON
exposition (:mod:`repro_torch.obs.export`), Chrome-trace export
(:mod:`repro_torch.obs.chrome`) and the serving and engine instrument
bundles (:mod:`repro_torch.obs.instruments`).
"""
from .chrome import to_chrome_trace, write_chrome_trace
from .export import (
    MetricsEndpoint,
    render_prometheus,
    snapshot,
    write_metrics_json,
)
from .instruments import EngineMetrics, ServeMetrics
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
)
from .trace import (
    NULL_TRACER,
    Span,
    Tracer,
    emit_iteration,
    iteration_scope,
)

__all__ = [
    "Counter",
    "EngineMetrics",
    "Gauge",
    "Histogram",
    "MetricsEndpoint",
    "MetricsRegistry",
    "NULL_TRACER",
    "REGISTRY",
    "ServeMetrics",
    "Span",
    "Tracer",
    "emit_iteration",
    "iteration_scope",
    "render_prometheus",
    "snapshot",
    "to_chrome_trace",
    "write_chrome_trace",
]
