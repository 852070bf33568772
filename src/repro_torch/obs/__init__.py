"""repro_torch.obs — zero-dependency tracing + metrics for the port.

Copies of the reference package's tracer (:mod:`repro_torch.obs.trace`),
metrics registry (:mod:`repro_torch.obs.metrics`) and the engine's
instrument bundle (:mod:`repro_torch.obs.instruments`).  Prometheus and Chrome-trace
export are not ported yet.
"""
from .instruments import EngineMetrics
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
    "MetricsRegistry",
    "NULL_TRACER",
    "REGISTRY",
    "Span",
    "Tracer",
    "emit_iteration",
    "iteration_scope",
]
