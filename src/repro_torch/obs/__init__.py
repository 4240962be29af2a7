"""Observability plane (DESIGN.md §14, §17): Prometheus-style metrics
registry, per-request Chrome-trace tracer, the instrumentation hook
object threaded through the runtime / controller / gateway as
``hooks=``, plus the SLO error-budget engine (burn-rate alerting), the
control-plane flight recorder, and the push-based telemetry exporter.

A copy of the JAX package's ``obs/__init__.py``.
"""
from repro_torch.obs.audit import AuditEvent, AuditLog
from repro_torch.obs.export import (ListTransport, MetricBatch, OtlpJsonSink,
                              PushExporter, StatsdSink)
from repro_torch.obs.hooks import Instrumentation
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               parse_exposition)
from repro_torch.obs.slo import (Alert, AlertRule, SloLedger, SloMonitor,
                           SloPlane, sre_rules)
from repro_torch.obs.tracing import Span, Tracer, validate_chrome_trace

__all__ = ["Alert", "AlertRule", "AuditEvent", "AuditLog", "Counter",
           "Gauge", "Histogram", "Instrumentation", "ListTransport",
           "MetricBatch", "MetricsRegistry", "OtlpJsonSink",
           "PushExporter", "Span", "SloLedger", "SloMonitor", "SloPlane",
           "StatsdSink", "Tracer", "parse_exposition", "sre_rules",
           "validate_chrome_trace"]
