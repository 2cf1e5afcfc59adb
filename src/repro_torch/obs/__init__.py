"""The port's observability layer, one import point.

* :mod:`repro_torch.obs.trace` — nested wall-clock span tracing over the
  telemetry JSONL stream, exportable to Chrome ``trace_event`` JSON, and
  Path M's stage spans (``STAGES``), live under a profiler;
* :mod:`repro_torch.obs.metrics` — typed counters/gauges/mergeable
  histograms with per-deadline-class latency percentiles;
* :mod:`repro_torch.obs.schema` — the event-schema registry every
  ``Telemetry.event`` emitter declares through (rendered into README.md);
* :mod:`repro_torch.obs.profile` — ``torch.profiler`` capture per phase
  and its summary: device time attributed to the phase that launched it,
  and top-K ops.
"""
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    LATENCY_BUCKETS,
    MetricsRegistry,
    REGISTRY,
)
from repro_torch.obs.schema import (  # noqa: F401
    EVENT_SCHEMAS,
    EventSchema,
    render_markdown,
    validate_event,
    validate_events,
)
from repro_torch.obs.trace import (  # noqa: F401
    NULL_TRACER,
    NullTracer,
    Span,
    SpanTracer,
    spans_to_chrome,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "LATENCY_BUCKETS",
    "MetricsRegistry", "REGISTRY",
    "EVENT_SCHEMAS", "EventSchema", "render_markdown",
    "validate_event", "validate_events",
    "NULL_TRACER", "NullTracer", "Span", "SpanTracer",
    "spans_to_chrome",
]
