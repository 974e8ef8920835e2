"""End-to-end observability for the port's serving stack
(``observability/``): span tracing and unified metrics, with the
reference's span names and export format, so traces of the two packages
read alike and each validates under the other's schema gate.

  * ``Tracer`` / ``Span`` — bounded-ring span tracer with Chrome
    trace-event / Perfetto export; sessions enable it with
    ``SessionConfig(trace=True)`` and read it via
    ``MonitorSession.tracer`` / ``export_trace``.
  * ``MetricsRegistry`` / ``Counter`` / ``Gauge`` — the counter / gauge
    / histogram registry behind ``MonitorSession.metrics()`` and the
    correction server's heartbeat snapshot.
  * ``validate_chrome_trace`` / ``load_trace`` — the trace-event schema
    gate.
  * ``span`` / ``span_backward`` — ``torch.profiler`` ranges at the
    program's layer boundaries, opened only while a profiler records.
  * ``breakdown`` / ``breakdown_table`` — span durations by stage.
"""
from repro_torch.observability.metrics import (Counter, Gauge, MetricsRegistry,
                                         flatten)
from repro_torch.observability.report import breakdown, breakdown_table
from repro_torch.observability.trace import (Span, Tracer, load_trace, span,
                                       span_backward, validate_chrome_trace)

__all__ = ["Counter", "Gauge", "MetricsRegistry", "flatten",
           "Span", "Tracer", "breakdown", "breakdown_table",
           "load_trace", "span", "span_backward", "validate_chrome_trace"]
