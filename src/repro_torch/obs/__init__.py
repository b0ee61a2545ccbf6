"""Observability spine (copies of ``repro.obs``): typed Counter/Gauge/
Histogram in a Registry with the legacy ``MetricsView`` dict API, a span
Tracer with Chrome trace export, the bounded ``RingLog``, and the
plan-vs-actual report over a ``HierarchicalPlan`` (``planview``; its
command line is ``python -m repro_torch.obs.cli report``).
"""

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsView,
                                     Registry, prometheus_lines)
from repro_torch.obs.planview import (DEFAULT_BAND, format_report,
                                      plan_vs_actual)
from repro_torch.obs.trace import (RingLog, Tracer, merge_events,
                                   validate_events, write_chrome)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsView", "Registry",
    "prometheus_lines",
    "RingLog", "Tracer", "merge_events", "validate_events", "write_chrome",
    "DEFAULT_BAND", "format_report", "plan_vs_actual",
]
