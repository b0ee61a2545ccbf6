"""Observability spine (verbatim copies of ``repro.obs.metrics`` and
``repro.obs.trace``): typed Counter/Gauge/Histogram in a Registry with the
legacy ``MetricsView`` dict API, a span Tracer with Chrome trace export, and
the bounded ``RingLog``.  ``planview`` and the CLI wait for a later slice.
"""

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsView,
                                     Registry, prometheus_lines)
from repro_torch.obs.trace import (RingLog, Tracer, merge_events,
                                   validate_events, write_chrome)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsView", "Registry",
    "prometheus_lines",
    "RingLog", "Tracer", "merge_events", "validate_events", "write_chrome",
]
