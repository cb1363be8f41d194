"""Host-side observability: a labeled metrics registry that the serving
loops' summaries are views of, and a Chrome-trace-event step tracer.  The
reference's in-graph telemetry is not in the port."""
from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, Series, parse_prometheus,
)
from repro_torch.obs.trace import StepTracer  # noqa: F401
