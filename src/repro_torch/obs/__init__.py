"""Staleness-aware observability: ``ObsConfig``-gated in-graph telemetry
carried through ``MoEAux`` (``telemetry.py``), a labeled metrics registry
that the serving loops' summaries are views of (``metrics.py``), and a
Chrome-trace-event step tracer (``trace.py``)."""
from repro_torch.obs.telemetry import (  # noqa: F401
    AGE, CODEC_ERR, DROP_FRAC, MASK_RATE, NUM_FIELDS, RES_COMBINE,
    RES_DISPATCH, TELEMETRY_FIELDS, ObsConfig, layer_telemetry,
    merge_staggered, stamp_age,
)
from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, Series, parse_prometheus,
)
from repro_torch.obs.trace import StepTracer  # noqa: F401
