"""Labeled metrics registry with Prometheus-text and JSON exposition (a
copy of ``repro.obs.metrics``).

One registry instance is the single source of truth for everything the
serving stack counts: the summary dicts `DiceServer.generate`,
`serve_queue`, and `serve_continuous` return are *views* computed from a
registry, replacing the three hand-rolled accumulator paths that used to
drift apart (a stat added to one path silently missed the others).

Conventions:

  * every metric name starts with ``dice_``; counters end in ``_total``,
    durations are ``_seconds``, sizes are ``_bytes``;
  * labels are plain string->string dicts (``schedule``, ``layer``,
    ``path``, ``variant``, ...);
  * a :class:`Series` is an append-only time series (one value per step
    or tick); Prometheus text exposes its last value as a gauge, the
    JSON snapshot carries the full series.

No external dependency: exposition is plain text / ``json.dumps``.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional, Tuple

# Log-spaced latency buckets (seconds): wide enough for host-CPU smoke
# runs and real-accelerator steps alike.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labels: _LabelKey):
        self.name = name
        self.help = help
        self.labels = labels

    @property
    def label_dict(self) -> Dict[str, str]:
        return dict(self.labels)

    def _label_str(self, extra: Optional[Dict[str, str]] = None) -> str:
        items = list(self.labels) + sorted((extra or {}).items())
        if not items:
            return ""
        return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help, labels):
        super().__init__(name, help, labels)
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += float(v)

    def expose(self) -> List[str]:
        return [f"{self.name}{self._label_str()} {_fmt(self.value)}"]

    def snap(self):
        return {"value": self.value}

    def merge(self, other: "Counter") -> None:
        self.value += other.value


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help, labels):
        super().__init__(name, help, labels)
        self.value = 0.0
        self._set = False

    def set(self, v: float) -> None:
        self.value = float(v)
        self._set = True

    def set_max(self, v: float) -> None:
        self.value = float(v) if not self._set else max(self.value, float(v))
        self._set = True

    def expose(self) -> List[str]:
        return [f"{self.name}{self._label_str()} {_fmt(self.value)}"]

    def snap(self):
        return {"value": self.value}

    def merge(self, other: "Gauge") -> None:
        if other._set:
            self.set_max(other.value)


class Histogram(_Metric):
    """Bucketed histogram that also keeps raw observations so views can
    report exact means and nearest-rank p50/p95/p99 quantiles."""
    kind = "histogram"

    def __init__(self, name, help, labels, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labels)
        self.buckets = tuple(buckets)
        self.bucket_counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0
        self.raw: List[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        self.raw.append(v)
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.bucket_counts[i] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        if not self.raw:
            return 0.0
        s = sorted(self.raw)
        idx = max(0, min(len(s) - 1, math.ceil(q * len(s)) - 1))
        return s[idx]

    def expose(self) -> List[str]:
        lines = []
        # bucket_counts[i] counts v <= buckets[i], i.e. already cumulative.
        for ub, c in zip(self.buckets, self.bucket_counts):
            lines.append(
                f"{self.name}_bucket{self._label_str({'le': _fmt(ub)})} {c}")
        lines.append(
            f"{self.name}_bucket{self._label_str({'le': '+Inf'})} "
            f"{self.count}")
        lines.append(f"{self.name}_sum{self._label_str()} {_fmt(self.sum)}")
        lines.append(f"{self.name}_count{self._label_str()} {self.count}")
        return lines

    def snap(self):
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }

    def merge(self, other: "Histogram") -> None:
        for v in other.raw:
            self.observe(v)


class Series(_Metric):
    """Append-only time series (per-step / per-tick samples).  Exposed
    as a gauge (last value) in Prometheus text; the JSON snapshot keeps
    the full series — this is what the closed-loop controller reads."""
    kind = "series"

    def __init__(self, name, help, labels):
        super().__init__(name, help, labels)
        self.values: List[float] = []

    def append(self, v: float) -> None:
        self.values.append(float(v))

    def extend(self, vs) -> None:
        self.values.extend(float(v) for v in vs)

    @property
    def last(self) -> float:
        return self.values[-1] if self.values else 0.0

    def expose(self) -> List[str]:
        return [f"{self.name}{self._label_str()} {_fmt(self.last)}"]

    def snap(self):
        return {"values": list(self.values)}

    def merge(self, other: "Series") -> None:
        self.values.extend(other.values)


class MetricsRegistry:
    """Thread-safe get-or-create registry keyed by (name, labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, _LabelKey], _Metric] = {}

    def _get(self, cls, name, help, labels, **kw):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help, key[1], **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            elif help and not m.help:
                m.help = help
            return m

    def counter(self, name, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def series(self, name, help: str = "",
               labels: Optional[Dict[str, str]] = None) -> Series:
        return self._get(Series, name, help, labels)

    # -- reads ---------------------------------------------------------
    def get(self, name, labels: Optional[Dict[str, str]] = None):
        return self._metrics.get((name, _label_key(labels)))

    def value(self, name, labels: Optional[Dict[str, str]] = None,
              default: float = 0.0) -> float:
        m = self.get(name, labels)
        if m is None:
            return default
        return getattr(m, "value", default)

    def find(self, name: str) -> List[_Metric]:
        """All label-children of one metric name."""
        return [m for (n, _), m in sorted(self._metrics.items())
                if n == name]

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold another registry into this one (counters add, gauges
        max, histograms/series concatenate)."""
        with other._lock:
            items = list(other._metrics.items())
        for (name, lk), m in items:
            mine = self._get(type(m), name, m.help, dict(lk),
                             **({"buckets": m.buckets}
                                if isinstance(m, Histogram) else {}))
            mine.merge(m)

    # -- exposition ----------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines: List[str] = []
        seen_header = set()
        for (name, _), m in items:
            if name not in seen_header:
                seen_header.add(name)
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                ptype = "gauge" if m.kind == "series" else m.kind
                lines.append(f"# TYPE {name} {ptype}")
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able snapshot: full histograms quantiles and series."""
        with self._lock:
            items = sorted(self._metrics.items())
        out = []
        for (name, _), m in items:
            entry = {"name": name, "kind": m.kind, "labels": m.label_dict}
            entry.update(m.snap())
            out.append(entry)
        return {"schema": "dice-metrics-snapshot/1", "metrics": out}

    def write_snapshot(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
            f.write("\n")

    def write_prometheus(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_prometheus())


def parse_prometheus(text: str) -> Dict[str, Dict[str, object]]:
    """Minimal parser for the exposition format (used by tests and the
    bench --check validator): returns {sample_name{labels} -> value} plus
    per-name TYPE entries under ``__types__``."""
    samples: Dict[str, float] = {}
    types: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, ptype = line.split(None, 3)
            types[name] = ptype
            continue
        if line.startswith("#"):
            continue
        key, _, val = line.rpartition(" ")
        if not key:
            raise ValueError(f"malformed sample line: {line!r}")
        samples[key] = float(val)
    return {"samples": samples, "__types__": types}
