"""Host-side step tracer emitting Chrome-trace-event JSON (a copy of
``repro.obs.trace``).

The output loads directly in Perfetto / chrome://tracing: a top-level
``{"traceEvents": [...], "displayTimeUnit": "ms"}`` object whose events
are complete spans (``ph == "X"`` with microsecond ``ts``/``dur``),
instants (``ph == "i"``), and counter samples (``ph == "C"``).

Host phases traced by the serving loops: plan build, admissions and step
execution.  The times are the host's: a span around an engine tick ends
when its kernels are enqueued, not when the device has run them.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional


class StepTracer:
    """Thread-safe collector of Chrome trace events.

    All timestamps are microseconds relative to tracer construction,
    taken from ``time.perf_counter()``.  ``tid`` is the emitting thread,
    so work on another thread lands on its own track.
    """

    def __init__(self, pid: int = 1):
        self.pid = pid
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.events = []

    # -- time ------------------------------------------------------------
    def now(self) -> float:
        """Microseconds since tracer start (also usable as a span start
        handle for :meth:`complete`)."""
        return (time.perf_counter() - self._t0) * 1e6

    def _emit(self, ev: dict) -> None:
        with self._lock:
            self.events.append(ev)

    def _base(self, name: str, cat: str) -> dict:
        return {"name": name, "cat": cat, "pid": self.pid,
                "tid": threading.get_ident() & 0xFFFF}

    # -- emitters ----------------------------------------------------------
    @contextmanager
    def span(self, name: str, cat: str = "host",
             args: Optional[Dict] = None):
        """Complete-event span around a ``with`` block."""
        t0 = self.now()
        try:
            yield self
        finally:
            ev = self._base(name, cat)
            ev.update(ph="X", ts=t0, dur=self.now() - t0,
                      args=dict(args or {}))
            self._emit(ev)

    def complete(self, name: str, start_us: float, cat: str = "host",
                 args: Optional[Dict] = None) -> None:
        """Span from a :meth:`now` handle to now (for call sites where a
        ``with`` block is awkward, e.g. inside locked sections)."""
        ev = self._base(name, cat)
        ev.update(ph="X", ts=start_us, dur=self.now() - start_us,
                  args=dict(args or {}))
        self._emit(ev)

    def instant(self, name: str, cat: str = "host",
                args: Optional[Dict] = None) -> None:
        ev = self._base(name, cat)
        ev.update(ph="i", ts=self.now(), s="t", args=dict(args or {}))
        self._emit(ev)

    def counter(self, name: str, value: float, cat: str = "host") -> None:
        ev = self._base(name, cat)
        ev.update(ph="C", ts=self.now(), args={name: float(value)})
        self._emit(ev)

    # -- export ------------------------------------------------------------
    def to_json(self) -> dict:
        with self._lock:
            events = list(self.events)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path) -> None:
        with open(path, "w") as f:
            # args may carry arbitrary config objects; stringify rather
            # than fail the export
            json.dump(self.to_json(), f, indent=1, default=str)
            f.write("\n")
