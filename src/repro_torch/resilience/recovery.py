"""Request-level recovery: bounded admission queue with load shedding (a
copy of ``repro.resilience.recovery``; DESIGN.md §17, rungs 4-5).

``serve_continuous`` historically kept pending requests in a plain sorted
list — an arrival flood grew it unboundedly and every request waited
forever.  :class:`AdmissionQueue` keeps the exact legacy ordering
semantics (FIFO by ``(arrival, serial)``) when unbounded, and adds:

* a queue-depth bound: arrived-but-unadmitted requests beyond
  ``max_queue_depth`` are shed newest-first (FIFO fairness for the oldest);
* an admission deadline: requests that waited longer than
  ``admission_deadline_steps`` engine ticks without a free slot are shed
  with a retry-after hint;
* requeue bookkeeping for quarantined slots, capped per request so a
  persistently-poisoned request degrades to a shed, never a livelock.

Shedding only ever happens when a bound is configured — the default
(``ResilienceConfig`` absent or bounds at 0) completes every request.
"""
import bisect
from typing import List, Optional, Tuple


class AdmissionQueue:
    """Arrival-ordered pending queue for the continuous serving loop."""

    def __init__(self, max_queue_depth: int = 0,
                 admission_deadline_steps: int = 0):
        self.max_queue_depth = int(max_queue_depth)
        self.admission_deadline_steps = int(admission_deadline_steps)
        # entries sorted by (arrival, serial); serial keeps FIFO order among
        # equal arrivals and makes requeued entries compare without ever
        # comparing the request objects themselves
        self._entries: List[Tuple[float, int, object]] = []
        self._serial = 0
        self.shed: List[Tuple[int, float]] = []  # (rid, retry_after_steps)
        self.requeues: dict = {}                 # rid -> requeue count
        self.peak_depth = 0

    def __len__(self) -> int:
        return len(self._entries)

    def push(self, arrival: float, req) -> None:
        bisect.insort(self._entries, (float(arrival), self._serial, req))
        self._serial += 1

    def next_arrival(self) -> Optional[float]:
        return self._entries[0][0] if self._entries else None

    def waiting(self, tick: int) -> int:
        """Requests that have arrived but are not yet admitted."""
        return sum(1 for a, _, _ in self._entries if a <= tick)

    def pop_ready(self, tick: int):
        """Oldest request whose arrival time has passed, or None."""
        if self._entries and self._entries[0][0] <= tick:
            return self._entries.pop(0)[2]
        return None

    def requeue(self, tick: int, req, max_requeues: int) -> bool:
        """Re-enqueue a quarantined request (arrival = now, so it re-enters
        FIFO order behind everything already waiting).  Returns False and
        sheds instead once the request exhausted its requeue budget."""
        n = self.requeues.get(req.rid, 0) + 1
        self.requeues[req.rid] = n
        if max_requeues >= 0 and n > max_requeues:
            self.shed.append((req.rid, 0.0))
            return False
        self.push(float(tick), req)
        return True

    def shed_overdue(self, tick: int, retry_after: float = 0.0) -> List[int]:
        """Apply the configured bounds to the arrived-but-unadmitted set.
        Called after each admission round; returns rids shed this call."""
        self.peak_depth = max(self.peak_depth, self.waiting(tick))
        if self.max_queue_depth <= 0 and self.admission_deadline_steps <= 0:
            return []
        shed_now: List[int] = []
        # admission deadline: oldest arrivals that waited too long
        if self.admission_deadline_steps > 0:
            keep = []
            for entry in self._entries:
                arrival, _, req = entry
                if arrival <= tick and (tick - arrival
                                        ) > self.admission_deadline_steps:
                    shed_now.append(req.rid)
                else:
                    keep.append(entry)
            self._entries = keep
        # depth bound: shed the newest arrivals beyond the bound, keeping
        # the oldest max_queue_depth waiting (FIFO fairness)
        if self.max_queue_depth > 0:
            arrived = [e for e in self._entries if e[0] <= tick]
            for entry in arrived[self.max_queue_depth:]:
                shed_now.append(entry[2].rid)
                self._entries.remove(entry)
        for rid in shed_now:
            self.shed.append((rid, float(retry_after)))
        return shed_now
