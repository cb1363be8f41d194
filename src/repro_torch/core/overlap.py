"""Ring hop ordering on a two-tier fabric (the pure-Python half of
``repro.core.overlap``).

The serving latency model prices a chunked ring all-to-all hop by hop;
these helpers say how many of a hop's edges cross a host boundary and in
which order the hops run.  The ring collectives themselves need the
expert-parallel mesh (ROADMAP A.9).
"""
from __future__ import annotations

from typing import Optional, Tuple


def hop_crossings(shift: int, n: int, devices_per_host: int) -> int:
    """How many of the n ring edges of a shift-``shift`` permute cross a
    host boundary, for ``n`` devices packed contiguously ``H`` per host:
    ``min(shift, n - shift, H)``.  Crossing edges share the host NIC, so
    the hop's wire time scales with this count."""
    if devices_per_host <= 0 or devices_per_host >= n:
        return 0
    return min(shift % n, (n - shift) % n, devices_per_host)


def ring_hop_schedule(n: int, *, devices_per_host: Optional[int] = None
                      ) -> Tuple[int, ...]:
    """Topology-aware order for the (n-1) ring hops: shifts sorted by how
    many inter-host edges they cross, cheapest first, ties by shift.  With
    no topology (``devices_per_host`` unset, or one host) this is the
    natural order ``(1, ..., n-1)``."""
    shifts = list(range(1, n))
    if devices_per_host is None or devices_per_host >= n:
        return tuple(shifts)
    if n % devices_per_host != 0:
        raise ValueError(f"devices_per_host={devices_per_host} must divide "
                         f"the ring size n={n}")
    return tuple(sorted(shifts,
                        key=lambda h: (hop_crossings(h, n, devices_per_host),
                                       h)))
