"""Ring-overlap execution engine (port of ``repro.core.overlap``).

The blocking expert-parallel path runs one all-to-all before the grouped
expert FFN and one after it, and nothing overlaps them.  The ring engine
splits each (all-to-all, FFN, all-to-all) triple into ``2 (n - 1)``
point-to-point hops over an :class:`~repro_torch.launch.mesh.EPMesh`:

  hop 0    the chunk of this rank's tokens routed to its own experts
           enters the FFN at once, with no wire;
  hop h    one ``(e_loc, C, d)`` chunk moves to rank ``(i + h) % n``
           directly (one ``batch_isend_irecv``), started before the FFN
           of the chunk that arrived at the previous hop, so the transfer
           runs while that FFN does;
  combine  each chunk's expert output goes straight back (shift ``-h``)
           as soon as it is computed, while the next chunk's FFN runs.

The total volume equals the all-to-all's, nothing is forwarded twice, and
each chunk sees the per-row arithmetic of the blocking path (the grouped
FFN is row-independent), so the two agree up to the order of float sums.
Unlike the reference, which unrolls the hops into one traced graph for
XLA's scheduler, the port issues them eagerly: ``dist.batch_isend_irecv``
returns at once, and the rank enqueues the next FFN while the hop is in
flight.

The pure-Python helpers below price and order the hops for the serving
latency model and the resilience watchdog.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


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


def hop_anomaly(step_wall_s: float, baseline_s: float, factor: float,
                *, floor_s: float = 0.0) -> bool:
    """Whether a measured engine-tick walltime is a ring-hop anomaly: above
    ``factor x baseline`` (and above the absolute ``floor_s``).  With no
    calibrated baseline yet nothing is an anomaly, so warm-up ticks cannot
    trip a watchdog."""
    if baseline_s <= 0.0:
        return False
    return step_wall_s > max(floor_s, factor * baseline_s)


def ring_shift(x: torch.Tensor, mesh, shift: int, *, tag: int = 0,
               out: Optional[torch.Tensor] = None):
    """Start one ring hop: this rank's ``x`` moves to rank
    ``(rank + shift) % n``, and the ``x`` of rank ``(rank - shift) % n``
    arrives in ``out`` (by default a new buffer like ``x``).  Returns
    ``(out, wait)``; ``out`` holds the data once ``wait()`` returns."""
    n, i = mesh.size, mesh.rank
    out = torch.empty_like(x) if out is None else out
    wait = mesh.exchange(x, (i + shift) % n, out, (i - shift) % n, tag)
    return out, wait


def ring_expert_exchange(chunks: torch.Tensor,
                         expert_fn: Callable[[torch.Tensor], torch.Tensor],
                         *, mesh, wire_dtype=None,
                         hop_schedule: Optional[Tuple[int, ...]] = None
                         ) -> torch.Tensor:
    """Dispatch ring -> per-chunk expert FFN -> combine ring.

    ``chunks`` (n, e_loc, C, d): piece ``j`` holds this rank's dispatch
    rows for the experts of rank ``j``.  ``expert_fn`` is the grouped FFN
    of the local experts on one ``(e_loc, C, d)`` chunk.  ``wire_dtype``
    is the combine payload's dtype (the blocking path casts to the
    activation dtype before its second all-to-all).  ``hop_schedule`` is
    the order of the ``n - 1`` remote hops, a permutation of
    ``1 .. n - 1`` (default the natural order); each chunk still moves by
    its own shift, so the order changes no number.

    Returns (n, e_loc, C, d) where piece ``j`` holds the expert outputs of
    the rows this rank sent toward rank ``j``: the layout of the blocking
    combine all-to-all's result.  On a staging mesh (gloo on a card) the
    chunks are copied to pinned host memory once, before the first hop.
    Held against the blocking all-to-alls over gloo only: ``nccl`` with
    more than one rank is untested until the 4-card NCCL cell of ROADMAP,
    whose first run holds ring against blocking to 1e-4.
    """
    wire_dtype = wire_dtype or chunks.dtype
    n = mesh.size
    if n == 1:
        return expert_fn(chunks[0])[None].to(wire_dtype)
    sched = (tuple(hop_schedule) if hop_schedule is not None
             else tuple(range(1, n)))
    if sorted(sched) != list(range(1, n)):
        raise ValueError(f"hop_schedule {sched} must be a permutation of "
                         f"1..{n - 1}")
    idx = mesh.rank
    src = chunks
    if mesh.stages_p2p:
        from repro_torch.launch.mesh import host_copy
        src = host_copy(chunks)
    out = torch.empty(chunks.shape, dtype=wire_dtype, device=chunks.device)

    def send_chunk(h: int):
        # the chunk for rank (idx + h) % n, delivered there directly
        return ring_shift(src[(idx + h) % n], mesh, h, tag=h,
                          out=torch.empty_like(chunks[0]))

    in_flight = send_chunk(sched[0])
    out[idx] = expert_fn(chunks[idx]).to(wire_dtype)
    combines = []
    for i, h in enumerate(sched):
        arrived, wait = in_flight
        wait()
        if i + 1 < len(sched):
            # the next hop's transfer runs while this chunk's FFN does
            in_flight = send_chunk(sched[i + 1])
        o = expert_fn(arrived).to(wire_dtype)
        # the output of the chunk rank (idx - h) sent goes straight back to
        # it; what arrives is this rank's piece for rank (idx + h) % n
        _, w = ring_shift(o, mesh, -h, tag=n + h, out=out[(idx + h) % n])
        combines.append(w)
    for w in combines:
        w()
    return out
