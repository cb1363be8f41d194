"""Affinity-aware expert placement and hot-expert replication (port of
``repro.core.placement``, whose code it copies; numpy only, so the plan
and the schedule config import it without torch).

Diffusion-MoE routing is skewed and stable across adjacent timesteps, so
the last steps' routing histogram predicts the next steps' traffic.  This
module turns that histogram into a plan-time layout:

  :class:`RoutingHistogram`
      an EMA of per-layer per-expert routing shares, fed from
      ``MoEAux.served_counts`` (after the capacity drop).  Each layer's
      counts become shares before the EMA, so a mean over the ranks of a
      mesh, a sum, or one device's counts give the same histogram.

  :func:`greedy_placements`
      per layer, an expert -> device assignment (an LPT bin-pack that
      minimises the bottleneck device's share of the traffic, ties broken
      deterministically) plus the ``replicate_top`` hottest experts,
      replicated on every device so their tokens never go on the wire.

  :class:`Placement`
      the hashable per-layer result a ``LayerAction`` carries.
      ``cap_scale`` is where the wire shrinks: the dispatch buffer has a
      static shape, so with the hottest experts served locally the
      per-expert capacity only has to cover the hottest replicated-out
      remainder (quantized up to 1/16; exactly 1.0 without replicas).

  :func:`placed_params`
      permutes the ``experts_*`` stacks into placement order (device-
      major, so each device's slice holds its experts) and appends the
      replicated ``experts_*_rep`` stacks.  Indexing works on numpy arrays
      and torch tensors alike.

The staleness caches follow tokens, not experts, so a placement change
never invalidates ``h_cache``, ``y_buf`` or ``c_base``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np


CAP_QUANTUM = 16      # cap_scale quantizes UP to multiples of 1/16: small
#                       histogram jitter must not mint new plan variants


# ---------------------------------------------------------------------------
# the per-layer placement (hashable -> plannable)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Placement:
    """One MoE layer's expert layout.  Fully static and hashable — a
    :class:`repro_torch.core.plan.LayerAction` carries it exactly like
    ``codec`` / ``effective_k``, so it is part of a plan variant and two steps
    with equal placements share one variant.

    perm
        wire position -> expert id: ``perm[s]`` is the (original) expert
        id living in slot ``s`` of the placed dispatch buffer.  Device
        ``j`` of an n-way ep axis owns slots ``[j*E/n, (j+1)*E/n)``.
    replicated
        expert ids replicated on every device; their (token, rank) pairs
        are masked OUT of the dispatch buffer and served by a local
        replica FFN instead (sorted ascending — deterministic).
    cap_scale
        planned dispatch-capacity multiplier in (0, 1]; see module
        docstring.  1.0 with no replicas by construction.
    """
    perm: Tuple[int, ...] = ()
    replicated: Tuple[int, ...] = ()
    cap_scale: float = 1.0

    def __post_init__(self):
        E = len(self.perm)
        if sorted(self.perm) != list(range(E)):
            raise ValueError(f"perm must be a permutation of 0..{E - 1}, "
                             f"got {self.perm}")
        if list(self.replicated) != sorted(set(self.replicated)):
            raise ValueError("replicated must be sorted unique expert ids")
        if any(not 0 <= r < E for r in self.replicated):
            raise ValueError(f"replicated ids {self.replicated} out of "
                             f"range for {E} experts")
        if not 0.0 < self.cap_scale <= 1.0:
            raise ValueError(f"cap_scale must be in (0, 1], got "
                             f"{self.cap_scale}")

    @staticmethod
    def identity(E: int) -> "Placement":
        return Placement(perm=tuple(range(E)))

    @property
    def num_experts(self) -> int:
        return len(self.perm)

    @property
    def is_identity(self) -> bool:
        """True iff this placement is a no-op: original expert order, no
        replicas, full capacity — the layout every pre-placement run
        used.  Identity placements normalize away in
        ``LayerAction.__post_init__`` so plans and outputs stay
        bit-identical to pre-placement configs."""
        return (self.perm == tuple(range(len(self.perm)))
                and not self.replicated and self.cap_scale == 1.0)

    def inv_perm(self) -> Tuple[int, ...]:
        """expert id -> wire position (the scatter-side lookup)."""
        inv = [0] * len(self.perm)
        for pos, e in enumerate(self.perm):
            inv[e] = pos
        return tuple(inv)

    def scaled_capacity(self, capacity: int, *, floor: int = 8) -> int:
        """Apply ``cap_scale`` to a planned per-expert capacity, keeping
        the ``floor`` alignment of
        :func:`repro_torch.core.moe.default_capacity` and never exceeding
        the unscaled value."""
        if self.cap_scale >= 1.0:
            return capacity
        c = int(np.ceil(capacity * self.cap_scale))
        c = max(floor, -(-c // floor) * floor)
        return min(c, capacity)


# ---------------------------------------------------------------------------
# serving-time config (how the engine uses the optimizer)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PlacementConfig:
    """Serving-engine placement policy (DiceServer / serve_continuous).

    mode
        "identity"  never re-place (the pre-placement behavior)
        "greedy"    run :func:`greedy_placements` on the observed
                    histogram at drift boundaries
    replicate_top
        hottest experts replicated on every device (0 disables).
    ema_decay
        histogram EMA decay per observed step.
    drift_threshold
        re-shard when the max-over-layers total-variation distance
        between the live EMA and the shares the current placement was
        computed from exceeds this.
    warmup_ticks
        observed steps before the first re-shard may trigger (a cold
        histogram is noise).
    """
    mode: str = "identity"
    replicate_top: int = 0
    ema_decay: float = 0.9
    drift_threshold: float = 0.15
    warmup_ticks: int = 8

    def __post_init__(self):
        if self.mode not in ("identity", "greedy"):
            raise ValueError(f"placement mode must be 'identity' or "
                             f"'greedy', got {self.mode!r}")
        if self.replicate_top < 0:
            raise ValueError("replicate_top must be >= 0")
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError("ema_decay must be in [0, 1)")


# ---------------------------------------------------------------------------
# online routing histogram (EMA of per-layer shares)
# ---------------------------------------------------------------------------
class RoutingHistogram:
    """Per-layer EMA of normalized per-expert routing shares.

    Fed with (L, E) served-pair counts per executed step.  Each layer's
    counts are normalized to shares BEFORE the EMA, so the scale of the
    feed is irrelevant: a pmean over the ep axis (what the mesh-native
    aux reduction produces), the psum, or the raw single-device counts
    all yield the identical histogram — the distributed == single-device
    property the EMA test asserts.
    """

    def __init__(self, num_layers: int, num_experts: int, *,
                 decay: float = 0.9):
        self.decay = float(decay)
        self.num_layers = num_layers
        self.num_experts = num_experts
        self._ema: Optional[np.ndarray] = None    # (L, E) shares
        self.updates = 0

    def update(self, counts) -> None:
        """counts: (L, E) served pairs this step (any nonneg scale)."""
        c = np.asarray(counts, np.float64)
        if c.shape != (self.num_layers, self.num_experts):
            raise ValueError(f"expected counts of shape "
                             f"({self.num_layers}, {self.num_experts}), "
                             f"got {c.shape}")
        tot = c.sum(axis=1, keepdims=True)
        shares = np.where(tot > 0, c / np.maximum(tot, 1e-30),
                          1.0 / self.num_experts)
        if self._ema is None:
            self._ema = shares          # first observation: no uniform bias
        else:
            self._ema = self.decay * self._ema + (1 - self.decay) * shares
        self.updates += 1

    @property
    def shares(self) -> np.ndarray:
        """(L, E) current EMA shares (uniform before any update)."""
        if self._ema is None:
            return np.full((self.num_layers, self.num_experts),
                           1.0 / self.num_experts)
        return self._ema.copy()


def drift(a, b) -> float:
    """Max-over-layers total-variation distance between two (L, E) share
    arrays — the serving engine's re-shard trigger metric."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(0.5 * np.abs(a - b).sum(axis=-1).max())


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------
def _quantize_up(x: float, q: int = CAP_QUANTUM) -> float:
    return min(1.0, float(np.ceil(x * q - 1e-9)) / q)


def greedy_placement(shares: Sequence[float], n_dev: int, *,
                     replicate_top: int = 0) -> Placement:
    """One layer's placement from its (E,) traffic shares.

    Replication: the ``replicate_top`` hottest experts (ties -> lower
    id) are replicated on every device and masked off the wire.

    Assignment (LPT greedy bin-pack): experts in descending traffic
    order (ties -> lower id) each go to the least-loaded device with an
    open slot (ties -> lowest device index), E/n_dev slots per device —
    minimizing the bottleneck device's receive mass, i.e.
    :func:`expected_cross_device_traffic`.  Within a device, experts
    sort ascending by id, and whenever the pack is no better than the
    original layout (uniform histograms in particular) the identity perm
    wins the tie — so uniform histograms with no replicas reproduce the
    identity layout exactly.

    ``cap_scale`` preserves the identity layout's relative headroom: the
    placed buffer covers the hottest non-replicated expert at the same
    margin the unscaled buffer covers the hottest expert overall.
    """
    s = np.asarray(shares, np.float64)
    E = s.size
    if E % n_dev:
        raise ValueError(f"{E} experts do not divide over {n_dev} devices")
    if replicate_top >= E:
        raise ValueError(f"replicate_top={replicate_top} must leave at "
                         f"least one non-replicated expert of {E}")
    e_loc = E // n_dev
    # deterministic hot order: descending share, ties broken by lower id
    order = np.lexsort((np.arange(E), -s))
    replicated = tuple(sorted(int(e) for e in order[:replicate_top]))

    # LPT bin-pack over ALL experts (replicas keep their sharded-stack
    # slot too: E - R rarely divides n_dev, and the wire rows of a
    # replicated expert are simply masked empty) — but replicated experts
    # pack with ZERO weight: their mass never hits the wire, so only the
    # non-replicated shares should shape the bottleneck the pack minimizes
    s_eff = s.copy()
    if replicated:
        s_eff[list(replicated)] = 0.0
    order_eff = np.lexsort((np.arange(E), -s_eff))
    load = np.zeros(n_dev)
    fill: list = [[] for _ in range(n_dev)]
    for e in order_eff:
        open_devs = [j for j in range(n_dev) if len(fill[j]) < e_loc]
        j = min(open_devs, key=lambda j: (load[j], j))
        fill[j].append(int(e))
        load[j] += s_eff[e]
    perm = tuple(e for dev in fill for e in sorted(dev))

    cap_scale = 1.0
    if replicated:
        rep = np.zeros(E, bool)
        rep[list(replicated)] = True
        max_all = float(s.max())
        max_nonrep = float(s[~rep].max())
        if max_all > 0 and max_nonrep < max_all:
            cap_scale = _quantize_up(max_nonrep / max_all)
    pl = Placement(perm=perm, replicated=replicated, cap_scale=cap_scale)
    # tie-break toward identity: when the pack is no better than the
    # original layout (uniform histograms, e.g. — LPT round-robins them
    # into a pointless shuffle for e_loc > 1), keep the identity perm so
    # the placement can normalize away and plans stay bit-identical
    ident = Placement(perm=tuple(range(E)), replicated=replicated,
                      cap_scale=cap_scale)
    if (expected_cross_device_traffic(s, ident, n_dev)
            <= expected_cross_device_traffic(s, pl, n_dev) + 1e-12):
        return ident
    return pl


def greedy_placements(shares, n_dev: int, *,
                      replicate_top: int = 0) -> Tuple[Placement, ...]:
    """Per-layer placements from (L, E) histogram shares."""
    sh = np.asarray(shares, np.float64)
    return tuple(greedy_placement(sh[i], n_dev,
                                  replicate_top=replicate_top)
                 for i in range(sh.shape[0]))


def expected_cross_device_traffic(shares, placement: Placement,
                                  n_dev: int) -> float:
    """Bottleneck cross-device traffic under ``placement``: the max over
    devices of the share mass its owned (non-replicated) experts
    receive, scaled by (n-1)/n — the fraction of that mass arriving over
    the wire when tokens shard uniformly over devices.  The TOTAL
    cross-device volume is permutation-invariant under uniform token
    sharding; what placement controls is where the mass concentrates,
    and the exchange (blocking all-to-all and ring pipeline alike)
    completes only when the hottest device finishes receiving.  The LPT
    greedy pack minimizes exactly this bound; replication lowers it
    further by taking the hottest experts' mass off the wire entirely.
    """
    s = np.asarray(shares, np.float64)
    s = s / max(s.sum(), 1e-30)
    E = s.size
    e_loc = E // n_dev
    rep = set(placement.replicated)
    worst = 0.0
    for j in range(n_dev):
        owned = [e for e in placement.perm[j * e_loc:(j + 1) * e_loc]
                 if e not in rep]
        worst = max(worst, sum(float(s[e]) for e in owned))
    return worst * (n_dev - 1) / n_dev


# ---------------------------------------------------------------------------
# parameter layout
# ---------------------------------------------------------------------------
_MOE_LEAVES = ("experts_gate", "experts_up", "experts_down")


def place_moe_params(p: dict, placement: Optional[Placement]) -> dict:
    """One MoE layer's param dict re-laid-out under ``placement``:
    ``experts_*`` stacks permute to wire order (device-major, so dim-0
    ep sharding lands each device's assigned experts on it) and
    replicated experts append as ``experts_*_rep`` stacks (replicated by
    ``ep_param_specs``; taken from the ORIGINAL ids).  Router / shared
    experts are untouched — routing stays in expert-id space."""
    if any(k.endswith("_rep") for k in p):
        raise ValueError("params already carry replica leaves; placement "
                         "must be applied to the original layout")
    if placement is None or placement.is_identity:
        return p
    out = dict(p)
    perm = np.asarray(placement.perm)
    rep = np.asarray(placement.replicated)
    for name in _MOE_LEAVES:
        out[name] = p[name][perm]
        if placement.replicated:
            out[name + "_rep"] = p[name][rep]
    return out


def placed_params(params, placements: Sequence[Optional[Placement]]):
    """Walk a model pytree and apply ``placements[i]`` to the i-th MoE
    param dict encountered (model layer order — the order ``dit_forward``
    visits blocks).  Non-MoE leaves pass through untouched."""
    placements = list(placements)
    seen = [0]

    def rec(node):
        if isinstance(node, dict):
            if all(k in node for k in _MOE_LEAVES):
                i = seen[0]
                seen[0] += 1
                if i >= len(placements):
                    raise ValueError(
                        f"model has more MoE layers than the "
                        f"{len(placements)} placements provided")
                return place_moe_params(node, placements[i])
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, list):
            return [rec(v) for v in node]
        if isinstance(node, tuple):
            return tuple(rec(v) for v in node)
        return node

    out = rec(params)
    if seen[0] != len(placements):
        raise ValueError(f"{len(placements)} placements provided but the "
                         f"model has {seen[0]} MoE layers")
    return out
