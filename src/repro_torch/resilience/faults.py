"""Deterministic fault injection and resilience configuration (port of
``repro.resilience.faults``).

The DICE pipeline already tolerates *outdated* activations: the staleness
cache and the residual-codec base are sources of slightly-old-but-valid
data.  The resilience layer wires them up as degradation paths: a
corrupted wire payload or an overloaded admission queue is absorbed as
"one more stale step" instead of an engine crash.

* ``FaultConfig``: seeded injection rates.  Off (``None`` / all-zero)
  means the serving path is the one without faults, bit for bit.
* ``ResilienceConfig``: the degradation ladder: wire guards, demotion
  thresholds, admission bounds, quarantine.  It rides on
  ``DiceConfig.resilience``.

``FaultPlan`` is the host-side roll engine: every decision is a pure
function of ``(seed, site, *coordinates)`` through sha256, with the
reference's values, so a chaos run replays from its seed alone.

The in-graph corruption masks cannot replay ``jax.random.bernoulli``: the
port draws them from a ``torch.Generator`` on the payload's device, seeded
through ``rectified_flow.fold_seed`` from ``(seed, site, layer)`` and a
per-pass ``fault_key`` (:func:`fault_key`: tick, CFG pass, rank).
``moe_forward`` also takes the masks as inputs, so the reference's masks
can be replayed.

The paging rungs (fetch errors and delays, retries with backoff under a
deadline, the stale fallback) are served by
:meth:`repro_torch.core.paging.ExpertPool.fetch`, which rolls them per
``(layer, dev, fetch-seq, attempt)`` as the reference does.
"""
import dataclasses
import hashlib
from typing import List, Optional

import torch

# indices into the (NUM_FAULT_EVENTS,) fault-event vector accumulated
# in-graph by moe_forward and summed over layers/shards by dit_forward
FE_CORRUPT_COMBINE = 0   # combine-direction pair rows corrupted (injected)
FE_GUARDED_COMBINE = 1   # combine-direction pair rows caught by the guard
FE_CORRUPT_DISPATCH = 2  # dispatch-direction token rows corrupted (injected)
FE_GUARDED_DISPATCH = 3  # dispatch-direction token rows caught by the guard
NUM_FAULT_EVENTS = 4


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Seeded fault-injection rates.  Plan-static and hashable; all-zero
    (or ``None`` on the ``ResilienceConfig``) injects nothing."""

    seed: int = 0
    # host-side paging faults, rolled per (layer, dev, fetch-seq, attempt)
    paging_error_rate: float = 0.0
    paging_delay_rate: float = 0.0
    paging_delay_s: float = 0.0
    # in-graph NaN corruption of wire payloads, drawn from the traced key
    corrupt_combine_rate: float = 0.0
    corrupt_dispatch_rate: float = 0.0
    # host-side slow ring hop: sleep injected into the engine tick while a
    # ring engine is live (the watchdog observes the walltime breach)
    hop_delay_rate: float = 0.0
    hop_delay_s: float = 0.0
    # one-shot slot poisoning at this engine tick (-1 = never): models
    # corruption that escaped the wire guards and exercises quarantine
    poison_tick: int = -1
    # checkpoint chunk truncation, rolled per (leaf, chunk)
    checkpoint_truncate_rate: float = 0.0
    # arrival bursts: benches group arrivals into simultaneous bursts of
    # this size (0 = smooth arrivals)
    burst_size: int = 0

    @property
    def enabled(self) -> bool:
        return (self.paging_error_rate > 0 or self.paging_delay_rate > 0
                or self.corrupt_combine_rate > 0
                or self.corrupt_dispatch_rate > 0
                or self.hop_delay_rate > 0 or self.poison_tick >= 0
                or self.checkpoint_truncate_rate > 0 or self.burst_size > 0)


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Degradation-ladder policy (DESIGN.md §17).  Hashable and carried on
    ``DiceConfig.resilience``; ``None`` there means the serving stack runs
    exactly the pre-resilience graphs (byte-identical)."""

    faults: Optional[FaultConfig] = None
    # rung 2: NaN/Inf wire guards — corrupted combine payloads fall back to
    # h_cache (the cond-comm masked-pair path), dispatch payloads to c_base
    guards: bool = True
    # rung 1: paging fetch retry-with-backoff under a deadline, then serve
    # the still-resident stale shard instead of crashing the engine
    paging_retries: int = 2
    paging_backoff_s: float = 5e-4
    paging_deadline_s: float = 0.25
    stale_fallback: bool = True
    # rung 3: variant demotion after this many consecutive anomalies
    demote_after: int = 3
    step_deadline_factor: float = 8.0   # watchdog: deadline = factor x baseline
    step_deadline_s: float = 0.0        # absolute deadline floor (0 = factor only)
    codec_error_limit: float = 0.0      # mean CODEC_ERR above this = codec anomaly
    # rung 4/5: quarantine + bounded admission
    quarantine: bool = True
    max_requeues: int = 2
    max_queue_depth: int = 0            # 0 = unbounded (legacy behavior)
    admission_deadline_steps: int = 0   # 0 = no admission deadline


def resilience_of(dcfg) -> Optional[ResilienceConfig]:
    """The resilience policy stamped on a DiceConfig, or None.  Reads via
    getattr so pre-resilience configs (and plain test doubles) pass."""
    return getattr(dcfg, "resilience", None)


def normalize_resilience(
        res: Optional[ResilienceConfig]) -> Optional[ResilienceConfig]:
    """Strip inert configs so "resilience off" is structurally ``None``
    (the path without it, bit for bit)."""
    if res is None:
        return None
    if res.faults is not None and not res.faults.enabled:
        res = dataclasses.replace(res, faults=None)
    inert = (res.faults is None and not res.guards and not res.quarantine
             and res.max_queue_depth <= 0
             and res.admission_deadline_steps <= 0
             and res.codec_error_limit <= 0 and res.step_deadline_s <= 0)
    return None if inert else res


# ---------------------------------------------------------------------------
# host-side deterministic rolls
# ---------------------------------------------------------------------------
def _roll(seed: int, *parts) -> float:
    """Uniform [0, 1) as a pure function of (seed, *parts) — hash-based so
    chaos runs replay exactly from the seed (no RNG state, no clock).
    sha256, not crc32: crc's GF(2)-linearity makes rolls at adjacent
    coordinates (e.g. retry attempts 0 and 1) perfectly correlated, which
    would make retries useless against injected fetch errors."""
    h = hashlib.sha256(
        repr(("dice-fault", int(seed)) + parts).encode("utf-8")).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


class FaultPlan:
    """Host-side decision engine for a seeded :class:`FaultConfig`.

    Every method is deterministic in its arguments; the same seed and the
    same sequence of coordinates reproduce the same fault schedule."""

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg

    def roll(self, *parts) -> float:
        return _roll(self.cfg.seed, *parts)

    def paging_error(self, layer: int, dev: int, seq: int,
                     attempt: int) -> bool:
        r = self.cfg.paging_error_rate
        return r > 0 and self.roll("paging_err", layer, dev, seq, attempt) < r

    def paging_delay(self, layer: int, dev: int, seq: int,
                     attempt: int) -> bool:
        r = self.cfg.paging_delay_rate
        return r > 0 and self.roll("paging_delay", layer, dev, seq,
                                   attempt) < r

    def hop_delay(self, tick: int) -> bool:
        r = self.cfg.hop_delay_rate
        return r > 0 and self.roll("hop_delay", tick) < r

    def poison(self, tick: int) -> bool:
        return self.cfg.poison_tick >= 0 and tick == self.cfg.poison_tick

    def truncate_chunk(self, leaf: int, chunk: int, payload: bytes) -> bytes:
        """Checkpoint read-truncation injection: deterministically drop the
        tail of a chunk payload (at least one byte) when the roll hits."""
        r = self.cfg.checkpoint_truncate_rate
        if r <= 0 or self.roll("ckpt_trunc", leaf, chunk) >= r:
            return payload
        keep = int(len(payload) * self.roll("ckpt_keep", leaf, chunk))
        return payload[:min(keep, max(len(payload) - 1, 0))]


# ---------------------------------------------------------------------------
# corruption masks
# ---------------------------------------------------------------------------
def fault_key(tick: int, pass_: int = 0, rank: Optional[int] = None) -> int:
    """The per-pass coordinate of the corruption masks: the engine tick
    (the step of a fixed batch), the CFG pass (0 conditional, 1 null
    class) and, over an ep mesh, the rank, so each token shard draws its
    own mask, as the reference folds the step key per device."""
    from repro_torch.sampling.rectified_flow import fold_seed
    k = fold_seed(int(tick), int(pass_))
    return k if rank is None else fold_seed(k, int(rank))


def corruption_mask(key: Optional[int], seed: int, salt: int, site: int,
                    rate: float, shape, device=None) -> torch.Tensor:
    """Bernoulli(``rate``) bool mask on ``device``, drawn from a generator
    seeded from ``(seed, site, salt)`` (salt: the layer index) and the
    pass's ``key`` (:func:`fault_key`; None: the seed alone)."""
    from repro_torch.sampling.rectified_flow import fold_seed
    s = fold_seed(fold_seed(int(seed), int(site)), int(salt))
    if key is not None:
        s = fold_seed(s, int(key))
    device = torch.device("cpu") if device is None else torch.device(device)
    gen = torch.Generator(device=device).manual_seed(s)
    return torch.rand(tuple(shape), generator=gen, device=device) < rate


def corrupt_rows(payload: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """NaN-poison the rows of ``payload`` selected by ``mask`` (one bool per
    leading row, broadcast over the trailing feature axis)."""
    bad = torch.full((), float("nan"), dtype=payload.dtype,
                     device=payload.device)
    return torch.where(mask[..., None], bad, payload)


# ---------------------------------------------------------------------------
# arrival bursts + CLI spec parsing
# ---------------------------------------------------------------------------
def bursty_arrivals(n: int, rate: float, burst_size: int,
                    start: float = 0.0) -> List[float]:
    """Arrival ticks where requests land in simultaneous bursts of
    ``burst_size``, spaced so the long-run rate still matches ``rate``
    requests/step.  ``burst_size <= 1`` degrades to smooth 1/rate spacing."""
    b = max(int(burst_size), 1)
    gap = (b if b > 1 else 1) / max(rate, 1e-9)
    if b == 1:
        return [start + i * gap for i in range(n)]
    return [start + (i // b) * gap for i in range(n)]


_FAULT_KEYS = {
    "seed": ("seed", int),
    "paging_err": ("paging_error_rate", float),
    "corrupt": ("corrupt_combine_rate", float),
    "corrupt_dispatch": ("corrupt_dispatch_rate", float),
    "poison_tick": ("poison_tick", int),
    "ckpt_trunc": ("checkpoint_truncate_rate", float),
    "burst": ("burst_size", int),
}
_RES_KEYS = {
    "guards": ("guards", lambda v: bool(int(v))),
    "quarantine": ("quarantine", lambda v: bool(int(v))),
    "stale_fallback": ("stale_fallback", lambda v: bool(int(v))),
    "retries": ("paging_retries", int),
    "backoff": ("paging_backoff_s", float),
    "fetch_deadline": ("paging_deadline_s", float),
    "demote_after": ("demote_after", int),
    "step_deadline_factor": ("step_deadline_factor", float),
    "step_deadline": ("step_deadline_s", float),
    "codec_err_limit": ("codec_error_limit", float),
    "queue": ("max_queue_depth", int),
    "admit_deadline": ("admission_deadline_steps", int),
    "requeues": ("max_requeues", int),
}


def parse_resilience(spec: Optional[str]) -> Optional[ResilienceConfig]:
    """Parse a ``--faults`` CLI spec into a :class:`ResilienceConfig`.

    Comma-separated ``key=value`` pairs, e.g.::

        seed=7,corrupt=0.05,paging_err=0.3,hop_delay=0.5:0.01,queue=16

    ``hop_delay`` / ``paging_delay`` take ``rate:seconds``.  ``off`` /
    empty returns None (resilience entirely disabled)."""
    if spec is None or spec.strip() in ("", "off", "none"):
        return None
    faults: dict = {}
    res: dict = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(f"--faults item {item!r} is not key=value")
        k, v = item.split("=", 1)
        k = k.strip()
        v = v.strip()
        if k == "hop_delay" or k == "paging_delay":
            rate, _, secs = v.partition(":")
            faults[f"{k}_rate"] = float(rate)
            if secs:
                faults[f"{k}_s"] = float(secs)
        elif k in _FAULT_KEYS:
            field, conv = _FAULT_KEYS[k]
            faults[field] = conv(v)
        elif k in _RES_KEYS:
            field, conv = _RES_KEYS[k]
            res[field] = conv(v)
        else:
            raise ValueError(
                f"unknown --faults key {k!r} (known: "
                f"{sorted(_FAULT_KEYS) + sorted(_RES_KEYS) + ['hop_delay', 'paging_delay']})")
    fcfg = FaultConfig(**faults) if faults else None
    if fcfg is not None and not fcfg.enabled:
        fcfg = None
    return ResilienceConfig(faults=fcfg, **res)
