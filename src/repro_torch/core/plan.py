"""StepPlan engine: compile-once schedule planning (port of
``repro.core.plan``).

A registered planner maps ``(DiceConfig, num_moe_layers, step_idx, k)`` to
a hashable :class:`StepPlan` — one :class:`LayerAction` per MoE layer.
Only a handful of distinct plans exist in a sampling run (warmup-sync,
refresh, light, ...); ``compile_step_plans`` buckets the steps into those
variants.  The plans are pure Python and compare field-equal with the
reference's.

Adding a schedule is one registered function::

    @register_schedule("my_sched")
    def _plan(dcfg, num_moe_layers, step_idx, k):
        return StepPlan(schedule="my_sched", is_warmup=..., actions=...)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.compress.codecs import CodecSpec
from repro_torch.core import conditional
from repro_torch.core.moe import default_capacity
# normalize_paging is served from here, beside normalize_overlap and
# normalize_placement, as in the reference
from repro_torch.core.paging import (PagingSpec, normalize_paging,  # noqa: F401
                                     paging_of)
from repro_torch.core.placement import Placement
from repro_torch.core.selective import sync_layer_mask


# ---------------------------------------------------------------------------
# the plan IR
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LayerAction:
    """What one MoE layer does this step.  Hashable; fully static.

    mode
        "sync"         run MoE(x(s)), consume it immediately
        "displaced"    run MoE(x_prev buffer), consume y_buf  (staleness 2)
        "interweaved"  run MoE(x(s)), consume y_buf           (staleness 1)
        "staggered"    two half-batch MoE calls, consume y_buf (staleness 1)
    store_y / store_x
        persist the combined output / the dispatched tokens for a later step
    mask_policy
        Conditional-Communication mask: ``None`` transmits every pair fresh,
        else "low" | "high" | "random"
    effective_k
        ranks actually dispatched (sizes the capacity buffer); ``None`` is
        the model's full experts_per_token
    want_cache
        maintain the per-(token, rank) expert-output cache h_cache
    codec
        wire codec for this step's payloads; ``None`` is the lossless wire
    store_base
        refresh the residual base ``c_base`` from this step's lossless payload
    overlap
        run this step's dispatch/combine as the ring engine
        (:mod:`repro_torch.core.overlap`) instead of two all-to-alls; the
        samplers normalize it away where no ep mesh of more than one rank
        backs the run (:func:`normalize_overlap`)
    placement
        this layer's expert layout (:class:`~repro_torch.core.placement.Placement`):
        the dispatch buffer's expert order, the replicas served locally
        off the wire, and the capacity scale.  The expert params must be
        laid out to match (:func:`repro_torch.common.sharding.place_experts`).
        An identity placement normalizes to ``None``.
    paging / prefetch / resident
        expert paging (:mod:`repro_torch.core.paging`): with a
        :class:`~repro_torch.core.paging.PagingSpec` stamped, this layer's
        routed-expert shards come from the host pool instead of the params.
        ``prefetch`` is the MoE layer whose shards this layer fetches ahead
        (``i + depth``, ``None`` at the tail) and ``resident`` the planned
        residency window the budget is validated against.  Without a spec
        both normalize to ``None``, so unpaged plans equal the historical
        ones; paging and a placement on one layer raise.
    """
    mode: str = "sync"
    store_y: bool = False
    store_x: bool = False
    mask_policy: Optional[str] = None
    effective_k: Optional[int] = None
    want_cache: bool = False
    codec: Optional[CodecSpec] = None
    store_base: bool = False
    overlap: bool = False
    placement: Optional[Placement] = None
    paging: Optional[PagingSpec] = None
    prefetch: Optional[int] = None
    resident: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.mode not in ("sync", "displaced", "interweaved", "staggered"):
            raise ValueError(f"unknown LayerAction mode: {self.mode}")
        if self.codec is not None and self.codec.kind == "none":
            object.__setattr__(self, "codec", None)
        if self.codec is not None and self.mode == "staggered":
            raise ValueError("staggered mode does not support a wire codec "
                             "(half-batch payloads have no per-batch "
                             "residual base)")
        if self.placement is not None and self.placement.is_identity:
            object.__setattr__(self, "placement", None)
        if self.paging is None:
            object.__setattr__(self, "prefetch", None)
            object.__setattr__(self, "resident", None)
        else:
            if self.placement is not None:
                raise ValueError(
                    "expert paging and affinity placement are mutually "
                    "exclusive on one layer: the pool serves shards in the "
                    "canonical expert order, a placement permutes them "
                    "(page OR place, not both)")
            if self.resident is not None:
                object.__setattr__(self, "resident",
                                   tuple(int(i) for i in self.resident))

    # -- buffer read/write accounting ----------------------------------------
    @property
    def reads_y_buf(self) -> bool:
        return self.mode in ("displaced", "interweaved", "staggered")

    @property
    def reads_x_prev(self) -> bool:
        return self.mode == "displaced"

    @property
    def writes_y_buf(self) -> bool:
        return self.store_y or self.mode != "sync"

    @property
    def writes_x_prev(self) -> bool:
        return self.store_x or self.mode in ("displaced", "staggered")

    @property
    def writes_c_base(self) -> bool:
        return self.codec is not None or self.store_base

    @property
    def num_buffers(self) -> int:
        return (int(self.writes_y_buf) + int(self.writes_x_prev)
                + int(self.writes_c_base))

    @property
    def staleness(self) -> int:
        return {"sync": 0, "interweaved": 1, "staggered": 1,
                "displaced": 2}[self.mode]

    # -- buffer sizing ---------------------------------------------------------
    def dispatch_capacity(self, num_local_tokens: int, cfg) -> int:
        """Per-expert dispatch-buffer capacity, sized from the tokens of
        this call (a rank's shard over an ep mesh): a Conditional-
        Communication light step (``effective_k < K``) genuinely shrinks
        the buffer, and a placement with replicas scales it by its
        ``cap_scale``."""
        cap = default_capacity(num_local_tokens, cfg, k=self.effective_k)
        if self.placement is not None:
            cap = self.placement.scaled_capacity(cap)
        return cap

    def dispatch_bytes(self, num_local_tokens: int, cfg, *,
                       itemsize: int = 4) -> int:
        """One-way dispatch payload under this action, as it goes on the
        wire (codec rows cost ``CodecSpec.wire_bytes_per_row``)."""
        cap = self.dispatch_capacity(num_local_tokens, cfg)
        per_row = (self.codec.wire_bytes_per_row(cfg.d_model, itemsize)
                   if self.codec is not None else cfg.d_model * itemsize)
        return cfg.num_experts * cap * per_row

    def raw_dispatch_bytes(self, num_local_tokens: int, cfg, *,
                           itemsize: int = 4) -> int:
        return (cfg.num_experts
                * self.dispatch_capacity(num_local_tokens, cfg)
                * cfg.d_model * itemsize)


@dataclass(frozen=True)
class StepPlan:
    """Per-layer actions for one diffusion step.  Hashable; equal plans are
    one variant."""
    schedule: str
    is_warmup: bool
    actions: Tuple[LayerAction, ...]

    @property
    def num_layers(self) -> int:
        return len(self.actions)

    @property
    def step_staleness(self) -> int:
        return max((a.staleness for a in self.actions), default=0)

    @property
    def num_buffers(self) -> int:
        return max((a.num_buffers for a in self.actions), default=0)

    @property
    def num_sync_layers(self) -> int:
        return sum(a.mode == "sync" for a in self.actions)


@dataclass(frozen=True)
class SchedulePlan:
    """All steps of a sampling run, pre-bucketed into plan variants."""
    steps: Tuple[StepPlan, ...]
    variants: Tuple[StepPlan, ...]          # unique plans, first-seen order
    variant_of_step: Tuple[int, ...]        # step -> index into variants

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    @property
    def num_variants(self) -> int:
        return len(self.variants)

    def steps_of_variant(self, v: int) -> List[int]:
        return [s for s, i in enumerate(self.variant_of_step) if i == v]


# ---------------------------------------------------------------------------
# schedule registry
# ---------------------------------------------------------------------------
Planner = Callable[..., StepPlan]

_REGISTRY: Dict[str, Planner] = {}


def schedule_name(schedule) -> str:
    """Accept a Schedule enum member or a plain registered name."""
    return getattr(schedule, "value", str(schedule))


def register_schedule(name: str, planner_fn: Optional[Planner] = None):
    """Register ``planner_fn`` under ``name``; usable as a decorator."""
    def _register(fn: Planner) -> Planner:
        _REGISTRY[name] = fn
        return fn
    if planner_fn is not None:
        return _register(planner_fn)
    return _register


def registered_schedules() -> List[str]:
    """The names of every registered planner, sorted."""
    return sorted(_REGISTRY)


def get_planner(schedule) -> Planner:
    name = schedule_name(schedule)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no planner registered for schedule {name!r}; known: "
            f"{sorted(_REGISTRY)}") from None


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------
def overlap_of(dcfg) -> bool:
    return getattr(dcfg, "overlap", "blocking") == "ring"


def normalize_overlap(dcfg, n_dev: int):
    """Strip ``overlap="ring"`` when no ep mesh of more than one rank backs
    the run (``n_dev`` is its size, 1 without a mesh): on one rank the
    ring is the blocking exchange, and plans stay equal to a blocking
    config's.  ``n_dev > 1`` keeps the ring."""
    if n_dev > 1 or not overlap_of(dcfg):
        return dcfg
    return dataclasses.replace(dcfg, overlap="blocking")


def normalize_hop_schedule(hop_schedule, n_dev: int):
    """Canonicalize a ring hop order against the ep size: a permutation of
    ``1 .. n_dev - 1`` (else ``ValueError``), with the natural order and
    anything on one rank normalized to ``None``."""
    if hop_schedule is None or n_dev <= 1:
        return None
    sched = tuple(int(h) for h in hop_schedule)
    if sorted(sched) != list(range(1, n_dev)):
        raise ValueError(
            f"hop_schedule {sched} is not a permutation of 1..{n_dev - 1}")
    if sched == tuple(range(1, n_dev)):
        return None
    return sched


def placements_of(dcfg) -> Optional[Tuple[Optional[Placement], ...]]:
    """The per-layer expert placements of ``dcfg``, or None."""
    return getattr(dcfg, "placements", None)


def normalize_placement(dcfg, n_dev: int):
    """Strip ``dcfg.placements`` when no ep mesh of more than one rank
    backs the run (``n_dev`` its ep size, 1 without one): there every
    expert is local, the params stay in their original layout, and plans
    stay equal to an unplaced config's."""
    if n_dev > 1 or placements_of(dcfg) is None:
        return dcfg
    return dataclasses.replace(dcfg, placements=None)


def placement_wire_scale(dcfg) -> float:
    """Mean planned capacity scale over layers (1.0 without placements),
    by which expert placement shrinks every capacity-sized wire payload;
    the serving latency model scales its all-to-all volume by it."""
    placements = placements_of(dcfg)
    if not placements:
        return 1.0
    return sum(p.cap_scale if p is not None else 1.0
               for p in placements) / len(placements)


def codec_spec_of(dcfg) -> Optional[CodecSpec]:
    compress = getattr(dcfg, "compress", None)
    return compress.spec() if compress is not None else None


def plan_for_step(dcfg, num_moe_layers: int, step_idx: int, *,
                  experts_per_token: int) -> StepPlan:
    """One step's plan via the registered planner for ``dcfg.schedule``;
    a ring-overlap config stamps ``overlap`` on every action, a
    ``dcfg.placements`` tuple each layer's placement (identity entries
    normalize back to ``None``), and a ``dcfg.paging`` spec each layer's
    paging, prefetch (``i + depth`` while ``< L``) and residency window
    (``i .. i + depth``)."""
    planner = get_planner(dcfg.schedule)
    plan = planner(dcfg, num_moe_layers, step_idx, experts_per_token)
    if overlap_of(dcfg) and not all(a.overlap for a in plan.actions):
        plan = dataclasses.replace(plan, actions=tuple(
            dataclasses.replace(a, overlap=True) for a in plan.actions))
    placements = placements_of(dcfg)
    if placements is not None:
        if len(placements) != len(plan.actions):
            raise ValueError(
                f"dcfg.placements has {len(placements)} entries for "
                f"{len(plan.actions)} MoE layers")
        plan = dataclasses.replace(plan, actions=tuple(
            dataclasses.replace(a, placement=pl)
            for a, pl in zip(plan.actions, placements)))
    pspec = paging_of(dcfg)
    if pspec is not None:
        if placements is not None:
            raise ValueError(
                "dcfg.paging and dcfg.placements are mutually exclusive: "
                "the pool serves shards in the canonical expert order, a "
                "placement permutes them")
        L = len(plan.actions)
        plan = dataclasses.replace(plan, actions=tuple(
            dataclasses.replace(
                a, paging=pspec,
                prefetch=(i + pspec.depth) if i + pspec.depth < L else None,
                resident=tuple(range(i, min(i + pspec.depth + 1, L))))
            for i, a in enumerate(plan.actions)))
    return plan


def compile_step_plans(dcfg, num_moe_layers: int, num_steps: int, *,
                       experts_per_token: int) -> SchedulePlan:
    """Precompute every step's plan and bucket steps into variants, e.g.
    DICE (stride=2, warmup=2) yields 3: warmup-sync, refresh, light."""
    steps = tuple(plan_for_step(dcfg, num_moe_layers, s,
                                experts_per_token=experts_per_token)
                  for s in range(num_steps))
    variants: List[StepPlan] = []
    index: Dict[StepPlan, int] = {}
    variant_of_step = []
    for p in steps:
        if p not in index:
            index[p] = len(variants)
            variants.append(p)
        variant_of_step.append(index[p])
    return SchedulePlan(steps=steps, variants=tuple(variants),
                        variant_of_step=tuple(variant_of_step))


# ---------------------------------------------------------------------------
# built-in planners (the paper's schedules, Fig. 2 + supplement Sec. 8)
# ---------------------------------------------------------------------------
def _uniform(action: LayerAction, n: int) -> Tuple[LayerAction, ...]:
    return (action,) * n


def _plan_sync(dcfg, num_moe_layers, step_idx, k) -> StepPlan:
    """Baseline EP: blocking dispatch+combine, no persistent buffers."""
    return StepPlan(schedule="sync", is_warmup=step_idx < dcfg.warmup_steps,
                    actions=_uniform(LayerAction(mode="sync"), num_moe_layers))


def _plan_displaced(dcfg, num_moe_layers, step_idx, k) -> StepPlan:
    """DistriFusion-style: both collectives deferred, 2-step staleness."""
    cspec = codec_spec_of(dcfg)
    if step_idx < dcfg.warmup_steps:
        a = LayerAction(mode="sync", store_y=True, store_x=True,
                        store_base=cspec is not None)
        return StepPlan(schedule="displaced", is_warmup=True,
                        actions=_uniform(a, num_moe_layers))
    refresh = conditional.is_refresh_step(step_idx, dcfg.cond_stride)
    a = LayerAction(mode="displaced",
                    codec=None if refresh else cspec,
                    store_base=cspec is not None and refresh)
    return StepPlan(schedule="displaced", is_warmup=False,
                    actions=_uniform(a, num_moe_layers))


def _plan_interweaved(dcfg, num_moe_layers, step_idx, k) -> StepPlan:
    """Dispatch in-step, combine deferred: 1-step staleness, 1 buffer."""
    cspec = codec_spec_of(dcfg)
    if step_idx < dcfg.warmup_steps:
        a = LayerAction(mode="sync", store_y=True,
                        store_base=cspec is not None)
        return StepPlan(schedule="interweaved", is_warmup=True,
                        actions=_uniform(a, num_moe_layers))
    refresh = conditional.is_refresh_step(step_idx, dcfg.cond_stride)
    a = LayerAction(mode="interweaved",
                    codec=None if refresh else cspec,
                    store_base=cspec is not None and refresh)
    return StepPlan(schedule="interweaved", is_warmup=False,
                    actions=_uniform(a, num_moe_layers))


def _plan_staggered_batch(dcfg, num_moe_layers, step_idx, k) -> StepPlan:
    """Supplement Sec. 8: the rejected alternative — 1-step staleness but
    2 persistent buffers and halved effective GEMM batch."""
    if step_idx < dcfg.warmup_steps:
        a = LayerAction(mode="sync", store_y=True, store_x=True)
        return StepPlan(schedule="staggered_batch", is_warmup=True,
                        actions=_uniform(a, num_moe_layers))
    return StepPlan(schedule="staggered_batch", is_warmup=False,
                    actions=_uniform(LayerAction(mode="staggered"),
                                     num_moe_layers))


def _plan_dice(dcfg, num_moe_layers, step_idx, k) -> StepPlan:
    """Interweaved + selective sync (deep layers) + conditional comm; with a
    codec the async layers' light steps also compress their payloads."""
    warmup = step_idx < dcfg.warmup_steps
    sync_mask = sync_layer_mask(dcfg.sync_policy, num_moe_layers,
                                fraction=dcfg.sync_fraction)
    want_cache = bool(dcfg.cond_comm)
    refresh = conditional.is_refresh_step(step_idx, dcfg.cond_stride)
    cspec = codec_spec_of(dcfg)
    actions = []
    for i in range(num_moe_layers):
        wants_codec = cspec is not None and not bool(sync_mask[i])
        if warmup or bool(sync_mask[i]):
            actions.append(LayerAction(mode="sync", store_y=True,
                                       want_cache=want_cache,
                                       store_base=wants_codec))
        elif dcfg.cond_comm:
            actions.append(LayerAction(
                mode="interweaved",
                mask_policy=None if refresh else dcfg.cond_policy,
                effective_k=k if refresh
                else conditional.policy_effective_k(dcfg.cond_policy, k),
                want_cache=True,
                codec=None if refresh else cspec,
                store_base=wants_codec and refresh))
        else:
            actions.append(LayerAction(
                mode="interweaved",
                codec=None if refresh else cspec,
                store_base=wants_codec and refresh))
    return StepPlan(schedule="dice", is_warmup=warmup,
                    actions=tuple(actions))


register_schedule("sync", _plan_sync)
register_schedule("displaced", _plan_displaced)
register_schedule("interweaved", _plan_interweaved)
register_schedule("staggered_batch", _plan_staggered_batch)
register_schedule("dice", _plan_dice)


# ---------------------------------------------------------------------------
# steady-state probe
# ---------------------------------------------------------------------------
def steady_state_plan(schedule, *, num_moe_layers: int = 2,
                      experts_per_token: int = 2) -> StepPlan:
    """A representative post-warmup refresh-step plan for ``schedule`` with
    its default DiceConfig: the source of the schedule-level staleness and
    buffer counts the paper tabulates."""
    from repro_torch.core.schedules import DiceConfig
    factories = {
        "sync": DiceConfig.sync_ep,
        "displaced": DiceConfig.displaced,
        "interweaved": DiceConfig.interweaved,
        "dice": DiceConfig.dice,
        "staggered_batch": DiceConfig.staggered_batch,
    }
    name = schedule_name(schedule)
    dcfg = factories[name]() if name in factories else DiceConfig(schedule=name)
    return steady_state_plan_for(dcfg, num_moe_layers,
                                 experts_per_token=experts_per_token)


def steady_state_plan_for(dcfg, num_moe_layers: int, *,
                          experts_per_token: int) -> StepPlan:
    """The plan of the first post-warmup refresh step under ``dcfg``: what
    the latency model treats as the schedule's characteristic step."""
    step = dcfg.warmup_steps
    while not conditional.is_refresh_step(step, dcfg.cond_stride):
        step += 1
    return plan_for_step(dcfg, num_moe_layers, step,
                         experts_per_token=experts_per_token)


# ---------------------------------------------------------------------------
# continuous batching: per-slot warmup support
# ---------------------------------------------------------------------------
def steady_period(dcfg, num_moe_layers: int, *, experts_per_token: int,
                  max_period: int = 8) -> int:
    """Period of the post-warmup plan sequence: 1 for sync, and for
    displaced / interweaved without a codec; ``cond_stride`` for DICE's
    refresh/light alternation and for any codec'd schedule.

    The continuous engine admits requests only at ticks
    ``g % steady_period == 0``, so every established slot is at the same
    point of the steady-state cycle and the batch shares one plan a tick.
    """
    w = dcfg.warmup_steps
    probe = [plan_for_step(dcfg, num_moe_layers, w + i,
                           experts_per_token=experts_per_token)
             for i in range(2 * max_period)]
    for p in range(1, max_period + 1):
        if all(probe[i] == probe[i + p] for i in range(len(probe) - p)):
            return p
    raise ValueError(
        f"schedule {schedule_name(dcfg.schedule)!r} has no steady-state "
        f"period <= {max_period}; continuous batching cannot align "
        f"admissions")


def slotted_merge_plan(dcfg, num_moe_layers: int, *,
                       experts_per_token: int) -> StepPlan:
    """The plan a mixed warmup/steady tick runs under per-slot selectors.

    A recycled slot replays the warmup prefix (sync steps, full dispatch)
    while established slots go on in steady state.  The tick runs the
    steady-state full-dispatch plan (the refresh variant, already in the
    SchedulePlan) and resolves the per-slot difference with tensors:
    ``slot_fresh`` (tokens,) makes warmup-slot tokens consume the fresh
    combine instead of ``y_buf``, and ``consume_mask`` (tokens, K) is
    all-fresh on warmup rows and the local step's conditional-
    communication mask on established rows.  So every warmup mixture
    shares one step key, (this plan, slotted=True).
    """
    return steady_state_plan_for(dcfg, num_moe_layers,
                                 experts_per_token=experts_per_token)
