"""Staleness buffers: per-layer state that encodes asynchronous execution
(port of ``repro.core.staleness``).

The numerical effect of the paper's schedules is *which step's activations
each MoE layer consumes*, carried as per-layer state through the sampling
loop:

  SYNC         y(s) = MoE(x(s))                      state: {}
  DISPLACED    y(s) = MoE(x(s-2))                    state: {x_prev, y_buf}
  INTERWEAVED  y(s) = MoE(x(s-1))                    state: {y_buf}
  DICE         interweaved + deep layers sync + conditional-communication
               cache of per-(token, rank) expert outputs

:func:`apply_layer_action` is the sole executor of a planned
:class:`~repro_torch.core.plan.LayerAction`.  Like the reference it builds
a new state object each call and never writes a buffer in place.

Over a mesh every buffer holds the rank's token rows only, batch-major:
its lane's batch rows (``dp x ep``) and, on a patch axis, its patch's
tokens of each, as the reference's ``state_specs`` shard them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.core import conditional
from repro_torch.core.moe import MoEAux, moe_forward
from repro_torch.core.plan import LayerAction, plan_for_step
from repro_torch.obs import telemetry as obs_telemetry


@dataclass
class MoELayerState:
    """Per-MoE-layer staleness buffers."""
    y_buf: Optional[torch.Tensor] = None     # (T, d) combined output of step s-1
    x_prev: Optional[torch.Tensor] = None    # (T, d) displaced: step s-1 tokens
    h_cache: Optional[torch.Tensor] = None   # (T, K, d) conditional-comm cache
    c_base: Optional[torch.Tensor] = None    # (T, d) wire-codec residual base

    def bytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.y_buf, self.x_prev, self.h_cache, self.c_base)
                   if a is not None)


def init_layer_states(num_moe_layers: int) -> Dict[int, MoELayerState]:
    """One empty state a MoE layer (the synchronous schedule's)."""
    return {i: MoELayerState() for i in range(num_moe_layers)}


def flatten_state(s: MoELayerState) -> MoELayerState:
    """(B, T, ...) factored buffers -> flat (B*T, ...) rows, the shape
    :func:`apply_layer_action` computes in; batch-major, as the model
    forward's ``reshape(B * T, d)``."""
    def _f(a):
        return None if a is None else a.reshape((-1,) + tuple(a.shape[2:]))
    return MoELayerState(y_buf=_f(s.y_buf), x_prev=_f(s.x_prev),
                         h_cache=_f(s.h_cache), c_base=_f(s.c_base))


def unflatten_state(s: MoELayerState, b: int, t: int) -> MoELayerState:
    """Inverse of :func:`flatten_state`."""
    def _u(a):
        return None if a is None else a.reshape((b, t) + tuple(a.shape[1:]))
    return MoELayerState(y_buf=_u(s.y_buf), x_prev=_u(s.x_prev),
                         h_cache=_u(s.h_cache), c_base=_u(s.c_base))


def staleness_of(schedule) -> int:
    """Worst-case staleness of ``schedule`` (a ``Schedule`` or a registered
    name) at steady state, from its steady-state plan."""
    from repro_torch.core.plan import steady_state_plan
    return steady_state_plan(schedule).step_staleness


def init_planned_states(splan, *, num_tokens: int, d_model: int, k: int,
                        dtype=torch.float32,
                        device=None) -> Dict[int, MoELayerState]:
    """Pre-allocate exactly the buffers a SchedulePlan will ever write,
    zero-filled (a warmup step overwrites each before it is read).  Over
    an ep mesh ``num_tokens`` is the rank's token count."""
    states = {}
    num_layers = splan.steps[0].num_layers if splan.steps else 0

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    for i in range(num_layers):
        acts = [p.actions[i] for p in splan.variants]
        states[i] = MoELayerState(
            y_buf=zeros(num_tokens, d_model)
            if any(a.writes_y_buf for a in acts) else None,
            x_prev=zeros(num_tokens, d_model)
            if any(a.writes_x_prev for a in acts) else None,
            h_cache=zeros(num_tokens, k, d_model)
            if any(a.want_cache for a in acts) else None,
            c_base=zeros(num_tokens, d_model)
            if any(a.writes_c_base for a in acts) else None)
    return states


def state_bytes(states: Dict[int, MoELayerState]) -> int:
    return sum(s.bytes() for s in states.values())


def reset_slots(states: Dict[int, MoELayerState], slot_mask: torch.Tensor,
                *, tokens_per_slot: int) -> Dict[int, MoELayerState]:
    """Zero the staleness rows of recycled batch slots.

    ``slot_mask`` is a (B,) bool tensor marking slots handed to a new
    request (over an ep mesh, the rank's B / n slots); each slot owns
    ``tokens_per_slot`` consecutive token rows of every buffer.  A
    recycled slot then starts from the all-zeros planned state a fresh
    batch has, so no activation of the previous occupant reaches its
    successor.  Handles the flat ``(B * tokens_per_slot, ...)``
    layout and the factored ``(B, T, ...)`` one, whose leading dim is the
    slot dim.  Runs on the buffers' device without a host sync.
    """
    slot = torch.as_tensor(slot_mask, dtype=torch.bool)
    tok = slot[:, None].expand(-1, tokens_per_slot).reshape(-1)

    def _zero(buf):
        if buf is None:
            return None
        m = slot if buf.shape[0] == slot.shape[0] else tok
        m = m.to(buf.device).reshape((-1,) + (1,) * (buf.ndim - 1))
        return torch.where(m, torch.zeros_like(buf), buf)

    return {i: MoELayerState(y_buf=_zero(s.y_buf), x_prev=_zero(s.x_prev),
                             h_cache=_zero(s.h_cache), c_base=_zero(s.c_base))
            for i, s in states.items()}


def _cache_update_mask(mask, pair_keep):
    """Pairs whose cache entry may take the fresh value: transmitted fresh
    (mask) AND survived capacity (keep) — an overflowed pair gathers zeros,
    which must not poison h_cache."""
    if pair_keep is None:
        return mask
    if mask is None:
        return pair_keep
    return mask & pair_keep


def apply_layer_action(p, x: torch.Tensor, cfg, action: LayerAction,
                       state: MoELayerState, *,
                       generator: Optional[torch.Generator] = None,
                       slot_fresh: Optional[torch.Tensor] = None,
                       consume_mask: Optional[torch.Tensor] = None,
                       mesh=None, hop_schedule=None, obs=None,
                       resilience=None, layer_idx: int = 0,
                       fault_key: Optional[int] = None,
                       num_wire_experts: Optional[int] = None):
    """Execute one MoE layer under a planned :class:`LayerAction`.

    x: (T, d) flat tokens (the rank's shard over an ep ``mesh``, whose
    all-to-alls or ring, per ``action.overlap`` and in ``hop_schedule``'s
    order, :func:`moe_forward` runs; ``action.placement`` lays out its
    experts).  ``generator`` feeds the "random" conditional-communication
    policy; over a mesh the caller gives each rank its own (the reference
    folds the device index into the key), so each token shard draws its
    own mask.  ``slot_fresh`` (T,) / ``consume_mask`` (T, K)
    are the continuous engine's per-slot warmup replay: tokens of slots
    replaying warmup consume the fresh combine (sync semantics) instead of
    the staleness buffer, and ``consume_mask`` replaces the policy mask of
    a non-sync cached action (all-fresh rows for warmup slots, the local
    step's policy mask for established ones).  ``None`` for both is the
    uniform-batch path.  ``obs`` / ``resilience`` go down to
    :func:`moe_forward` with the layer index as the fault salt (and
    ``fault_key``); the action's staleness age is
    stamped into ``aux.telemetry``.  ``num_wire_experts`` is expert
    paging's padded wire (see :func:`moe_forward`).  Returns (y,
    new_state, aux)."""
    mask = None
    if action.mask_policy is not None:
        mask = conditional.policy_mask(action.mask_policy, x.shape[0],
                                       cfg.experts_per_token,
                                       device=x.device, generator=generator)
    if slot_fresh is not None and consume_mask is not None \
            and action.want_cache and action.mode != "sync":
        mask = consume_mask
    want_cache = action.want_cache

    def run(inp, m=None, cache=None):
        # capacity sized from THIS call's token count: light steps shrink
        # the buffer, staggered half-batch calls get half-batch buffers
        capacity = action.dispatch_capacity(inp.shape[0], cfg)
        return moe_forward(p, inp, cfg, capacity=capacity, fresh_mask=m,
                           h_cache=cache, want_pair_vals=want_cache,
                           codec=action.codec, dispatch_base=state.c_base,
                           mesh=mesh, overlap=action.overlap,
                           hop_schedule=hop_schedule,
                           placement=action.placement, obs=obs,
                           resilience=resilience, fault_salt=layer_idx,
                           fault_key=fault_key,
                           num_wire_experts=num_wire_experts)

    def stamped(aux):
        return obs_telemetry.stamp_age(aux, action, obs)

    def next_base(payload, aux):
        """Residual base for the next transmission: the decoded
        reconstruction on codec'd steps, the lossless payload on
        ``store_base`` steps, else unchanged."""
        if action.codec is not None:
            return aux.wire_payload
        if action.store_base:
            return payload
        return state.c_base

    def select_out(y_new, y_buf):
        """Consumed output: warmup-slot tokens take the fresh combine."""
        if slot_fresh is None:
            return y_buf
        return torch.where(slot_fresh[:, None], y_new, y_buf)

    if action.mode == "sync":
        y, aux = run(x)
        new = MoELayerState(
            y_buf=y if action.store_y else None,
            x_prev=x if action.store_x else None,
            h_cache=conditional.update_cache(
                state.h_cache, aux.pair_vals,
                _cache_update_mask(None, aux.pair_keep))
            if want_cache else None,
            c_base=next_base(x, aux))
        return y, new, stamped(aux)

    if action.mode == "displaced":
        # experts process the tokens buffered at s-1; the output consumed
        # now is the buffered result of x(s-2).  Warmup slots run sync:
        # their experts see x(s), and they consume it.
        inp = state.x_prev if slot_fresh is None else \
            torch.where(slot_fresh[:, None], x, state.x_prev)
        y_new, aux = run(inp)
        new = MoELayerState(y_buf=y_new, x_prev=x, h_cache=None,
                            c_base=next_base(inp, aux))
        return select_out(y_new, state.y_buf), new, stamped(aux)

    if action.mode == "staggered":
        # two half-batch MoE calls; both the dispatched tokens and the
        # combined results persist (2 buffers)
        half = x.shape[0] // 2
        y0, aux0 = run(x[:half])
        y1, aux1 = run(x[half:])
        y_new = torch.cat([y0, y1], dim=0)
        new = MoELayerState(y_buf=y_new, x_prev=x, h_cache=None,
                            c_base=state.c_base)
        aux = MoEAux(lb_loss=None if aux0.lb_loss is None
                     else (aux0.lb_loss + aux1.lb_loss) / 2,
                     dropped_frac=(aux0.dropped_frac + aux1.dropped_frac) / 2,
                     dispatch_bytes=aux0.dispatch_bytes + aux1.dispatch_bytes,
                     pair_vals=None, scores=None, pair_keep=None,
                     raw_dispatch_bytes=aux0.raw_dispatch_bytes
                     + aux1.raw_dispatch_bytes,
                     counts=aux0.counts + aux1.counts,
                     served_counts=aux0.served_counts + aux1.served_counts,
                     # two independent half-batch exchanges
                     hops=aux0.hops + aux1.hops, hop_bytes=aux0.hop_bytes,
                     lb_terms=None if aux0.lb_terms is None
                     else torch.cat([aux0.lb_terms, aux1.lb_terms]),
                     telemetry=obs_telemetry.merge_staggered(
                         aux0.telemetry, aux1.telemetry),
                     fault_events=None if aux0.fault_events is None
                     else aux0.fault_events + aux1.fault_events)
        return select_out(y_new, state.y_buf), new, stamped(aux)

    # "interweaved": dispatch of x(s) completes in step s, the combine is
    # deferred, so the output consumed now is the buffered result of x(s-1)
    y_new, aux = run(x, mask, state.h_cache if want_cache else None)
    new = MoELayerState(
        y_buf=y_new, x_prev=None,
        h_cache=conditional.update_cache(
            state.h_cache, aux.pair_vals,
            _cache_update_mask(mask, aux.pair_keep))
        if want_cache else None,
        c_base=next_base(x, aux))
    return select_out(y_new, state.y_buf), new, stamped(aux)


def moe_step(p, x: torch.Tensor, cfg, dcfg, state: MoELayerState, *,
             moe_layer_idx: int, num_moe_layers: int, step_idx: int,
             generator: Optional[torch.Generator] = None, mesh=None):
    """One MoE layer under a schedule, planned by step index: the
    registry shim over :func:`apply_layer_action` (the sampler compiles a
    SchedulePlan once instead).  Returns (y, new_state, aux)."""
    plan = plan_for_step(dcfg, num_moe_layers, step_idx,
                         experts_per_token=cfg.experts_per_token)
    return apply_layer_action(p, x, cfg, plan.actions[moe_layer_idx], state,
                              generator=generator, mesh=mesh)
