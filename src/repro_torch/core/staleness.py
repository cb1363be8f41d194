"""Staleness buffers: per-layer state that encodes asynchronous execution
(port of ``repro.core.staleness``, single device).

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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.core import conditional
from repro_torch.core.moe import MoEAux, moe_forward
from repro_torch.core.plan import LayerAction


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


def init_planned_states(splan, *, num_tokens: int, d_model: int, k: int,
                        dtype=torch.float32,
                        device=None) -> Dict[int, MoELayerState]:
    """Pre-allocate exactly the buffers a SchedulePlan will ever write,
    zero-filled (a warmup step overwrites each before it is read)."""
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
                       generator: Optional[torch.Generator] = None):
    """Execute one MoE layer under a planned :class:`LayerAction`.

    x: (T, d) flat tokens.  ``generator`` feeds the "random" conditional-
    communication policy.  Returns (y, new_state, aux)."""
    mask = None
    if action.mask_policy is not None:
        mask = conditional.policy_mask(action.mask_policy, x.shape[0],
                                       cfg.experts_per_token,
                                       device=x.device, generator=generator)
    want_cache = action.want_cache

    def run(inp, m=None, cache=None):
        # capacity sized from THIS call's token count: light steps shrink
        # the buffer, staggered half-batch calls get half-batch buffers
        capacity = action.dispatch_capacity(inp.shape[0], cfg)
        return moe_forward(p, inp, cfg, capacity=capacity, fresh_mask=m,
                           h_cache=cache, want_pair_vals=want_cache,
                           codec=action.codec, dispatch_base=state.c_base)

    def next_base(payload, aux):
        """Residual base for the next transmission: the decoded
        reconstruction on codec'd steps, the lossless payload on
        ``store_base`` steps, else unchanged."""
        if action.codec is not None:
            return aux.wire_payload
        if action.store_base:
            return payload
        return state.c_base

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
        return y, new, aux

    if action.mode == "displaced":
        # experts process the tokens buffered at s-1; the output consumed
        # now is the buffered result of x(s-2)
        y_new, aux = run(state.x_prev)
        new = MoELayerState(y_buf=y_new, x_prev=x, h_cache=None,
                            c_base=next_base(state.x_prev, aux))
        return state.y_buf, new, aux

    if action.mode == "staggered":
        # two half-batch MoE calls; both the dispatched tokens and the
        # combined results persist (2 buffers)
        half = x.shape[0] // 2
        y0, aux0 = run(x[:half])
        y1, aux1 = run(x[half:])
        y_new = torch.cat([y0, y1], dim=0)
        new = MoELayerState(y_buf=y_new, x_prev=x, h_cache=None,
                            c_base=state.c_base)
        aux = MoEAux(lb_loss=(aux0.lb_loss + aux1.lb_loss) / 2,
                     dropped_frac=(aux0.dropped_frac + aux1.dropped_frac) / 2,
                     dispatch_bytes=aux0.dispatch_bytes + aux1.dispatch_bytes,
                     pair_vals=None, scores=None, pair_keep=None,
                     raw_dispatch_bytes=aux0.raw_dispatch_bytes
                     + aux1.raw_dispatch_bytes,
                     counts=aux0.counts + aux1.counts,
                     served_counts=aux0.served_counts + aux1.served_counts)
        return state.y_buf, new, aux

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
    return state.y_buf, new, aux
