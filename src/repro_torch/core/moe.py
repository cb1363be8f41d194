"""Capacity-based Mixture-of-Experts, single device (port of
``repro.core.moe``).

The dispatch path is sort-based, never materialising (T, E, C) one-hots:

  1. top-k routing -> (token, rank) -> expert assignments,
  2. stable-sort pairs by expert, position-in-expert via group offsets,
  3. scatter into a static (E, capacity, d) buffer (overflow pairs drop),
  4. grouped expert FFN (the hand-written ``expert_ffn`` kernel on CUDA),
  5. score-weighted un-permute (combine).

``fresh_mask`` / ``h_cache`` implement Conditional Communication: masked
pairs are not dispatched (they take no buffer capacity) and their
contribution comes from the cached expert output of an earlier step.
``codec`` / ``dispatch_base`` carry the wire codec: the dispatch payload is
a quantized residual against ``dispatch_base`` and the combine payload one
against ``h_cache``.  All scatters and gathers avoid host synchronisation:
dropped pairs go to one extra dump row that is cut off.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.compress import codecs as codec_lib
from repro_torch.kernels import ops
from repro_torch.kernels.ref import act_fn


def default_capacity(num_tokens: int, cfg, *, k: Optional[int] = None,
                     floor: int = 8) -> int:
    """Static per-expert capacity, rounded up to a multiple of ``floor``."""
    k = cfg.experts_per_token if k is None else k
    c = math.ceil(num_tokens * k * cfg.capacity_factor / cfg.num_experts)
    return max(floor, -(-c // floor) * floor)


# ---------------------------------------------------------------------------
# routing + dispatch plan
# ---------------------------------------------------------------------------
class DispatchPlan(NamedTuple):
    slot: torch.Tensor        # (T*K,) destination slot e*C+pos, == E*C if dropped
    t_sorted: torch.Tensor    # (T*K,) source token per sorted pair
    inv_order: torch.Tensor   # (T*K,) unsort permutation
    keep: torch.Tensor        # (T*K,) bool, sorted order
    capacity: int
    counts: torch.Tensor      # (E,) pairs routed per expert (pre-drop)


def route(p, x: torch.Tensor, cfg):
    """Router probabilities + top-k selection.  x: (T, d).  An optional
    ``p["router_bias"]`` (E,) adds to the logits."""
    logits = x.to(torch.float32) @ p["router"]
    if "router_bias" in p:
        logits = logits + p["router_bias"].to(torch.float32)[None, :]
    probs = torch.softmax(logits, dim=-1)
    scores, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    return probs, scores, idx


def make_plan(idx: torch.Tensor, E: int, capacity: int,
              fresh_mask: Optional[torch.Tensor] = None) -> DispatchPlan:
    """Sort-based dispatch plan.  idx: (T, K) expert ids.  Stale pairs
    (``fresh_mask`` False) go to a virtual expert ``E`` that sorts after
    every real one and never enters the buffer."""
    T, K = idx.shape
    dev = idx.device
    flat_e = idx.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    if fresh_mask is not None:
        flat_e = torch.where(fresh_mask.reshape(-1), flat_e,
                             torch.full_like(flat_e, E))
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    t_sorted = flat_t[order]
    counts = histogram(flat_e.clamp(0, E), E + 1)[:E]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * K, device=dev) - starts[e_sorted.clamp(0, E - 1)]
    keep = (pos < capacity) & (e_sorted < E)
    slot = torch.where(keep, e_sorted * capacity + pos,
                       torch.full_like(pos, E * capacity))
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(T * K, device=dev)
    return DispatchPlan(slot=slot, t_sorted=t_sorted, inv_order=inv_order,
                        keep=keep, capacity=capacity, counts=counts)


def histogram(ids: torch.Tensor, n: int,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 counts (or f32 sums of ``weights``) of each id in ``[0, n)``:
    a scatter-add, which unlike ``torch.bincount`` never synchronises with
    the host on CUDA."""
    src = torch.ones_like(ids) if weights is None \
        else weights.to(torch.float32)
    return torch.zeros(n, dtype=src.dtype, device=ids.device) \
        .scatter_add_(0, ids, src)


def dispatch(x: torch.Tensor, plan: DispatchPlan, E: int,
             capacity: int) -> torch.Tensor:
    """Scatter tokens into the (E, C, d) dispatch buffer."""
    d = x.shape[-1]
    vals = x[plan.t_sorted] * plan.keep[:, None].to(x.dtype)
    buf = torch.zeros((E * capacity + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, plan.slot, vals)      # dropped pairs land on the dump row
    return buf[:E * capacity].reshape(E, capacity, d)


def combine(buf_out: torch.Tensor, plan: DispatchPlan, scores: torch.Tensor,
            T: int, *, h_cache: Optional[torch.Tensor] = None,
            fresh_mask: Optional[torch.Tensor] = None):
    """Score-weighted un-permute.  buf_out: (E, C, d).

    Returns (y, pair_vals (T, K, d), pair_keep (T, K)); pair_keep marks
    the pairs that made it through dispatch."""
    E, C, d = buf_out.shape
    flat = torch.cat([buf_out.reshape(E * C, d),
                      buf_out.new_zeros((1, d))], dim=0)
    gathered = flat[plan.slot] * plan.keep[:, None].to(flat.dtype)
    K = scores.shape[-1]
    pair_vals = gathered[plan.inv_order].reshape(T, K, d)
    pair_keep = plan.keep[plan.inv_order].reshape(T, K)
    if h_cache is not None and fresh_mask is not None:
        pair_vals = torch.where(fresh_mask[..., None], pair_vals,
                                h_cache.to(pair_vals.dtype))
    y = weighted_sum(scores, pair_vals)
    return y, pair_vals, pair_keep


def weighted_sum(scores: torch.Tensor, pair_vals: torch.Tensor) -> torch.Tensor:
    """y[t] = sum_k scores[t, k] * pair_vals[t, k], in f32."""
    return torch.einsum("tk,tkd->td", scores.to(torch.float32),
                        pair_vals.to(torch.float32))


# ---------------------------------------------------------------------------
# expert FFN (grouped, gated)
# ---------------------------------------------------------------------------
def expert_ffn(p, buf: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    """buf: (E, C, d) -> (E, C, d) through the ``expert_ffn`` kernel (its
    plain version on the CPU)."""
    return ops.expert_ffn(buf, p["experts_gate"], p["experts_up"],
                          p["experts_down"], act=act)


def shared_expert(p, x: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    """Always-on shared experts: plain matrix products, as the JAX package
    leaves them to XLA."""
    fn = act_fn(act)
    return (fn(x @ p["shared_gate"]) * (x @ p["shared_up"])) @ p["shared_down"]


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                      E: int) -> torch.Tensor:
    """Switch-style aux loss over the (unsharded) token batch."""
    T, K = idx.shape
    frac_routed = histogram(idx.reshape(-1), E).to(torch.float32) / T
    mean_prob = probs.mean(0)
    return E * torch.sum(frac_routed / K * mean_prob)


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------
class MoEAux(NamedTuple):
    lb_loss: torch.Tensor
    dropped_frac: torch.Tensor       # capacity drops over dispatched pairs
    dispatch_bytes: int              # one-way dispatch payload, as transmitted
    pair_vals: Optional[torch.Tensor]
    scores: Optional[torch.Tensor]
    pair_keep: Optional[torch.Tensor] = None
    raw_dispatch_bytes: int = 0      # the same payload, lossless
    wire_payload: Optional[torch.Tensor] = None   # decoded dispatch payload
    counts: Optional[torch.Tensor] = None         # (E,) routed, pre-drop
    served_counts: Optional[torch.Tensor] = None  # (E,) served, post-drop


def moe_forward(p, x: torch.Tensor, cfg, *,
                capacity: Optional[int] = None,
                fresh_mask: Optional[torch.Tensor] = None,
                h_cache: Optional[torch.Tensor] = None,
                want_pair_vals: bool = False,
                codec: Optional[codec_lib.CodecSpec] = None,
                dispatch_base: Optional[torch.Tensor] = None):
    """MoE layer forward on one device.  x: (T, d) flat tokens.

    With ``codec`` the dispatch payload is encoded against
    ``dispatch_base`` (zeros if None) and its reconstruction returned as
    ``aux.wire_payload``; routing still sees the full-precision ``x``.  The
    combine payload is encoded against ``h_cache``; its reconstruction
    feeds the weighted sum and the next cache entry (``aux.pair_vals``).
    ``aux.dispatch_bytes`` reports the compressed payload,
    ``aux.raw_dispatch_bytes`` the lossless one.
    """
    T, d = x.shape
    E = cfg.num_experts
    probs, scores, idx = route(p, x, cfg)
    if capacity is None:
        capacity = default_capacity(T, cfg)
    plan = make_plan(idx, E, capacity, fresh_mask=fresh_mask)
    x_wire = x
    if codec is not None:
        base = dispatch_base if dispatch_base is not None \
            else torch.zeros_like(x)
        x_wire = codec_lib.apply(codec, x, base)
    buf = dispatch(x_wire, plan, E, capacity)
    buf_out = expert_ffn(p, buf, act=cfg.act)
    y, pair_vals, pair_keep = combine(buf_out, plan, scores, T,
                                      h_cache=h_cache, fresh_mask=fresh_mask)
    if codec is not None and h_cache is not None:
        # freshly transmitted pairs arrive as residuals against the shared
        # (token, rank) cache; masked pairs already read h_cache and
        # dropped pairs stay zero
        wire_ok = pair_keep if fresh_mask is None else (pair_keep & fresh_mask)
        recon = codec_lib.apply(codec, pair_vals.to(torch.float32),
                                h_cache.to(torch.float32))
        pair_vals = torch.where(wire_ok[..., None],
                                recon.to(pair_vals.dtype), pair_vals)
        y = weighted_sum(scores, pair_vals)
    if cfg.num_shared_experts:
        y = y + shared_expert(p, x, act=cfg.act).to(y.dtype)

    counts = plan.counts
    served_counts = histogram(idx.reshape(-1), E,
                              weights=pair_keep.reshape(-1))
    dispatched = counts.sum().to(torch.float32)
    kept = pair_keep.sum().to(torch.float32)
    dropped_frac = torch.where(
        dispatched > 0, 1.0 - kept / torch.clamp_min(dispatched, 1.0),
        torch.zeros_like(dispatched))
    itemsize = x.element_size()
    per_row = (codec.wire_bytes_per_row(d, itemsize)
               if codec is not None else d * itemsize)
    keep_pairs = want_pair_vals or fresh_mask is not None
    aux = MoEAux(
        lb_loss=load_balance_loss(probs, idx, E),
        dropped_frac=dropped_frac,
        dispatch_bytes=E * capacity * per_row,
        pair_vals=pair_vals if keep_pairs else None,
        scores=scores if keep_pairs else None,
        pair_keep=pair_keep if keep_pairs else None,
        raw_dispatch_bytes=E * capacity * d * itemsize,
        wire_payload=x_wire if codec is not None else None,
        counts=counts,
        served_counts=served_counts,
    )
    return y.to(x.dtype), aux
