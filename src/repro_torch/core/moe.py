"""Capacity-based Mixture-of-Experts, on one device or expert-parallel
(port of ``repro.core.moe``).

The dispatch path is sort-based, never materialising (T, E, C) one-hots:

  1. top-k routing -> (token, rank) -> expert assignments,
  2. stable-sort pairs by expert, position-in-expert via group offsets,
  3. scatter into a static (E, capacity, d) buffer (overflow pairs drop),
  4. over an ep mesh, the dispatch all-to-all to the experts' ranks,
  5. grouped expert FFN (the hand-written ``expert_ffn`` kernel on CUDA)
     on the local experts,
  6. over an ep mesh, the combine all-to-all back; then the score-weighted
     un-permute (combine).

Under a mesh (:class:`~repro_torch.launch.mesh.EPMesh`, the ranks of one
ep group) ``x`` is the rank's token shard, the ``experts_*`` params its
expert shard, and the capacity a per-rank capacity; ``overlap`` swaps the
two all-to-alls for the ring engine of :mod:`repro_torch.core.overlap`.
A ``placement`` (:mod:`repro_torch.core.placement`) reorders the dispatch
buffer's experts and serves the pairs of replicated experts locally.
``num_wire_experts`` widens the wire to expert paging's padded expert
count (:mod:`repro_torch.core.paging`): phantom experts no token reaches.

With grad enabled (training over a ``TrainMesh``'s ``model`` group) the
two all-to-alls are differentiable: the backward sends each piece of the
cotangent back to the rank it came from, the same tiled all-to-all; and
the load-balance loss's means over the ranks give each rank its share of
the gradient (:func:`group_mean`).  Without grad both are the plain
collectives.

``fresh_mask`` / ``h_cache`` implement Conditional Communication: masked
pairs are not dispatched (they take no buffer capacity) and their
contribution comes from the cached expert output of an earlier step.
``codec`` / ``dispatch_base`` carry the wire codec: the dispatch payload is
a quantized residual against ``dispatch_base`` and the combine payload one
against ``h_cache``.  ``obs`` adds the layer's staleness telemetry vector
and ``resilience`` the seeded wire corruption and the NaN/Inf guards, with
their event counts.  All scatters and gathers avoid host synchronisation:
dropped pairs go to one extra dump row that is cut off.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.compress import codecs as codec_lib
from repro_torch.core import overlap as overlap_lib
from repro_torch.kernels import ops
from repro_torch.kernels.ref import act_fn
from repro_torch.models.layers import dense_init
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.resilience import faults as fault_lib


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def moe_init(gen: torch.Generator, cfg, *, dtype: torch.dtype = torch.bfloat16):
    """MoE params in the reference's tree, drawn from ``gen`` on its device:
    an f32 router (d, E), the expert stacks (E, d, f) / (E, f, d) in
    ``dtype``, and shared experts of width ``f * num_shared_experts`` only
    when the config has some."""
    d, f, E = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
    p = {
        "router": dense_init(gen, (d, E), dtype=torch.float32),
        "experts_gate": dense_init(gen, (E, d, f), dtype=dtype),
        "experts_up": dense_init(gen, (E, d, f), dtype=dtype),
        "experts_down": dense_init(gen, (E, f, d), dtype=dtype),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared_gate"] = dense_init(gen, (d, fs), dtype=dtype)
        p["shared_up"] = dense_init(gen, (d, fs), dtype=dtype)
        p["shared_down"] = dense_init(gen, (fs, d), dtype=dtype)
    return p


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
    slot: torch.Tensor        # (T*K,) destination slot e*C+pos, == S*C if dropped
    t_sorted: torch.Tensor    # (T*K,) source token per sorted pair
    inv_order: torch.Tensor   # (T*K,) unsort permutation
    keep: torch.Tensor        # (T*K,) bool, sorted order
    capacity: int
    counts: torch.Tensor      # (E,) pairs routed per expert (pre-drop)


def refuse_router_jitter(cfg) -> None:
    """Raise for ``router_jitter > 0``.  The reference adds
    ``router_jitter * normal(key)`` to the router logits, drawn from the
    JAX PRNG key of each step; JAX PRNG keys cannot be replayed in torch,
    so the port cannot draw the same noise and serves no jitter rather
    than ignoring it."""
    if cfg.router_jitter > 0:
        raise ValueError(
            f"router_jitter={cfg.router_jitter}: the reference draws the "
            f"router noise from JAX PRNG keys, which cannot be replayed in "
            f"torch; the port serves router_jitter == 0 only")


def route(p, x: torch.Tensor, cfg):
    """Router probabilities + top-k selection.  x: (T, d).  An optional
    ``p["router_bias"]`` (E,) adds to the logits.

    Among equal probabilities the lower expert id comes first, as in
    ``jax.lax.top_k``: a stable descending sort, where ``torch.topk``
    leaves the order of ties unspecified.  Ties are common where the
    softmax saturates (a large router bias) and decide which experts,
    slots and drops a token gets, and under expert parallelism which rank
    it goes to."""
    logits = x.to(torch.float32) @ p["router"]
    if "router_bias" in p:
        logits = logits + p["router_bias"].to(torch.float32)[None, :]
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    return probs, top.values[:, :k], top.indices[:, :k]


def make_plan(idx: torch.Tensor, E: int, capacity: int,
              fresh_mask: Optional[torch.Tensor] = None,
              num_slots: Optional[int] = None) -> DispatchPlan:
    """Sort-based dispatch plan.  idx: (T, K) expert ids.  Stale pairs
    (``fresh_mask`` False) go to a virtual expert that sorts after every
    real one and never enters the buffer.  ``num_slots`` is the dispatch
    buffer's expert dimension where it is wider than the routable ``E``
    (expert paging's padded wire): the drop slot moves past the padded
    buffer, so dropped pairs stay out of phantom rows.  Default ``E``."""
    S = E if num_slots is None else num_slots
    T, K = idx.shape
    dev = idx.device
    flat_e = idx.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    if fresh_mask is not None:
        flat_e = torch.where(fresh_mask.reshape(-1), flat_e,
                             torch.full_like(flat_e, S))
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    t_sorted = flat_t[order]
    counts = histogram(flat_e.clamp(0, E), E + 1)[:E]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * K, device=dev) - starts[e_sorted.clamp(0, E - 1)]
    keep = (pos < capacity) & (e_sorted < E)
    slot = torch.where(keep, e_sorted * capacity + pos,
                       torch.full_like(pos, S * capacity))
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


def lb_terms(probs: torch.Tensor, idx: torch.Tensor, E: int) -> torch.Tensor:
    """(1, 2, E): the two token means of the switch loss, the fraction of
    pairs routed to each expert and its mean router probability."""
    T, _ = idx.shape
    frac_routed = histogram(idx.reshape(-1), E).to(torch.float32) / T
    return torch.stack([frac_routed, probs.mean(0)])[None]


def lb_from_terms(terms: torch.Tensor, k: int) -> torch.Tensor:
    """The switch loss from (calls, 2, E) terms, averaged over the calls
    (two for a staggered layer's half batches)."""
    E = terms.shape[-1]
    return (E * torch.sum(terms[:, 0] / k * terms[:, 1], dim=-1)).mean()


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor, E: int,
                      mesh=None) -> torch.Tensor:
    """Switch-style aux loss.  Under an ep ``mesh`` the token batch is
    sharded: the loss is bilinear in the two batch means, so each is
    averaged over the ranks BEFORE the product, as the reference's
    ``pmean`` does (a mean of per-shard losses would be a mean of
    products)."""
    terms = lb_terms(probs, idx, E)
    if mesh is not None:
        terms = group_mean(terms, mesh)
    return lb_from_terms(terms, idx.shape[1])


class _GroupMean(torch.autograd.Function):
    """The mean over an ep group, whose backward hands each rank its share
    of the gradient: the group mean of the cotangent, over n."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_mean(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_mean(g) / ctx.mesh.size, None


def group_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """``mesh.all_reduce_mean(t)`` (the reference's ``pmean`` over the ep
    axis).  Where ``t`` requires grad the mean is differentiable in the
    convention of a training mesh, whose ranks then SUM the gradients of
    the leaves applied to their own tokens (the router, shared experts):
    every rank's loss holds the same mean, so the backward gives rank r
    ``d mean / d t_r = 1/n`` of the (group-averaged) cotangent, its share
    of the one loss.  The reference's ``shard_map`` transpose does the same
    (``tests/test_torch_train_mesh.py`` holds the router's gradient to
    it)."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _GroupMean.apply(t, mesh)
    return mesh.all_reduce_mean(t)


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all (piece j to rank j), whose backward runs the
    same all-to-all on the cotangent: piece j goes back to rank j."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_to_all(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g), None


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------
class MoEAux(NamedTuple):
    lb_loss: Optional[torch.Tensor]  # None under a mesh: see lb_terms
    dropped_frac: torch.Tensor       # capacity drops over dispatched pairs
    dispatch_bytes: int              # one-way per-rank dispatch payload,
    #                                  as transmitted
    pair_vals: Optional[torch.Tensor]
    scores: Optional[torch.Tensor]
    pair_keep: Optional[torch.Tensor] = None
    raw_dispatch_bytes: int = 0      # the same payload, lossless
    wire_payload: Optional[torch.Tensor] = None   # decoded dispatch payload
    counts: Optional[torch.Tensor] = None         # (E,) routed, pre-drop
    served_counts: Optional[torch.Tensor] = None  # (E,) served, post-drop
    hops: int = 0                    # ring hops this layer ran (2 (n-1))
    hop_bytes: int = 0               # per-rank wire bytes of one ring hop
    lb_terms: Optional[torch.Tensor] = None   # (calls, 2, E) local means
    telemetry: Optional[torch.Tensor] = None  # (NUM_FIELDS,) f32 staleness
    #                                telemetry; None unless obs is enabled
    fault_events: Optional[torch.Tensor] = None  # (NUM_FAULT_EVENTS,) f32:
    #                                combine rows corrupted / guarded,
    #                                dispatch rows corrupted / guarded; None
    #                                without a ResilienceConfig


class FaultMasks(NamedTuple):
    """Corruption masks given to :func:`moe_forward` instead of drawn:
    ``dispatch`` (T,) token rows, ``combine`` (T, K) pairs (either may be
    None).  The tests pass the reference's ``corruption_mask`` draws."""
    dispatch: Optional[torch.Tensor] = None
    combine: Optional[torch.Tensor] = None


def moe_forward(p, x: torch.Tensor, cfg, *,
                capacity: Optional[int] = None,
                fresh_mask: Optional[torch.Tensor] = None,
                h_cache: Optional[torch.Tensor] = None,
                want_pair_vals: bool = False,
                codec: Optional[codec_lib.CodecSpec] = None,
                dispatch_base: Optional[torch.Tensor] = None,
                mesh=None, overlap: bool = False,
                hop_schedule=None, placement=None,
                obs: Optional[obs_telemetry.ObsConfig] = None,
                resilience: Optional[fault_lib.ResilienceConfig] = None,
                fault_salt: int = 0, fault_key: Optional[int] = None,
                fault_masks: Optional[FaultMasks] = None,
                num_wire_experts: Optional[int] = None):
    """MoE layer forward.  x: (T, d) flat tokens (the rank's shard under
    ``mesh``).

    Under an ep ``mesh`` the ``experts_*`` params hold the rank's
    ``E / n`` experts, ``capacity`` (and its default from the local T) is
    per rank, and the (E, C, d) buffer goes through the dispatch
    all-to-all as (n, e_loc, C, d), the local experts compute
    (e_loc, n * C, d), and the combine all-to-all brings the outputs back
    (cast to ``x.dtype`` first).  ``overlap`` runs the ring engine instead,
    its hops in ``hop_schedule``'s order (default the natural one).
    ``aux.dispatch_bytes`` is the per-rank one-way payload; ``aux.hops`` /
    ``aux.hop_bytes`` the ring's hop count and per-hop bytes (0 on the
    blocking path).  ``aux.lb_terms`` holds the local means of the
    load-balance loss; under a mesh ``aux.lb_loss`` is None and the caller
    reduces the terms over the ranks once for all layers
    (:func:`repro_torch.models.dit_moe.dit_forward`) or calls
    :func:`load_balance_loss` with the mesh.

    ``placement`` (not the identity): the dispatch buffer holds experts in
    the placement's device-major wire order, which the ``experts_*`` stacks
    must follow (:func:`repro_torch.core.placement.place_moe_params`, or
    :func:`repro_torch.common.sharding.place_experts` over a mesh), and
    pairs routed to a replicated expert never enter it: they go to a local
    buffer served by the ``experts_*_rep`` stacks in one more
    ``expert_ffn`` call.  The default capacity is scaled by the
    placement's ``cap_scale`` (a planned one comes scaled from
    ``LayerAction.dispatch_capacity``).  ``counts`` and ``served_counts``
    stay in expert-id space.

    ``num_wire_experts`` (over a mesh): the expert dimension ``S`` of the
    dispatch buffer, the wire and the ``experts_*`` stacks when expert
    paging pads them past ``cfg.num_experts`` with zero-weight phantom
    experts (the next multiple of the ep size), so any expert count serves
    on any mesh.  Routing stays over the real ``E``, so phantom rows carry
    no token; the buffers, ring chunks and byte counts grow by ``S / E``.
    With ``S == E`` (or ``None``) every path is the unpadded one.  It
    cannot compose with a placement.

    With ``codec`` the dispatch payload is encoded against
    ``dispatch_base`` (zeros if None) and its reconstruction returned as
    ``aux.wire_payload``; routing still sees the full-precision ``x``.  The
    combine payload is encoded against ``h_cache``; its reconstruction
    feeds the weighted sum and the next cache entry (``aux.pair_vals``).
    ``aux.dispatch_bytes`` reports the compressed payload,
    ``aux.raw_dispatch_bytes`` the lossless one.

    An enabled ``obs`` fills ``aux.telemetry``
    (:func:`~repro_torch.obs.telemetry.layer_telemetry`).  ``resilience``
    corrupts the wire payloads with NaN at its fault rates and guards them:
    a non-finite dispatch row falls back to the codec base (zeros on a
    lossless wire), a non-finite combine pair to its ``h_cache`` entry (zero
    without a cache) and leaves ``pair_keep``; ``aux.fault_events`` counts
    both.  The masks are drawn from ``(faults.seed, site, fault_salt,
    fault_key)`` (:func:`~repro_torch.resilience.faults.corruption_mask`)
    unless ``fault_masks`` gives them.  With guards on and clean payloads
    every select passes everything through: the output is bit-identical to
    the guard-less path.
    """
    faults = resilience.faults if resilience is not None else None
    guard = resilience.guards if resilience is not None else False
    fe = None
    if resilience is not None:
        fe = torch.zeros((fault_lib.NUM_FAULT_EVENTS,), dtype=torch.float32,
                         device=x.device)
    T, d = x.shape
    E = cfg.num_experts
    probs, scores, idx = route(p, x, cfg)
    pl = placement if placement is not None and not placement.is_identity \
        else None
    S = E                   # the wire/dispatch-buffer expert dimension
    if num_wire_experts is not None and mesh is not None:
        if num_wire_experts < E:
            raise ValueError(
                f"num_wire_experts={num_wire_experts} < num_experts={E}")
        if pl is not None and num_wire_experts != E:
            raise ValueError("a padded wire (expert paging) cannot compose "
                             "with an expert placement")
        S = num_wire_experts
    if capacity is None:
        capacity = default_capacity(T, cfg)
        if pl is not None:
            capacity = pl.scaled_capacity(capacity)
    # placement: replicated pairs leave the wire; the rest scatter at the
    # placement's wire positions, so each rank's chunk holds its experts
    rep_mask = None
    wire_fresh, wire_idx = fresh_mask, idx
    if pl is not None:
        inv_perm, rep_ids, pos_of = placement_index(pl, x.device)
        if pl.replicated:
            rep_mask = (idx[..., None] == rep_ids).any(-1)
            wire_fresh = ~rep_mask if fresh_mask is None \
                else fresh_mask & ~rep_mask
        wire_idx = inv_perm[idx]
    plan = make_plan(wire_idx, E, capacity, fresh_mask=wire_fresh,
                     num_slots=S)
    x_wire = x
    if codec is not None:
        base = dispatch_base if dispatch_base is not None \
            else torch.zeros_like(x)
        x_wire = codec_lib.apply(codec, x, base)
    # resilience, dispatch direction: corrupt token rows of the wire
    # payload, then guard them; a bad row falls back to the codec base (the
    # previous step's decoded payload, which both endpoints hold) or, on a
    # lossless wire, to zeros (the gated FFN maps a zero row to zero)
    cm = _fault_mask(fault_masks, "dispatch", faults, "corrupt_dispatch_rate",
                     fault_lib.FE_CORRUPT_DISPATCH, fault_key, fault_salt,
                     (T,), x.device)
    if cm is not None:
        x_wire = fault_lib.corrupt_rows(x_wire, cm)
        fe[fault_lib.FE_CORRUPT_DISPATCH] += cm.sum()
    if guard:
        row_ok = torch.isfinite(x_wire).all(-1)
        fe[fault_lib.FE_GUARDED_DISPATCH] += (~row_ok).sum()
        fb = base if codec is not None else torch.zeros_like(x_wire)
        x_wire = torch.where(row_ok[:, None], x_wire, fb)
    buf = dispatch(x_wire, plan, S, capacity)
    n = 1 if mesh is None else mesh.size
    ring = bool(overlap and n > 1)
    loc_plan = loc_out = None
    if rep_mask is not None:
        # replica-served pairs: the same wire payload into a local
        # (R, C_loc, d) buffer whose capacity covers every pair (the hot
        # experts' headroom the scaled wire buffer gave away)
        R = len(pl.replicated)
        loc_cap = -(-(T * idx.shape[1]) // 8) * 8
        loc_fresh = rep_mask if fresh_mask is None else fresh_mask & rep_mask
        loc_plan = make_plan(pos_of[idx], R, loc_cap, fresh_mask=loc_fresh)
        loc_out = ops.expert_ffn(
            dispatch(x_wire, loc_plan, R, loc_cap), p["experts_gate_rep"],
            p["experts_up_rep"], p["experts_down_rep"], act=cfg.act)
    if mesh is None:
        buf_out = expert_ffn(p, buf, act=cfg.act)
    else:
        buf_out = _ep_exchange(p, buf, cfg, mesh, ring=ring,
                               wire_dtype=x.dtype, hop_schedule=hop_schedule)
    if rep_mask is not None:
        # merge wire and replica outputs per pair, then apply the cache as
        # ``combine`` does: the identity layout's values for every pair
        _, wire_vals, wire_keep = combine(buf_out, plan, scores, T)
        _, loc_vals, loc_keep = combine(loc_out, loc_plan, scores, T)
        pair_vals = torch.where(rep_mask[..., None], loc_vals, wire_vals)
        pair_keep = torch.where(rep_mask, loc_keep, wire_keep)
        if h_cache is not None and fresh_mask is not None:
            pair_vals = torch.where(fresh_mask[..., None], pair_vals,
                                    h_cache.to(pair_vals.dtype))
        y = weighted_sum(scores, pair_vals)
    else:
        y, pair_vals, pair_keep = combine(buf_out, plan, scores, T,
                                          h_cache=h_cache,
                                          fresh_mask=fresh_mask)
    # fresh-kept pairs still hold the raw wire value here: the telemetry
    # measures the combine residual on them, before the codec and before
    # any corruption
    pair_vals_fresh = pair_vals
    y_dirty = False
    sent = pair_keep if fresh_mask is None else (pair_keep & fresh_mask)
    cm = _fault_mask(fault_masks, "combine", faults, "corrupt_combine_rate",
                     fault_lib.FE_CORRUPT_COMBINE, fault_key, fault_salt,
                     tuple(pair_keep.shape), x.device)
    if cm is not None:
        # corrupt the expert outputs of transmitted pairs, as a wire fault
        cm = cm & sent
        pair_vals = fault_lib.corrupt_rows(pair_vals, cm)
        fe[fault_lib.FE_CORRUPT_COMBINE] += cm.sum()
        y_dirty = True
    recon = None
    if codec is not None and h_cache is not None:
        # freshly transmitted pairs arrive as residuals against the shared
        # (token, rank) cache; masked pairs already read h_cache and
        # dropped pairs stay zero
        recon = codec_lib.apply(codec, pair_vals.to(torch.float32),
                                h_cache.to(torch.float32), guard=guard)
        pair_vals = torch.where(sent[..., None],
                                recon.to(pair_vals.dtype), pair_vals)
        y_dirty = True
    if guard:
        # a non-finite pair falls back to its h_cache entry, the value a
        # masked pair would read (zero without a cache, like a capacity
        # drop), and leaves pair_keep so it never enters the cache
        pair_ok = torch.isfinite(pair_vals).all(-1)
        fe[fault_lib.FE_GUARDED_COMBINE] += (~pair_ok).sum()
        fb = h_cache.to(pair_vals.dtype) if h_cache is not None \
            else torch.zeros_like(pair_vals)
        pair_vals = torch.where(pair_ok[..., None], pair_vals, fb)
        pair_keep = pair_keep & pair_ok
        y_dirty = True
    if y_dirty:
        y = weighted_sum(scores, pair_vals)
    if cfg.num_shared_experts:
        y = y + shared_expert(p, x, act=cfg.act).to(y.dtype)

    counts = plan.counts                       # wire space == expert space
    if pl is not None:
        flat_e = idx.reshape(-1)
        if fresh_mask is not None:
            flat_e = torch.where(fresh_mask.reshape(-1), flat_e,
                                 torch.full_like(flat_e, E))
        counts = histogram(flat_e, E + 1)[:E]
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
    telemetry = None
    if obs is not None and obs.enabled:
        telemetry = obs_telemetry.layer_telemetry(
            x=x, x_wire=x_wire, dispatch_base=dispatch_base, codec=codec,
            pair_vals=pair_vals_fresh, recon=recon, pair_keep=pair_keep,
            fresh_mask=fresh_mask, h_cache=h_cache,
            dropped_frac=dropped_frac)
    terms = lb_terms(probs, idx, E)
    aux = MoEAux(
        lb_loss=None if mesh is not None
        else lb_from_terms(terms, idx.shape[1]),
        dropped_frac=dropped_frac,
        dispatch_bytes=S * capacity * per_row,
        pair_vals=pair_vals if keep_pairs else None,
        scores=scores if keep_pairs else None,
        pair_keep=pair_keep if keep_pairs else None,
        raw_dispatch_bytes=S * capacity * d * itemsize,
        wire_payload=x_wire if codec is not None else None,
        counts=counts,
        served_counts=served_counts,
        hops=2 * (n - 1) if ring else 0,
        hop_bytes=(S // n) * capacity * per_row if ring else 0,
        lb_terms=terms,
        telemetry=telemetry,
        fault_events=fe,
    )
    return y.to(x.dtype), aux


@functools.lru_cache(maxsize=256)
def placement_index(pl, device: torch.device):
    """(expert -> wire position, replicated ids, expert -> replica row
    with R for the others) of a placement, as tensors on ``device``, made
    once: built per call they would be copied from the host every layer,
    and such a copy waits for the stream."""
    E, R = pl.num_experts, len(pl.replicated)
    pos_of = [R] * E
    for j, e in enumerate(pl.replicated):
        pos_of[e] = j
    return tuple(torch.tensor(v, dtype=torch.int64, device=device)
                 for v in (pl.inv_perm(), pl.replicated, pos_of))


def _fault_mask(given: Optional[FaultMasks], which: str, faults, rate_field,
                site: int, key, salt: int, shape, device):
    """The corruption mask of one site: the caller's, else drawn at the
    fault config's rate; None when that site injects nothing."""
    if faults is None or getattr(faults, rate_field) <= 0:
        return None
    if given is not None and getattr(given, which) is not None:
        return getattr(given, which).to(device=device, dtype=torch.bool)
    return fault_lib.corruption_mask(key, faults.seed, salt, site,
                                     getattr(faults, rate_field), shape,
                                     device)


def _ep_exchange(p, buf: torch.Tensor, cfg, mesh, *, ring: bool,
                 wire_dtype, hop_schedule=None) -> torch.Tensor:
    """(S, C, d) dispatch buffer -> the (S, C, d) expert outputs of its
    rows, the experts (``S``: the real ones, or paging's padded set) spread
    over the ranks of ``mesh``."""
    E, C, d = buf.shape
    n = mesh.size
    if E % n:
        raise ValueError(
            f"num_experts={E} must divide over the {n}-way 'ep' mesh axis "
            f"for expert parallelism, or enable expert paging "
            f"(DiceConfig.paging), whose pool pads the wire to the next "
            f"multiple so any expert count serves on any mesh")
    e_loc = E // n
    local = {k: v for k, v in p.items()
             if k.startswith("experts_") and not k.endswith("_rep")}
    if local["experts_gate"].shape[0] != e_loc:
        raise ValueError(
            f"the params hold {local['experts_gate'].shape[0]} experts, not "
            f"this rank's {e_loc}: shard them with "
            f"repro_torch.common.sharding.ep_shard_params, or page them "
            f"(repro_torch.core.paging)")
    chunks = buf.reshape(n, e_loc, C, d)
    grad = torch.is_grad_enabled() and (
        buf.requires_grad or any(v.requires_grad for v in local.values()))
    if ring:
        if grad:
            raise ValueError("the ring engine has no backward: train over the "
                             "blocking all-to-alls (overlap off)")
        out = overlap_lib.ring_expert_exchange(
            chunks, lambda c: expert_ffn(local, c, act=cfg.act), mesh=mesh,
            wire_dtype=wire_dtype, hop_schedule=hop_schedule)
        return out.reshape(E, C, d)
    a2a = (lambda t: _AllToAll.apply(t, mesh)) if grad else mesh.all_to_all
    b = a2a(chunks)                        # piece j: rank j's rows for us
    b = b.transpose(0, 1).reshape(e_loc, n * C, d)
    b = expert_ffn(local, b, act=cfg.act)
    b = b.reshape(e_loc, n, C, d).transpose(0, 1).to(wire_dtype)
    return a2a(b).reshape(E, C, d)
