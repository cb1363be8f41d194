"""DiT-MoE: Diffusion Transformer with Mixture-of-Experts FFNs (port of
``repro.models.dit_moe``).

adaLN-zero DiT blocks, an MoE FFN with top-k routed experts plus shared
experts, class-conditional with a null class for CFG.  The forward pass
takes per-MoE-layer staleness state (:mod:`repro_torch.core.staleness`)
and a precompiled :class:`~repro_torch.core.plan.StepPlan`, so one
implementation serves every schedule, on one device or on one rank of a
``dp x ep x patch`` mesh, with the staleness telemetry (``obs``) and the
wire faults and guards of the resilience ladder.  DistriFusion's displaced
patch parallelism (``patch_parallel_ndev``, or a mesh's ``patch`` axis)
threads attention K/V states instead (:mod:`repro_torch.core.patch_parallel`).
Under expert paging the routed-expert shards come from a host pool
(:mod:`repro_torch.core.paging`), fetched one or more layers ahead.

Params are a plain dict in the JAX package's tree layout and (in, out)
weight orientation; :mod:`repro_torch.bridge` carries a JAX tree over.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import moe as moe_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import staleness as stale_lib
from repro_torch.core.schedules import DiceConfig
from repro_torch.core.patch_parallel import (PatchParallelState,
                                             displaced_patch_attention,
                                             sharded_patch_attention)
from repro_torch.models import layers as L
from repro_torch.obs import telemetry as obs_telemetry


def timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """Sinusoidal embedding of continuous t in [0, 1].  t: (B,)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t[:, None].to(torch.float32) * 1000.0 * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_dit(cfg, *, generator: Optional[torch.Generator],
             dtype: torch.dtype = torch.float32,
             experts: Optional[slice] = None) -> Dict[str, Any]:
    """Random params on ``generator.device``, in the layout of
    ``repro.models.dit_moe.init_dit`` (adaLN and the output layer zero-
    initialised).  The draws differ from JAX's for the same seed; to run
    the reference's weights use :func:`repro_torch.bridge.from_jax_params`.

    ``experts`` keeps only those rows of each routed-expert stack (an ep
    rank's shard): every layer's full stacks are still drawn, in the same
    order, so the kept rows equal those of the unsharded init, but only
    one layer's full stacks exist at a time.

    ``generator=None`` gives the same tree of ``meta`` tensors: shapes and
    dtypes without storage, the ``like`` tree
    :func:`repro_torch.checkpoint.io.load_checkpoint` checks a file
    against.
    """
    g = generator
    dev = torch.device("meta") if g is None else g.device

    def dense(shape, *, scale=None, dtype=dtype):
        if g is None:
            return torch.empty(shape, dtype=dtype, device=dev)
        return L.dense_init(g, shape, scale=scale, dtype=dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    d, c_in = cfg.d_model, cfg.in_channels
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    E, f = cfg.num_experts, cfg.expert_d_ff
    params: Dict[str, Any] = {
        "patch_embed": dense((c_in, d)),
        "pos_embed": dense((cfg.patch_tokens, d), scale=0.02),
        "t_mlp1": dense((256, d)),
        "t_mlp2": dense((d, d)),
        "class_embed": dense((cfg.num_classes + 1, d), scale=0.02),
        "final_mod": zeros((d, 2 * d)),
        "final_out": zeros((d, c_in)),
        "final_norm": L.rmsnorm_init(d, dev),
    }
    def keep(stack):
        return stack if experts is None else stack[experts].clone()

    blocks = []
    for _ in range(cfg.num_layers):
        moe = {
            "router": dense((d, E), dtype=torch.float32),
            "experts_gate": keep(dense((E, d, f))),
            "experts_up": keep(dense((E, d, f))),
            "experts_down": keep(dense((E, f, d))),
        }
        if cfg.num_shared_experts:
            fs = f * cfg.num_shared_experts
            moe["shared_gate"] = dense((d, fs))
            moe["shared_up"] = dense((d, fs))
            moe["shared_down"] = dense((fs, d))
        blocks.append({
            "ln1": L.rmsnorm_init(d, dev),
            "ln2": L.rmsnorm_init(d, dev),
            "attn": {"wq": dense((d, H * Dh)),
                     "wk": dense((d, KVH * Dh)),
                     "wv": dense((d, KVH * Dh)),
                     "wo": dense((H * Dh, d))},
            "moe": moe,
            "adaln": zeros((d, 6 * d)),
        })
    params["blocks"] = blocks
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def dit_forward(params, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
                cfg, states: Dict[int, stale_lib.MoELayerState], *,
                plan: plan_lib.StepPlan,
                generator: Optional[torch.Generator] = None,
                slot_fresh: Optional[torch.Tensor] = None,
                consume_mask: Optional[torch.Tensor] = None,
                mesh=None, hop_schedule=None, obs=None, resilience=None,
                fault_key: Optional[int] = None,
                patch_states: Optional[Dict[int, PatchParallelState]] = None,
                patch_parallel_ndev: int = 0, patch_compose: bool = False,
                patch_fresh=None, expert_pool=None):
    """Velocity prediction.

    x: (B, T, C_in) latents; t: (B,) times; y: (B,) class ids
    (``cfg.num_classes`` = null class).  The schedule enters via ``plan``
    (one step of :func:`~repro_torch.core.plan.compile_step_plans`).
    ``slot_fresh`` (B*T,) / ``consume_mask`` (B*T, K) are the continuous
    engine's per-slot warmup-replay selectors, passed to every MoE layer.

    Over a ``mesh`` x is the rank's (B_loc, T_loc, C_in) block: its lane's
    batch rows and, on a ``patch`` axis, its patch's tokens (``pos_embed``
    is sliced at the patch offset).  The MoE layers exchange tokens over
    the rank's ep group (``mesh.ep_mesh``; locally without one), in
    ``hop_schedule``'s order on the ring.  The token means of the aux
    (``lb_loss``, ``dropped_frac``, ``expert_counts``) are averaged over
    every rank in one all-reduce of one stacked tensor per call, and
    ``buffer_bytes`` counts every rank's buffers, while ``dispatch_bytes``
    stays the per-rank payload.

    Patch parallelism, in three forms: ``patch_parallel_ndev`` alone is the
    replicated DistriFusion simulation (displaced patch attention, the MoE
    run locally and fresh, no staleness state); with ``patch_compose`` the
    same attention composed with the schedule's MoE path, the one-device
    numerics reference of the sharded axis; a mesh ``patch`` axis runs
    :func:`~repro_torch.core.patch_parallel.sharded_patch_attention`, with
    ``patch_fresh`` ((B_loc,) bools) selecting all-fresh K/V rows (the
    simulation does not run over a mesh: ``RFStep`` refuses it).
    ``patch_states`` holds the layers' K/V buffers; ``buffer_bytes`` counts
    them too.

    An enabled ``obs`` adds ``aux["telemetry"]``, the (L, NUM_FIELDS)
    staleness block stacked on the device (the shard mean over a mesh,
    in the same all-reduce), and names each layer's action in a profiler
    range.  ``resilience`` adds ``aux["fault_events"]``, the
    (NUM_FAULT_EVENTS,) counts summed over layers (and over ranks);
    ``fault_key`` is the pass's corruption-mask coordinate.

    ``expert_pool`` (:class:`~repro_torch.core.paging.ExpertPool`) backs a
    plan whose actions carry a paging spec: ``params`` hold no ``experts_*``
    stacks (:func:`~repro_torch.core.paging.strip_expert_params`), and
    before layer ``i``'s attention the pool fetches layer ``i``'s shard (a
    no-op past layer 0: the previous layer prefetched it) and the plan's
    ``prefetch``, so the copy runs behind the attention and the wire.  The
    MoE runs on the pool's padded wire (``e_loc x ep``), waits for its
    shard's copy first and marks the slot free after.  Returns (v,
    new_states, new_patch_states, aux dict)."""
    ep_mesh = mesh.ep_mesh if mesh is not None else None
    paged = any(a.paging is not None for a in plan.actions)
    if paged and expert_pool is None:
        raise ValueError("the plan carries expert paging but no expert_pool "
                         "was provided (pass a repro_torch.core.paging."
                         "ExpertPool, or normalize the config with "
                         "normalize_paging)")
    if paged and ep_mesh is None:
        raise ValueError("expert paging needs a live ep mesh axis")
    fetched = {}

    def ensure_fetched(j: int):
        if j not in fetched:
            fetched[j] = expert_pool.fetch(j, ep_mesh.rank)
    B, T, _ = x.shape
    d = cfg.d_model
    sharded_patch = mesh is not None and "patch" in mesh.axis_names
    pos_embed = params["pos_embed"]
    if sharded_patch:
        off = mesh.rank_in("patch") * T
        pos_embed = pos_embed[off:off + T]
    h = x @ params["patch_embed"] + pos_embed[None]
    temb = timestep_embedding(t) @ params["t_mlp1"]
    temb = F.silu(temb) @ params["t_mlp2"]
    c = temb + params["class_embed"][y.long()]      # (B, d)
    positions = torch.arange(T, device=x.device)[None, :].expand(B, T)

    new_states: Dict[int, stale_lib.MoELayerState] = {}
    new_patch: Dict[int, PatchParallelState] = {}
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lbs, drops, served, terms, telems = [], [], [], [], []
    fault_events = None
    total_dispatch_bytes = 0
    total_raw_bytes = 0
    ring_hops = 0
    total_hop_bytes = 0
    for i, blk in enumerate(params["blocks"]):
        action = plan.actions[i]
        if paged and action.paging is not None:
            # this layer's fetch and the depth-ahead prefetch go on the copy
            # stream before the attention, so the copies run behind it
            ensure_fetched(i)
            if action.prefetch is not None:
                ensure_fetched(action.prefetch)
        mod = F.silu(c) @ blk["adaln"]              # (B, 6d)
        s1, sc1, g1, s2, sc2, g2 = torch.chunk(mod, 6, dim=-1)

        hn = _modulate(L.rmsnorm(blk["ln1"], h, eps=cfg.norm_eps), s1, sc1)
        if patch_parallel_ndev or sharded_patch:
            a = blk["attn"]
            q = (hn @ a["wq"]).reshape(B, T, H, Dh)
            k = (hn @ a["wk"]).reshape(B, T, KVH, Dh)
            v = (hn @ a["wv"]).reshape(B, T, KVH, Dh)
            pstate = (patch_states or {}).get(i, PatchParallelState())
            if sharded_patch:
                attn, new_patch[i] = sharded_patch_attention(
                    q, k, v, pstate, mesh=mesh, fresh=patch_fresh)
            else:
                attn, new_patch[i] = displaced_patch_attention(
                    q, k, v, pstate, n_dev=patch_parallel_ndev,
                    warmup=plan.is_warmup)
            attn = attn.reshape(B, T, H * Dh) @ a["wo"]
        else:
            attn, _ = L.attn_apply(blk["attn"], hn, positions, cfg,
                                   causal=False)
        h = h + g1[:, None, :] * attn

        hn = _modulate(L.rmsnorm(blk["ln2"], h, eps=cfg.norm_eps), s2, sc2)
        tokens = hn.reshape(B * T, d)
        if patch_parallel_ndev and not patch_compose:
            # DistriFusion replicates the model: the MoE runs locally, fresh
            with obs_telemetry.scope(obs, f"moe_l{i:02d}_distrifusion"):
                moe_out, aux = moe_lib.moe_forward(
                    blk["moe"], tokens, cfg, obs=obs, resilience=resilience,
                    fault_salt=i, fault_key=fault_key)
            new_st = stale_lib.MoELayerState()
        else:
            moe_p, wire_E, slot = blk["moe"], None, None
            if paged and action.paging is not None:
                slot = fetched.pop(i)
                moe_p = dict(moe_p, **slot.acquire())
                wire_E = expert_pool.e_loc * ep_mesh.size
            with obs_telemetry.scope(obs, f"moe_l{i:02d}_{action.mode}"):
                moe_out, new_st, aux = stale_lib.apply_layer_action(
                    moe_p, tokens, cfg, action, states[i],
                    generator=generator, slot_fresh=slot_fresh,
                    consume_mask=consume_mask, mesh=ep_mesh,
                    hop_schedule=hop_schedule, obs=obs,
                    resilience=resilience, layer_idx=i, fault_key=fault_key,
                    num_wire_experts=wire_E)
            if slot is not None:
                slot.release()
        new_states[i] = new_st
        lbs.append(aux.lb_loss)
        terms.append(aux.lb_terms)
        drops.append(aux.dropped_frac)
        served.append(aux.served_counts.to(torch.float32))
        total_dispatch_bytes += aux.dispatch_bytes
        total_raw_bytes += aux.raw_dispatch_bytes
        ring_hops = max(ring_hops, aux.hops)
        total_hop_bytes += aux.hop_bytes
        telems.append(aux.telemetry)
        if aux.fault_events is not None:
            fault_events = aux.fault_events if fault_events is None \
                else fault_events + aux.fault_events
        h = h + g2[:, None, :] * moe_out.reshape(B, T, d).to(h.dtype)

    fmod = F.silu(c) @ params["final_mod"]
    fs, fsc = torch.chunk(fmod, 2, dim=-1)
    h = _modulate(L.rmsnorm(params["final_norm"], h, eps=cfg.norm_eps), fs, fsc)
    v = h @ params["final_out"]
    counts = torch.stack(served)                       # (L, E)
    telemetry = torch.stack(telems) if obs is not None and obs.enabled \
        else None                                     # (L, NUM_FIELDS)
    buffer_bytes = stale_lib.state_bytes(new_states) \
        + sum(p.bytes() for p in new_patch.values())
    if mesh is not None:
        # one all-reduce for the step's token means: the lb terms of every
        # MoE call, the drop fractions, the served-pair histogram, the
        # telemetry block and the fault counts (a mean times the ranks)
        calls = [t.shape[0] for t in terms]
        extra = [x.reshape(-1) for x in (telemetry, fault_events)
                 if x is not None]
        flat = mesh.all_reduce_mean(torch.cat(
            [torch.cat(terms).reshape(-1), torch.stack(drops),
             counts.reshape(-1)] + extra))
        n_terms = sum(calls) * 2 * cfg.num_experts
        terms = flat[:n_terms].reshape(-1, 2, cfg.num_experts).split(calls)
        lbs = [moe_lib.lb_from_terms(t, cfg.experts_per_token) for t in terms]
        drops = flat[n_terms:n_terms + len(calls)].unbind()
        at = n_terms + len(calls)
        counts = flat[at:at + counts.numel()].reshape(counts.shape)
        at += counts.numel()
        if telemetry is not None:
            telemetry = flat[at:at + telemetry.numel()].reshape(
                telemetry.shape)
            at += telemetry.numel()
        if fault_events is not None:
            fault_events = torch.round(flat[at:] * mesh.world_size)
        buffer_bytes *= mesh.world_size
    aux_out = {
        "lb_loss": sum(lbs) / cfg.num_layers,
        "dispatch_bytes": total_dispatch_bytes,
        "raw_dispatch_bytes": total_raw_bytes,
        "hops": ring_hops,
        "hop_bytes": total_hop_bytes,
        "dropped_frac": sum(drops) / cfg.num_layers,
        "buffer_bytes": buffer_bytes,
        "expert_counts": counts,
    }
    if telemetry is not None:
        aux_out["telemetry"] = telemetry
    if fault_events is not None:
        aux_out["fault_events"] = fault_events
    return v, new_states, new_patch, aux_out


# ---------------------------------------------------------------------------
# training-mode forward (synchronous, differentiable)
# ---------------------------------------------------------------------------
def dit_train_forward(params, x: torch.Tensor, t: torch.Tensor,
                      y: torch.Tensor, cfg):
    """The training forward, as the reference's ``dit_train_forward``: step
    0 of the synchronous schedule (``DiceConfig.sync_ep()``), fresh layer
    states, no generator, no mesh, telemetry and resilience off.  Every
    operation on the way is differentiable: the kernels go through their
    autograd Functions when grad is on, and ``aux["lb_loss"]`` carries its
    gradient through the router's mean probabilities.  Returns (v, aux)."""
    plan = plan_lib.plan_for_step(DiceConfig.sync_ep(), cfg.num_layers, 0,
                                  experts_per_token=cfg.experts_per_token)
    states = {i: stale_lib.MoELayerState() for i in range(cfg.num_layers)}
    v, _, _, aux = dit_forward(params, x, t, y, cfg, states, plan=plan)
    return v, aux
