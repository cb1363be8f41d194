"""DiT-MoE: Diffusion Transformer with Mixture-of-Experts FFNs (port of
``repro.models.dit_moe``).

adaLN-zero DiT blocks, an MoE FFN with top-k routed experts plus shared
experts, class-conditional with a null class for CFG.  The forward pass
takes per-MoE-layer staleness state (:mod:`repro_torch.core.staleness`)
and a precompiled :class:`~repro_torch.core.plan.StepPlan`, so one
implementation serves every schedule, on one device or on one rank of an
expert-parallel mesh.  Patch parallelism, expert paging, observability and
resilience are not ported yet.

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
from repro_torch.models import layers as L


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
def _zeros(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def init_dit(cfg, *, generator: torch.Generator,
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
    """
    g = generator
    d, c_in = cfg.d_model, cfg.in_channels
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    E, f = cfg.num_experts, cfg.expert_d_ff
    params: Dict[str, Any] = {
        "patch_embed": L.dense_init(g, (c_in, d), dtype=dtype),
        "pos_embed": L.dense_init(g, (cfg.patch_tokens, d), scale=0.02,
                                   dtype=dtype),
        "t_mlp1": L.dense_init(g, (256, d), dtype=dtype),
        "t_mlp2": L.dense_init(g, (d, d), dtype=dtype),
        "class_embed": L.dense_init(g, (cfg.num_classes + 1, d), scale=0.02,
                                     dtype=dtype),
        "final_mod": _zeros(g, (d, 2 * d), dtype),
        "final_out": _zeros(g, (d, c_in), dtype),
        "final_norm": L.rmsnorm_init(d, g.device),
    }
    def keep(stack):
        return stack if experts is None else stack[experts].clone()

    blocks = []
    for _ in range(cfg.num_layers):
        moe = {
            "router": L.dense_init(g, (d, E), dtype=torch.float32),
            "experts_gate": keep(L.dense_init(g, (E, d, f), dtype=dtype)),
            "experts_up": keep(L.dense_init(g, (E, d, f), dtype=dtype)),
            "experts_down": keep(L.dense_init(g, (E, f, d), dtype=dtype)),
        }
        if cfg.num_shared_experts:
            fs = f * cfg.num_shared_experts
            moe["shared_gate"] = L.dense_init(g, (d, fs), dtype=dtype)
            moe["shared_up"] = L.dense_init(g, (d, fs), dtype=dtype)
            moe["shared_down"] = L.dense_init(g, (fs, d), dtype=dtype)
        blocks.append({
            "ln1": L.rmsnorm_init(d, g.device),
            "ln2": L.rmsnorm_init(d, g.device),
            "attn": {"wq": L.dense_init(g, (d, H * Dh), dtype=dtype),
                     "wk": L.dense_init(g, (d, KVH * Dh), dtype=dtype),
                     "wv": L.dense_init(g, (d, KVH * Dh), dtype=dtype),
                     "wo": L.dense_init(g, (H * Dh, d), dtype=dtype)},
            "moe": moe,
            "adaln": _zeros(g, (d, 6 * d), dtype),
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
                mesh=None):
    """Velocity prediction.

    x: (B, T, C_in) latents; t: (B,) times; y: (B,) class ids
    (``cfg.num_classes`` = null class).  The schedule enters via ``plan``
    (one step of :func:`~repro_torch.core.plan.compile_step_plans`).
    ``slot_fresh`` (B*T,) / ``consume_mask`` (B*T, K) are the continuous
    engine's per-slot warmup-replay selectors, passed to every MoE layer.

    Over an ep ``mesh`` the batch is the rank's shard and the MoE layers
    exchange tokens with the other ranks.  The token means of the aux
    (``lb_loss``, ``dropped_frac``, ``expert_counts``) are then averaged
    over the ranks in one all-reduce of one stacked tensor per call, and
    ``buffer_bytes`` counts every rank's buffers, while ``dispatch_bytes``
    stays the per-rank payload.  Returns (v, new_states, aux dict)."""
    B, T, _ = x.shape
    d = cfg.d_model
    h = x @ params["patch_embed"] + params["pos_embed"][None]
    temb = timestep_embedding(t) @ params["t_mlp1"]
    temb = F.silu(temb) @ params["t_mlp2"]
    c = temb + params["class_embed"][y.long()]      # (B, d)
    positions = torch.arange(T, device=x.device)[None, :].expand(B, T)

    new_states: Dict[int, stale_lib.MoELayerState] = {}
    lbs, drops, served, terms = [], [], [], []
    total_dispatch_bytes = 0
    total_raw_bytes = 0
    ring_hops = 0
    total_hop_bytes = 0
    for i, blk in enumerate(params["blocks"]):
        mod = F.silu(c) @ blk["adaln"]              # (B, 6d)
        s1, sc1, g1, s2, sc2, g2 = torch.chunk(mod, 6, dim=-1)

        hn = _modulate(L.rmsnorm(blk["ln1"], h, eps=cfg.norm_eps), s1, sc1)
        attn, _ = L.attn_apply(blk["attn"], hn, positions, cfg, causal=False)
        h = h + g1[:, None, :] * attn

        hn = _modulate(L.rmsnorm(blk["ln2"], h, eps=cfg.norm_eps), s2, sc2)
        moe_out, new_st, aux = stale_lib.apply_layer_action(
            blk["moe"], hn.reshape(B * T, d), cfg, plan.actions[i], states[i],
            generator=generator, slot_fresh=slot_fresh,
            consume_mask=consume_mask, mesh=mesh)
        new_states[i] = new_st
        lbs.append(aux.lb_loss)
        terms.append(aux.lb_terms)
        drops.append(aux.dropped_frac)
        served.append(aux.served_counts.to(torch.float32))
        total_dispatch_bytes += aux.dispatch_bytes
        total_raw_bytes += aux.raw_dispatch_bytes
        ring_hops = max(ring_hops, aux.hops)
        total_hop_bytes += aux.hop_bytes
        h = h + g2[:, None, :] * moe_out.reshape(B, T, d).to(h.dtype)

    fmod = F.silu(c) @ params["final_mod"]
    fs, fsc = torch.chunk(fmod, 2, dim=-1)
    h = _modulate(L.rmsnorm(params["final_norm"], h, eps=cfg.norm_eps), fs, fsc)
    v = h @ params["final_out"]
    counts = torch.stack(served)                       # (L, E)
    buffer_bytes = stale_lib.state_bytes(new_states)
    if mesh is not None:
        # one all-reduce for the step's token means: the lb terms of every
        # MoE call, the drop fractions and the served-pair histogram
        calls = [t.shape[0] for t in terms]
        flat = mesh.all_reduce_mean(torch.cat(
            [torch.cat(terms).reshape(-1), torch.stack(drops),
             counts.reshape(-1)]))
        n_terms = sum(calls) * 2 * cfg.num_experts
        terms = flat[:n_terms].reshape(-1, 2, cfg.num_experts).split(calls)
        lbs = [moe_lib.lb_from_terms(t, cfg.experts_per_token) for t in terms]
        drops = flat[n_terms:n_terms + len(calls)].unbind()
        counts = flat[n_terms + len(calls):].reshape(counts.shape)
        buffer_bytes *= mesh.size
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
    return v, new_states, aux_out
