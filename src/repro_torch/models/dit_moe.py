"""DiT-MoE: Diffusion Transformer with Mixture-of-Experts FFNs (port of
``repro.models.dit_moe``, single device).

adaLN-zero DiT blocks, an MoE FFN with top-k routed experts plus shared
experts, class-conditional with a null class for CFG.  The forward pass
takes per-MoE-layer staleness state (:mod:`repro_torch.core.staleness`)
and a precompiled :class:`~repro_torch.core.plan.StepPlan`, so one
implementation serves every schedule.  Patch parallelism, expert paging,
observability and resilience are not part of this slice.

Params are a plain dict in the JAX package's tree layout and (in, out)
weight orientation; :mod:`repro_torch.bridge` carries a JAX tree over.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

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
def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).mul_(scale).to(dtype)


def _dense(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """Normal init scaled by 1/sqrt(fan_in), fan-in the second-to-last dim."""
    return _normal(gen, shape, 1.0 / math.sqrt(shape[-2]), dtype)


def _zeros(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def init_dit(cfg, *, generator: torch.Generator,
             dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random params on ``generator.device``, in the layout of
    ``repro.models.dit_moe.init_dit`` (adaLN and the output layer zero-
    initialised).  The draws differ from JAX's for the same seed; to run
    the reference's weights use :func:`repro_torch.bridge.from_jax_params`.
    """
    g = generator
    d, c_in = cfg.d_model, cfg.in_channels
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    E, f = cfg.num_experts, cfg.expert_d_ff
    params: Dict[str, Any] = {
        "patch_embed": _dense(g, (c_in, d), dtype),
        "pos_embed": _normal(g, (cfg.patch_tokens, d), 0.02, dtype),
        "t_mlp1": _dense(g, (256, d), dtype),
        "t_mlp2": _dense(g, (d, d), dtype),
        "class_embed": _normal(g, (cfg.num_classes + 1, d), 0.02, dtype),
        "final_mod": _zeros(g, (d, 2 * d), dtype),
        "final_out": _zeros(g, (d, c_in), dtype),
        "final_norm": {"scale": _zeros(g, (d,))},
    }
    blocks = []
    for _ in range(cfg.num_layers):
        moe = {
            "router": _dense(g, (d, E), torch.float32),
            "experts_gate": _dense(g, (E, d, f), dtype),
            "experts_up": _dense(g, (E, d, f), dtype),
            "experts_down": _dense(g, (E, f, d), dtype),
        }
        if cfg.num_shared_experts:
            fs = f * cfg.num_shared_experts
            moe["shared_gate"] = _dense(g, (d, fs), dtype)
            moe["shared_up"] = _dense(g, (d, fs), dtype)
            moe["shared_down"] = _dense(g, (fs, d), dtype)
        blocks.append({
            "ln1": {"scale": _zeros(g, (d,))},
            "ln2": {"scale": _zeros(g, (d,))},
            "attn": {"wq": _dense(g, (d, H * Dh), dtype),
                     "wk": _dense(g, (d, KVH * Dh), dtype),
                     "wv": _dense(g, (d, KVH * Dh), dtype),
                     "wo": _dense(g, (H * Dh, d), dtype)},
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
                generator: Optional[torch.Generator] = None):
    """Velocity prediction.

    x: (B, T, C_in) latents; t: (B,) times; y: (B,) class ids
    (``cfg.num_classes`` = null class).  The schedule enters via ``plan``
    (one step of :func:`~repro_torch.core.plan.compile_step_plans`).
    Returns (v, new_states, aux dict)."""
    B, T, _ = x.shape
    d = cfg.d_model
    h = x @ params["patch_embed"] + params["pos_embed"][None]
    temb = timestep_embedding(t) @ params["t_mlp1"]
    temb = F.silu(temb) @ params["t_mlp2"]
    c = temb + params["class_embed"][y.long()]      # (B, d)
    positions = torch.arange(T, device=x.device)[None, :].expand(B, T)

    new_states: Dict[int, stale_lib.MoELayerState] = {}
    total_lb = 0.0
    total_dispatch_bytes = 0
    total_raw_bytes = 0
    dropped = 0.0
    for i, blk in enumerate(params["blocks"]):
        mod = F.silu(c) @ blk["adaln"]              # (B, 6d)
        s1, sc1, g1, s2, sc2, g2 = torch.chunk(mod, 6, dim=-1)

        hn = _modulate(L.rmsnorm(blk["ln1"], h, eps=cfg.norm_eps), s1, sc1)
        attn, _ = L.attn_apply(blk["attn"], hn, positions, cfg, causal=False)
        h = h + g1[:, None, :] * attn

        hn = _modulate(L.rmsnorm(blk["ln2"], h, eps=cfg.norm_eps), s2, sc2)
        moe_out, new_st, aux = stale_lib.apply_layer_action(
            blk["moe"], hn.reshape(B * T, d), cfg, plan.actions[i], states[i],
            generator=generator)
        new_states[i] = new_st
        total_lb = total_lb + aux.lb_loss
        total_dispatch_bytes += aux.dispatch_bytes
        total_raw_bytes += aux.raw_dispatch_bytes
        dropped = dropped + aux.dropped_frac
        h = h + g2[:, None, :] * moe_out.reshape(B, T, d).to(h.dtype)

    fmod = F.silu(c) @ params["final_mod"]
    fs, fsc = torch.chunk(fmod, 2, dim=-1)
    h = _modulate(L.rmsnorm(params["final_norm"], h, eps=cfg.norm_eps), fs, fsc)
    v = h @ params["final_out"]
    aux_out = {
        "lb_loss": total_lb / cfg.num_layers,
        "dispatch_bytes": total_dispatch_bytes,
        "raw_dispatch_bytes": total_raw_bytes,
        "dropped_frac": dropped / cfg.num_layers,
        "buffer_bytes": stale_lib.state_bytes(new_states),
    }
    return v, new_states, aux_out
