"""Shared layers of the port's models (the parts of ``repro.models.layers``
that the DiT-MoE and RWKV-6 paths use): init helpers, RMS norm, RoPE,
attention and the f32 cross-entropy.  Params are plain dicts of tensors in
the JAX package's layout: a projection weight is (in, out) and applies as
``x @ w``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops


def dense_init(gen: torch.Generator, shape, *, scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal draw from ``gen`` on its device, times ``scale`` (default
    1/sqrt(fan_in), fan-in the second-to-last dim: leading dims stack
    experts or layers).  Drawn in f32, then cast."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).mul_(scale).to(dtype)


def rmsnorm_init(d: int, device=None):
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with a zero-initialised scale applied as ``1 + scale``."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * (1.0 + params["scale"])
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding, half-split (not interleaved).
    x: (..., S, H, Dh); positions broadcastable to (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, window: Optional[int] = None,
              softcap: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention, q (B, Sq, H, Dh), k/v (B, Sk, KVH, Dh).

    On CUDA tensors this is the hand-written flash kernel; on the CPU its
    plain version.  For the DiT's inputs (no window, no KV cache) it is the
    function of the JAX package's dense ``layers.attention``.  A window here
    is symmetric when not causal, as in the flash kernel."""
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)


def attn_apply(p, x: torch.Tensor, positions: torch.Tensor, cfg, *,
               causal: bool = True, window: Optional[int] = None):
    """Self-attention block: projections, RoPE on q and k, attention, output
    projection.  Returns (out, (k, v))."""
    B, S, _ = x.shape
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, Dh)
    k = (x @ p["wk"]).reshape(B, S, KVH, Dh)
    v = (x @ p["wv"]).reshape(B, S, KVH, Dh)
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    q = rope(q, positions, theta=cfg.rope_theta)
    k = rope(k, positions, theta=cfg.rope_theta)
    out = attention(q, k, v, causal=causal, window=window,
                    softcap=cfg.attn_logit_softcap)
    return out.reshape(B, S, H * Dh) @ p["wo"], (k, v)


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy, computed in f32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()
