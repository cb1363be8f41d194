"""Plain PyTorch versions of the three CUDA kernels.

They compute the same functions as the kernels under ``csrc/`` and as the
JAX package's oracles in ``repro.kernels.ref`` / ``repro.compress.ref``.
The kernel wrappers in :mod:`repro_torch.kernels.ops` run them for tensors
on the CPU; on the card they are what each kernel is held against.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.compress.ref import INT8_EPS, int8_decode, int8_encode

NEG_INF = -1e30


def act_fn(act: str):
    """silu, or gelu with the tanh approximation (``jax.nn.gelu``'s
    default)."""
    if act == "silu":
        return F.silu
    if act == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {act!r}")


def expert_ffn_ref(buf, w_gate, w_up, w_down, *, act: str = "silu"):
    """Grouped gated MLP over per-expert token buffers, f32 accumulate.

    buf: (E, C, d); w_gate/w_up: (E, d, f); w_down: (E, f, d) -> (E, C, d).
    """
    x = buf.to(torch.float32)
    g = act_fn(act)(torch.matmul(x, w_gate.to(torch.float32)))
    u = torch.matmul(x, w_up.to(torch.float32))
    out = torch.matmul(g * u, w_down.to(torch.float32))
    return out.to(buf.dtype)


def attention_mask(Sq: int, Sk: int, *, causal: bool, window,
                   device) -> torch.Tensor:
    """(Sq, Sk) bool: key j visible to query i.  A window is symmetric when
    the attention is not causal."""
    pq = torch.arange(Sq, device=device)[:, None]
    pk = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= pq >= pk
    if window is not None:
        mask &= (pq - pk) < window
        if not causal:
            mask &= (pk - pq) < window
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = False, window=None,
                        softcap=None):
    """q: (B, Sq, H, Dh); k, v: (B, Sk, KVH, Dh) -> (B, Sq, H, Dh).

    GQA maps query head h to kv head ``h // (H // KVH)``.  Masked logits are
    -1e30, not -inf, so a fully masked row gives the mean of V."""
    B, Sq, H, Dh = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, Dh).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                     k.to(torch.float32)) / math.sqrt(Dh)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(Sq, Sk, causal=causal, window=window,
                          device=q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def residual_int8_ref(value, base, *, eps: float = INT8_EPS):
    """Fused wire-codec quantize-pack: (N, d) payload + residual base ->
    (q int8 (N, d), scale f32 (N, 1), recon (N, d) value.dtype) with
    ``recon = base + q * scale``; the quantizer is
    :func:`repro_torch.compress.ref.int8_encode`."""
    b = base.to(torch.float32)
    q, scale = int8_encode(value.to(torch.float32) - b, eps=eps)
    recon = (b + int8_decode(q, scale)).to(value.dtype)
    return q, scale, recon
