"""Plain PyTorch reference codecs (port of ``repro.compress.ref``).

Each codec maps a residual tensor ``r`` with rows along the last axis to a
compact wire representation and back.  The reconstruction, not the raw
value, is what the receiver sees and what the staleness cache stores as
the next step's residual base, so encode/decode are deterministic.

  int8  r -> (q int8, scale f32)   per-row symmetric scale, |err| <= scale/2
  topk  r -> (vals, idx int32)     keep the largest-|.| fraction, rest -> 0

``torch.round`` rounds half to even, like ``jnp.round``.
"""
from __future__ import annotations

import torch

INT8_EPS = 1e-8


def int8_encode(r: torch.Tensor, *, eps: float = INT8_EPS):
    """r: (..., d) f32 residual -> (q int8 (..., d), scale f32 (..., 1))."""
    amax = r.abs().amax(dim=-1, keepdim=True)
    # amax * f32(1/127), not amax / 127: XLA compiles the JAX package's
    # division by the constant into this product, and the CUDA kernel does
    # the same, so all three agree to the bit
    scale = torch.clamp_min(amax * (1.0 / 127.0), eps).to(torch.float32)
    q = torch.clamp(torch.round(r / scale), -127.0, 127.0)
    # a NaN quotient (a row holding NaN or Inf) casts to 0, as it does in
    # JAX; made explicit because a float NaN cast to int is undefined in C++
    q = torch.nan_to_num(q, nan=0.0).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def topk_encode(r: torch.Tensor, keep: int):
    """Keep the ``keep`` largest-magnitude entries of each row.

    Returns (vals (..., keep), idx int32 (..., keep)); kept entries are
    sent exactly, everything else decodes to 0.  Among equal magnitudes
    the lower index comes first, as in ``jax.lax.top_k``: the first
    ``keep`` of a stable descending sort, where ``torch.topk`` leaves the
    order of ties unspecified.  Ties are common: a row the guard replaced
    by its base has an all-zero residual."""
    idx = torch.sort(r.abs(), dim=-1, descending=True,
                     stable=True).indices[..., :keep]
    return torch.take_along_dim(r, idx, dim=-1), idx.to(torch.int32)


def topk_decode(vals: torch.Tensor, idx: torch.Tensor, d: int) -> torch.Tensor:
    out = torch.zeros(vals.shape[:-1] + (d,), dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_(-1, idx.to(torch.int64), vals)


def int8_roundtrip(r: torch.Tensor, *, eps: float = INT8_EPS) -> torch.Tensor:
    """What the receiver of an int8-coded ``r`` reconstructs."""
    q, scale = int8_encode(r, eps=eps)
    return int8_decode(q, scale)


def topk_roundtrip(r: torch.Tensor, keep: int) -> torch.Tensor:
    """What the receiver of a top-``keep``-coded ``r`` reconstructs."""
    vals, idx = topk_encode(r, keep)
    return topk_decode(vals, idx, r.shape[-1])
