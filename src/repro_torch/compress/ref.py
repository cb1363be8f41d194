"""Plain PyTorch reference codecs (port of ``repro.compress.ref``).

Each codec maps a residual tensor ``r`` with rows along the last axis to a
compact wire representation and back.  The reconstruction, not the raw
value, is what the receiver sees and what the staleness cache stores as
the next step's residual base, so encode/decode are deterministic.

  int8  r -> (q int8, scale f32)   per-row symmetric scale, |err| <= scale/2

The reference's top-k codec is not in this slice of the port.

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
    q = torch.clamp(torch.round(r / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
