"""The work of each hand-written kernel, and the ledger the dry run reads.

A kernel's FLOPs and bytes are what ``PERF.md``'s bound column counts
(``chip_smoke.py`` phase 3 computes the same numbers from its inputs):

* ``expert_ffn``: the three products, ``6 E C d f``; bytes: buf and the
  three weight stacks read once, the output written once;
* ``expert_ffn_bwd``: the six products of the gradients, ``12 E C d f``
  (the kernel also recomputes G and U, two more, which the bound does
  not count); bytes: the five inputs read once, the four gradients
  written once;
* ``flash_attention``: ``4 Dh`` a kept (query, key) pair and head (QK^T and
  PV); bytes: q, k, v read once, o written once, plus the row log-sum-exp
  and the f32 output when the forward keeps them for the backward;
* ``flash_attention_bwd``: 2.5 times the forward's FLOPs over the same
  pairs; bytes: q, k, v, the f32 o, lse and do read once, dq, dk, dv
  written once;
* ``residual_int8``: 5 operations an element (residual, magnitude, scale,
  round, reconstruction); bytes: value and base read, q, scale and recon
  written;
* ``rwkv6_scan``: 5 operations an element of the (DK, DK) state a step
  (decay, outer product, readout); ``rwkv6_scan_bwd``: 12.  Bytes: each
  input read once, each output written once.

Kept pairs: every (i, j) with ``j <= q_offset + i`` when causal and
``q_offset + i - j < window`` under a one-sided window.  Key positions
(``k_pos``) are data: where they are given the count takes every slot as
kept, the most the call can need.

The kernel wrappers of :mod:`repro_torch.kernels.ops`, given ``meta``
tensors (the dry run), run no kernel and no plain version: they allocate
what the card would hold and append one :class:`KernelCost` to
:data:`LEDGER`.  ``ops.LAUNCHES`` counts the card's launches only.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, NamedTuple, Optional


class KernelCost(NamedTuple):
    """One kernel call on ``meta``: its name, FLOPs and bytes."""
    name: str
    flops: float
    bytes: float


LEDGER: List[KernelCost] = []


def record(name: str, flops: float, nbytes: float) -> None:
    LEDGER.append(KernelCost(name, float(flops), float(nbytes)))


def nbytes(*tensors) -> int:
    """Bytes of the tensors given (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def expert_ffn_flops(E: int, C: int, d: int, f: int) -> float:
    return 6.0 * E * C * d * f


def expert_ffn_bwd_flops(E: int, C: int, d: int, f: int) -> float:
    return 12.0 * E * C * d * f


@lru_cache(maxsize=None)
def kept_pairs(Sq: int, Sk: int, *, causal: bool, window: Optional[int] = None,
               q_offset: int = 0, one_sided_window: bool = False,
               k_pos_given: bool = False) -> int:
    """(query, key) pairs the kernel keeps, per batch row and head."""
    if k_pos_given:
        return Sq * Sk
    total = 0
    for i in range(Sq):
        p = q_offset + i
        hi = min(Sk, p + 1) if causal else Sk          # keys [lo, hi)
        lo = 0
        if window is not None:
            lo = max(0, p - window + 1)
            if not causal and not one_sided_window:     # symmetric window
                hi = min(hi, p + window)
        total += max(0, hi - lo)
    return total


def flash_flops(B: int, H: int, Dh: int, pairs: int) -> float:
    return 4.0 * B * H * Dh * pairs


def flash_bwd_flops(B: int, H: int, Dh: int, pairs: int) -> float:
    return 2.5 * flash_flops(B, H, Dh, pairs)


def residual_int8_flops(N: int, d: int) -> float:
    return 5.0 * N * d


def rwkv6_scan_flops(B: int, H: int, T: int, DK: int) -> float:
    return 5.0 * B * H * T * DK * DK


def rwkv6_scan_bwd_flops(B: int, H: int, T: int, DK: int) -> float:
    return 12.0 * B * H * T * DK * DK
