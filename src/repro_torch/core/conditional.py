"""Token-level Conditional Communication (paper Sec. 4.3, Alg. 4); port of
``repro.core.conditional``.

MoE output is the router-score-weighted sum y_i = sum_e s_i^e h_i^e, so a
staleness perturbation on h propagates in proportion to the score.  The
top-1 (token, expert) pair is always transmitted fresh; lower-ranked pairs
reuse their cached expert output and refresh only every ``stride`` steps.
"refresh" steps dispatch all K ranks, "light" steps only rank-0 pairs into
a K-times-smaller buffer.
"""
from __future__ import annotations

from typing import Optional

import torch


def is_refresh_step(step: int, stride: int) -> bool:
    return stride <= 1 or (step % stride == 0)


def policy_mask(policy: str, num_tokens: int, k: int, *,
                device: Optional[torch.device] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(T, K) bool: which (token, rank) pairs are transmitted on a light step.

    policy "low"    — deprioritise low-score (non-top-1) pairs  [paper's choice]
    policy "high"   — deprioritise the top-1 pair                [ablation]
    policy "random" — deprioritise a random half of pairs, drawn from the
                      explicit ``generator``                     [ablation]
    """
    if policy == "random":
        if generator is None:
            raise ValueError("the 'random' policy draws from an explicit "
                             "torch.Generator; pass generator=")
        return torch.rand((num_tokens, k), generator=generator,
                          device=generator.device) < 0.5
    ranks = torch.arange(k, device=device)[None, :].expand(num_tokens, k)
    if policy == "low":
        return ranks == 0
    if policy == "high":
        return ranks != 0
    raise ValueError(f"unknown cond_policy: {policy}")


def policy_effective_k(policy: str, k: int) -> int:
    """Ranks dispatched on a light step (sizes the dispatch buffer)."""
    if policy == "low":
        return 1
    if policy == "high":
        return k - 1
    if policy == "random":
        return max(1, k // 2)
    raise ValueError(f"unknown cond_policy: {policy}")


def fresh_mask(step: int, num_tokens: int, k: int, *, stride: int,
               policy: str = "low", device: Optional[torch.device] = None,
               generator: Optional[torch.Generator] = None
               ) -> Optional[torch.Tensor]:
    """Step-indexed form of :func:`policy_mask`; ``None`` on refresh steps
    (everything fresh)."""
    if is_refresh_step(step, stride):
        return None
    return policy_mask(policy, num_tokens, k, device=device,
                       generator=generator)


def effective_k(step: int, k: int, *, stride: int, policy: str = "low") -> int:
    """Ranks actually dispatched this step (sizes the dispatch buffer)."""
    if is_refresh_step(step, stride):
        return k
    return policy_effective_k(policy, k)


def comm_volume_fraction(k: int, stride: int, policy: str = "low", *,
                         light_scale: float = 1.0) -> float:
    """Long-run mean all-to-all volume relative to full dispatch.

    ``light_scale`` (<= 1) scales the light steps' per-rank volume: the
    wire codec's compression ratio (``CodecSpec.wire_ratio``) when light
    payloads travel as quantized residuals and refresh steps stay
    lossless."""
    if stride <= 1:
        return 1.0
    kf = {"low": 1, "high": k - 1, "random": k / 2}[policy]
    # a refresh step sends k ranks fresh; the other (stride-1) steps send
    # kf ranks, each at the codec's light-step wire ratio
    return (k + (stride - 1) * kf * light_scale) / (stride * k)


def expected_dispatch_fraction(k: int, stride: int, policy: str,
                               capacity_of) -> float:
    """:func:`comm_volume_fraction` in buffer slots: the long-run mean
    dispatch payload relative to full dispatch given the floor-aligned
    capacities the plan allocates.  ``capacity_of(k) -> int`` maps an
    effective rank count to the per-expert capacity."""
    if stride <= 1:
        return 1.0
    c_full = capacity_of(k)
    c_light = capacity_of(policy_effective_k(policy, k))
    return (c_full + (stride - 1) * c_light) / (stride * c_full)


def update_cache(h_cache: Optional[torch.Tensor], pair_vals: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Keep fresh pair outputs, retain cached values for stale pairs."""
    if mask is None or h_cache is None:
        return pair_vals
    return torch.where(mask[..., None], pair_vals, h_cache)
