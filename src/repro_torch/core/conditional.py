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


def update_cache(h_cache: Optional[torch.Tensor], pair_vals: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Keep fresh pair outputs, retain cached values for stale pairs."""
    if mask is None or h_cache is None:
        return pair_vals
    return torch.where(mask[..., None], pair_vals, h_cache)
