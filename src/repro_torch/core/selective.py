"""Layer-level Selective Synchronization (paper Sec. 4.2); a copy of
``repro.core.selective``.

Deeper MoE layers handle high-level semantics and are more vulnerable to
staleness; synchronizing only those recovers most of the quality at a
fraction of the blocking cost.  Policies match the paper's ablation
(Table 4): deep / shallow / staggered / none.
"""
from __future__ import annotations

import numpy as np


def sync_layer_mask(policy: str, num_layers: int, *,
                    fraction: float = 0.5) -> np.ndarray:
    """Boolean (num_layers,): True = run this MoE layer synchronously.

    Every policy protects ``round(num_layers * fraction)`` layers:
      none      — no layer
      deep      — the deepest k layers
      shallow   — the shallowest k layers
      staggered — every-other layers (odd offsets 1, 3, 5, ...), taking the
                  DEEPEST k of that alternating set; if the budget exceeds
                  the alternating set, the deepest remaining even-offset
                  layers fill the difference
      all       — every layer (``fraction`` ignored)
    """
    mask = np.zeros(num_layers, dtype=bool)
    k = int(round(num_layers * fraction))
    if policy == "none":
        pass
    elif policy == "deep":
        mask[num_layers - k:] = True
    elif policy == "shallow":
        mask[:k] = True
    elif policy == "staggered":
        cand = list(range(1, num_layers, 2))
        if k <= len(cand):
            chosen = cand[len(cand) - k:]
        else:
            rest = [i for i in range(num_layers) if i not in cand]
            chosen = cand + rest[len(rest) - (k - len(cand)):]
        mask[chosen] = True
    elif policy == "all":
        mask[:] = True
    else:
        raise ValueError(f"unknown sync policy: {policy}")
    return mask


def sync_overhead_fraction(policy: str, num_layers: int, *,
                           fraction: float = 0.5) -> float:
    """Fraction of MoE layers whose collectives block."""
    return float(sync_layer_mask(policy, num_layers, fraction=fraction).mean())
