"""Synthetic token streams (port of ``repro.data.synthetic.token_batches``).

The stream is drawn with numpy exactly as the JAX package draws it, so the
same seed gives the same tokens in both packages; only the container type
differs (torch tensors here).
"""
from __future__ import annotations

from typing import Iterator, Optional, Union

import numpy as np
import torch


def token_batches(vocab_size: int, batch: int, seq_len: int, *,
                  seed: int = 0,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> Iterator[dict]:
    """Infinite iterator of {tokens, labels} int32 (batch, seq_len) with
    learnable bigram structure, on ``device`` (the CPU unless given)."""
    rng = np.random.default_rng(seed)
    # sparse bigram transition table: each token has 8 likely successors
    succ = rng.integers(0, vocab_size, size=(min(vocab_size, 4096), 8))
    while True:
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab_size, size=batch)
        for t in range(seq_len):
            prev = toks[:, t] % succ.shape[0]
            pick = succ[prev, rng.integers(0, 8, size=batch)]
            noise = rng.integers(0, vocab_size, size=batch)
            use_noise = rng.random(batch) < 0.1
            toks[:, t + 1] = np.where(use_noise, noise, pick)
        t = torch.from_numpy(toks).to(device)
        yield {"tokens": t[:, :-1], "labels": t[:, 1:]}
