"""Synthetic data (port of ``repro.data.synthetic``).

Two streams:
  * ``token_batches``: drawn with numpy exactly as the JAX package draws
    it, so the same seed gives the same tokens in both packages; only the
    container type differs (torch tensors here).
  * ``gaussian_mixture_latents`` / ``latent_batches``: class-conditional
    latent "images" for training the DiT-MoE of the quality experiments.
    The deterministic part (each class's spatial sin/cos pattern) is the
    reference's; its three JAX PRNG draws (classes, channel mix, noise)
    cannot be replayed in torch, so they are inputs the tests hand over,
    or drawn from a ``torch.Generator`` seeded by ``seed``.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple, Union

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


def latent_draws(generator: torch.Generator, *, batch: int, tokens: int,
                 channels: int, num_classes: int) -> dict:
    """The three random inputs of :func:`gaussian_mixture_latents`, on
    ``generator``'s device: ``classes`` uniform in ``[0, num_classes)``,
    ``chan_mix`` (1, 1, channels) and ``noise`` (batch, tokens, channels)
    standard normal (the reference's distributions)."""
    kw = dict(generator=generator, device=generator.device)
    classes = torch.randint(0, num_classes, (batch,), **kw)
    chan_mix = torch.randn((1, 1, channels), **kw)
    noise = torch.randn((batch, tokens, channels), **kw)
    return {"classes": classes, "chan_mix": chan_mix, "noise": noise}


def gaussian_mixture_latents(*, classes: torch.Tensor, chan_mix: torch.Tensor,
                             noise: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-conditional structured latents (B, tokens, channels) f32 from
    the draws (``classes`` (B,), ``chan_mix`` (1, 1, C) and ``noise``
    (B, T, C), both standard normal), as the reference builds them."""
    tokens = noise.shape[1]
    side = int(np.sqrt(tokens))
    pos = torch.arange(tokens, dtype=torch.float32, device=noise.device)
    row, col = torch.div(pos, side, rounding_mode="floor"), pos % side
    freqs = classes[:, None].to(torch.float32) + 1.0          # (B, 1)
    base = (torch.sin(row[None, :] * freqs * 0.7)[..., None]
            * torch.cos(col[None, :] * freqs * 0.4)[..., None])   # (B, T, 1)
    x = base * (1.0 + chan_mix.to(torch.float32) * 0.3) \
        + 0.1 * noise.to(torch.float32)
    return x.to(torch.float32), classes


def latent_batches(*, batch: int, tokens: int, channels: int,
                   num_classes: int, seed: int = 0,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Iterator[dict]:
    """Infinite iterator of {latents, classes}, drawn on ``device`` (the
    CPU unless given) from a generator seeded by ``seed``."""
    gen = torch.Generator(device=torch.device(device or "cpu")).manual_seed(seed)
    while True:
        x, classes = gaussian_mixture_latents(**latent_draws(
            gen, batch=batch, tokens=tokens, channels=channels,
            num_classes=num_classes))
        yield {"latents": x, "classes": classes}
