"""FID proxy for synthetic-latent experiments (port of
``repro.metrics.fid_proxy``).

The estimator is the Fréchet distance between Gaussian fits of feature
distributions; the feature network is a fixed random 2-layer MLP over the
flattened latents, so staleness shows up as a monotone rise of the proxy
(ordering, not absolute values).  The reference draws the MLP's two weight
matrices from ``jax.random.PRNGKey(seed)``, which torch cannot replay:
every function here takes them as ``weights=(w1, w2)`` (the tests pass the
reference's), else draws them from ``torch.Generator().manual_seed(seed)``
with the reference's shapes and scales.  The rest is the reference's numpy.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

FEATURE_SEED = 1234


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def feature_weights(in_dim: int, *, dim: int = 64, seed: int = FEATURE_SEED
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w1 (in_dim, 128), w2 (128, dim)), standard normal over sqrt(fan-in),
    on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    w1 = torch.randn((in_dim, 128), generator=gen) / np.sqrt(in_dim)
    w2 = torch.randn((128, dim), generator=gen) / np.sqrt(128)
    return w1, w2


def _feature_net(x, *, dim: int = 64, seed: int = FEATURE_SEED,
                 weights: Optional[Tuple] = None) -> np.ndarray:
    """x: (N, T, C) -> (N, dim) fixed random features, f32 on the CPU."""
    x = torch.from_numpy(np.ascontiguousarray(_host(x), np.float32))
    flat = x.reshape(x.shape[0], -1)
    if weights is None:
        w1, w2 = feature_weights(flat.shape[1], dim=dim, seed=seed)
    else:
        w1, w2 = (torch.from_numpy(np.array(_host(w), np.float32)) for w in weights)
    return (torch.tanh(flat @ w1) @ w2).numpy()


def feature_stats(x, *, weights: Optional[Tuple] = None):
    f = _feature_net(x, weights=weights)
    mu = f.mean(0)
    cov = np.cov(f, rowvar=False)
    return mu, cov


def _sqrtm_psd(a: np.ndarray) -> np.ndarray:
    w, v = np.linalg.eigh((a + a.T) / 2)
    w = np.clip(w, 0, None)
    return (v * np.sqrt(w)) @ v.T


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    diff = mu1 - mu2
    s = _sqrtm_psd(_sqrtm_psd(cov1) @ cov2 @ _sqrtm_psd(cov1))
    return float(diff @ diff + np.trace(cov1 + cov2 - 2 * s))


def fid_proxy(samples, reference, *, weights: Optional[Tuple] = None) -> float:
    """Fréchet distance between random-feature Gaussians of two sample sets."""
    m1, c1 = feature_stats(samples, weights=weights)
    m2, c2 = feature_stats(reference, weights=weights)
    return frechet_distance(m1, c1, m2, c2)


def mse_vs_reference(samples, reference) -> float:
    """Paired MSE against the synchronous-EP output (same seed/classes)."""
    a = _host(samples).astype(np.float64)
    b = _host(reference).astype(np.float64)
    return float(np.mean((a - b) ** 2))


def inception_score_proxy(samples, *, splits: int = 4,
                          weights: Optional[Tuple] = None) -> float:
    """IS analogue on random features: exp(mean KL(p(y|x) || p(y))) with a
    fixed random linear 'classifier' head over the feature net."""
    f = _feature_net(samples, weights=weights)
    rng = np.random.default_rng(4321)
    w = rng.normal(size=(f.shape[1], 16)) / np.sqrt(f.shape[1])
    logits = f @ w
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    scores = []
    n = len(p)
    for i in range(splits):
        part = p[i * n // splits:(i + 1) * n // splits]
        if not len(part):
            continue
        py = part.mean(0, keepdims=True)
        kl = (part * (np.log(part + 1e-12) - np.log(py + 1e-12))).sum(-1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores))


def precision_recall_proxy(samples, reference, *, k: int = 3,
                           weights: Optional[Tuple] = None):
    """Kynkaanniemi-style precision/recall on random features: a sample is
    'covered' if it lies within the k-NN radius of some point of the other
    set."""
    fs = _feature_net(samples, weights=weights)
    fr = _feature_net(reference, weights=weights)

    def knn_radius(x):
        d = np.linalg.norm(x[:, None] - x[None], axis=-1)
        d.sort(axis=1)
        return d[:, min(k, len(x) - 1)]

    def coverage(queries, manifold, radii):
        d = np.linalg.norm(queries[:, None] - manifold[None], axis=-1)
        return float((d <= radii[None]).any(axis=1).mean())

    precision = coverage(fs, fr, knn_radius(fr))   # fake inside real manifold
    recall = coverage(fr, fs, knn_radius(fs))      # real inside fake manifold
    return precision, recall
