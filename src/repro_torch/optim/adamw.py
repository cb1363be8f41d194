"""AdamW, gradient clipping and the cosine LR schedule (port of
``repro.optim.adamw``), over the port's nested dicts of tensors.

The arithmetic and its order are the reference's: f32 moments, bias
corrections ``1 - b ** t`` on an f32 step, weight decay on every leaf added
inside the update (``lr * (mhat / (sqrt(vhat) + eps) + wd * p)``), and the
clip scale ``min(1, max_norm / (norm + 1e-9))``.  ``torch.optim.AdamW``
decays the weights in a separate multiply, which rounds differently, so it
is not used.  Every value stays on the device: the step, the learning rate
and the norm are 0-d tensors, and nothing here waits for the card.

The moments and the params are updated in place (same arithmetic as the
reference's new arrays); the functions still return the updated trees and
state, so callers read like the reference's.

ZeRO: where a moment is cut over a training mesh's ``data`` axis
(``common/sharding.shard_lm_moments``, the reference's ``opt_state_spec``)
the rank updates its slice of the param from its slice of the gradient and
all-gathers the param over the data group.  AdamW is elementwise, so the
param is bit for bit the one the whole moments give.
"""
from __future__ import annotations

import math
from typing import Any, List, NamedTuple

import torch

from repro_torch.checkpoint.io import flatten, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor     # () int32
    mu: Any                # tree like params (f32)
    nu: Any                # tree like params (f32)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in JAX's flattening order (dict keys sorted), so sums over
    the leaves run in the reference's order."""
    return [leaf for _, leaf in flatten(tree)[0]]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (all of one structure)."""
    cols = [tree_leaves(t) for t in (tree,) + rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = tree_leaves(params)
    dev = first[0].device if first else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def cosine_schedule(step: torch.Tensor, *, base_lr: float = 3e-4,
                    warmup: int = 100, total: int = 10_000) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return base_lr * torch.where(step < warmup, warm, cos)


def _zero_dim(m: torch.Tensor, p: torch.Tensor):
    """The dim a moment is cut on over ``data`` (the first where its shape
    differs from its param's), None where it is whole."""
    for i, (a, b) in enumerate(zip(m.shape, p.shape)):
        if a != b:
            return i
    return None


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.01, mesh=None):
    """One AdamW step.  ``params``, ``state.mu`` and ``state.nu`` are
    updated in place and returned with the new step.  A moment cut over
    ``data`` (ZeRO) updates this rank's slice of its param, which is then
    all-gathered over ``mesh``'s data group."""
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1 - torch.pow(b1, t)
    c2 = 1 - torch.pow(b2, t)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(params)):
        dim = _zero_dim(m, p)
        whole = p
        if dim is not None:
            if mesh is None:
                raise ValueError("adamw_update: moments cut over 'data' (ZeRO) "
                                 "need the training mesh")
            k = m.shape[dim]
            g = g.narrow(dim, mesh.rank_in("data") * k, k)
            p = p.narrow(dim, mesh.rank_in("data") * k, k)
        g32 = g.to(torch.float32)
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * torch.square(g32))
        mhat = m / c1
        vhat = v / c2
        delta = mhat / (torch.sqrt(vhat) + eps) \
            + weight_decay * p.to(torch.float32)
        new = (p.to(torch.float32) - lr * delta).to(p.dtype)
        if dim is None:
            p.copy_(new)
        else:
            whole.copy_(mesh.data_gather(new, dim))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def global_norm(tree, reduce=None) -> torch.Tensor:
    """The square root of the sum of every leaf's sum of squares, in leaf
    order.  ``reduce`` maps the list of per-leaf sums of squares to the
    list to add up (a sharded run adds the other ranks' squares of its
    sharded leaves there)."""
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree_leaves(tree)]
    if reduce is not None:
        sq = reduce(sq)
    return torch.sqrt(sum(sq))


def clip_by_global_norm(tree, max_norm: float, reduce=None):
    """(tree scaled by ``min(1, max_norm / (norm + 1e-9))``, norm);
    ``reduce`` as :func:`global_norm`."""
    norm = global_norm(tree, reduce)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda x: (x.to(torch.float32) * scale).to(x.dtype),
                    tree), norm
