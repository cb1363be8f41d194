"""DistriFusion baseline: displaced patch (sequence) parallelism (port of
``repro.core.patch_parallel``).

DistriFusion (Li et al., CVPR'24) replicates the whole model on every
device and splits the latent patches: each device attends with fresh keys
and values for its own patch shard and with the previous diffusion step's
for every other shard.  Remote patches are one step stale, the model is
replicated, and every attention layer keeps a full-sequence K/V buffer:
the memory cost DICE is set against.

Two forms, both through the ``flash_attention`` kernel:

* :func:`displaced_patch_attention`, the replicated simulation on one
  device: for each owner ``p``, the queries of shard ``p`` (a contiguous
  row range) attend to the stale K/V with shard ``p``'s fresh rows spliced
  in: ``n_dev`` launches of ``S / n_dev`` queries against ``S`` keys,
  whose outputs are disjoint row ranges of one output;
* :func:`sharded_patch_attention`, one rank of a mesh's ``patch`` axis:
  one all-gather of the rank's fresh K and V over the patch group gives
  the full fresh K/V (the warm-up input and the next step's buffer), the
  rank's own rows are spliced into the stale buffer, and one launch
  attends its ``T_loc`` queries to all ``S`` keys.

Neither applies RoPE, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import ops


@dataclass
class PatchParallelState:
    """One attention layer's buffer of the last step's full-sequence K, V."""
    k_prev: Optional[torch.Tensor] = None   # (B, S, KVH, Dh)
    v_prev: Optional[torch.Tensor] = None

    def bytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.k_prev, self.v_prev) if a is not None)


def shard_owner(seq_len: int, n_dev: int,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """(S,) owner device of each patch position, contiguous and balanced:
    shard sizes differ by at most one for any ``S`` (9 positions over 4
    devices give 3/2/2/2, never a starved device)."""
    return (torch.arange(seq_len, device=device) * n_dev) // seq_len


def shard_bounds(seq_len: int, n_dev: int) -> List[Tuple[int, int]]:
    """The ``[lo, hi)`` position range of each owner of :func:`shard_owner`:
    owner ``p`` holds the positions ``i`` with ``i * n // S == p``."""
    return [(-(-p * seq_len // n_dev), -(-(p + 1) * seq_len // n_dev))
            for p in range(n_dev)]


def displaced_patch_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, state: PatchParallelState, *,
                              n_dev: int, warmup: bool):
    """Non-causal attention with per-shard stale remote K/V.

    q (B, S, H, Dh), k/v (B, S, KVH, Dh).  On warm-up, or with no state,
    every key is fresh.  Otherwise one stacked (B, S, 2, KVH, Dh) copy of
    the stale K/V takes each owner's fresh rows in one copy before the
    owner's launch and gives them back in one after it (stream order keeps
    the launch reading the spliced buffer).  Each launch writes its owner's
    rows of the output in place.  Returns (out, new state holding this
    step's fresh K/V)."""
    S = q.shape[1]
    out = torch.empty_like(q)
    fresh = warmup or state.k_prev is None
    if not fresh:
        stale = torch.stack([state.k_prev, state.v_prev], dim=2)
        kv_new = torch.stack([k, v], dim=2)
        kv = stale.clone()
    for lo, hi in shard_bounds(S, n_dev):
        if lo == hi:
            continue
        if fresh:
            ops.flash_attention(q[:, lo:hi], k, v, out=out[:, lo:hi])
            continue
        kv[:, lo:hi] = kv_new[:, lo:hi]
        ops.flash_attention(q[:, lo:hi], kv[:, :, 0], kv[:, :, 1],
                            out=out[:, lo:hi])
        kv[:, lo:hi] = stale[:, lo:hi]
    return out, PatchParallelState(k_prev=k, v_prev=v)


def gather_patches(t: torch.Tensor, mesh) -> torch.Tensor:
    """(B, T_loc, ...) shards of the patch group -> (B, P * T_loc, ...) in
    patch order.  ``mesh.patch_all_gather`` stacks along dim 0, so the
    shard axis is moved next to the token dim before the reshape (a plain
    reshape would interleave the shards)."""
    P = mesh.patch_size
    g = mesh.patch_all_gather(t.contiguous())          # (P * B, T_loc, ...)
    g = g.reshape((P,) + tuple(t.shape)).movedim(0, 1)  # (B, P, T_loc, ...)
    return g.reshape((t.shape[0], P * t.shape[1]) + tuple(t.shape[2:]))


def sharded_patch_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, state: PatchParallelState, *,
                            mesh, fresh: torch.Tensor):
    """Displaced patch attention on one rank of ``mesh``'s patch axis.

    q (B_loc, T_loc, H, Dh) and k/v (B_loc, T_loc, KVH, Dh) are this rank's
    patch shard; ``state`` holds the previous step's full-sequence K/V
    (B_loc, S, KVH, Dh).  One all-gather of the stacked K and V over the
    patch group gives the fresh full K/V, which is the new state (equal on
    every rank of the group).  Queries attend to their own shard's keys
    fresh (spliced into the stale buffer at ``rank_in("patch") * T_loc``)
    and to the others' from the buffer, per row the owner-``p`` math of
    :func:`displaced_patch_attention`.  ``fresh`` ((B_loc,) bools)
    selects all-fresh K/V per row: warm-up steps and step 0, whose buffer
    holds zeros."""
    T_loc = q.shape[1]
    # one exchange for both: (B, T_loc, 2, KVH, Dh) -> (B, S, 2, KVH, Dh)
    kv = gather_patches(torch.stack([k, v], dim=2), mesh)
    k_gath, v_gath = kv[:, :, 0], kv[:, :, 1]
    sel = fresh.to(device=q.device, dtype=torch.bool).reshape(-1, 1, 1, 1)
    k_full = torch.where(sel, k_gath, state.k_prev)
    v_full = torch.where(sel, v_gath, state.v_prev)
    off = mesh.rank_in("patch") * T_loc
    k_full[:, off:off + T_loc] = k
    v_full[:, off:off + T_loc] = v
    out = ops.flash_attention(q, k_full, v_full)
    return out, PatchParallelState(k_prev=k_gath, v_prev=v_gath)
