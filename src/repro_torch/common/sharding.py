"""Sharding of params, batches and image tokens over the serving mesh
(port of the serving part of ``repro.common.sharding``).

On a mesh (:mod:`repro_torch.launch.mesh`) each rank keeps rows
``[i * e_loc, (i + 1) * e_loc)`` of every routed-expert stack (the leaves
named ``experts_*``), ``i`` its index on the ``ep`` axis, so each dp and
patch group holds the experts once; and a full copy of everything else
(router, shared experts, attention, embeddings, hot-expert replicas
``experts_*_rep``).  The batch shards over ``dp x ep`` (the rank's
"lane", dp-major), the image tokens over ``patch``.  The reference
expresses the same layout as ``PartitionSpec``\\ s; here a spec is the
axis name or ``None``.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.core import placement as placement_lib

# hierarchical serving mesh axes, outermost first
HIER_AXES = ("dp", "ep", "patch")


def batch_shard_axes(mesh) -> Tuple[str, ...]:
    """The axes the request batch shards over: ``dp``, then ``ep``;
    ``patch`` shards the image tokens instead."""
    return tuple(a for a in ("dp", "ep") if a in mesh.axis_names)


def data_shard_axes(mesh) -> Tuple[str, ...]:
    """Every axis data tensors shard over: the axes a batch mean (the
    load-balance terms, the aux means) must span."""
    return tuple(a for a in HIER_AXES if a in mesh.axis_names)


def _axis(mesh, name: str) -> Tuple[int, int]:
    """(size, this rank's index) of ``name`` on ``mesh``; (1, 0) when the
    axis is absent."""
    if mesh is None or name not in mesh.axis_names:
        return 1, 0
    return mesh.shape[name], mesh.rank_in(name)


def ep_param_specs(params, *, ep_axis: Optional[str] = "ep"):
    """The tree of ``params`` with each leaf replaced by its spec: ``"ep"``
    for a routed-expert stack, ``None`` (replicated) for the rest.  Like the
    reference, ``ep_axis=None`` replicates everything and hot-expert
    replica stacks (``*_rep``) stay replicated."""
    def walk(node, names):
        if isinstance(node, dict):
            return {k: walk(v, names + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, names + (str(i),)) for i, v in enumerate(node)]
        if ep_axis is None or any(n.endswith("_rep") for n in names):
            return None
        return ep_axis if any(n.startswith("experts_") for n in names) \
            else None
    return walk(params, ())


def expert_slice(num_experts: int, mesh) -> slice:
    """The expert rows this rank owns (its slice along ``ep``; all of
    them without an ep axis); raises unless the experts divide over it."""
    n, i = _axis(mesh, "ep")
    if num_experts % n:
        raise ValueError(
            f"num_experts={num_experts} must divide over the {n}-way "
            f"'ep' mesh axis for expert parallelism (expert paging, which "
            f"lifts this in the reference, is not ported: ROADMAP A.9)")
    e_loc = num_experts // n
    return slice(i * e_loc, (i + 1) * e_loc)


def ep_shard_params(params, mesh):
    """This rank's params on ``mesh.device``: its slice of every routed-
    expert stack, a full copy of the rest.  Each stack is sliced before it
    moves, so only the local rows reach the device.  The expert count is
    the width of the sibling ``router``; a stack that already has the
    local width is taken as it is, so re-sharding a sharded tree is a
    no-op."""
    specs = ep_param_specs(params)

    def walk(node, spec, num_experts):
        if isinstance(node, dict):
            if "router" in node and any(k.startswith("experts_") for k in node):
                num_experts = node["router"].shape[-1]
            return {k: walk(v, spec[k], num_experts) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, s, num_experts) for v, s in zip(node, spec)]
        if spec is not None and num_experts is not None \
                and node.shape[0] == num_experts:
            node = node[expert_slice(num_experts, mesh)]
        return node.to(mesh.device)
    return walk(params, specs, None)


def hier_place_batch(a: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a batch-leading array (latents, classes,
    per-slot selectors), on ``mesh.device``: the batch shards over the
    ``dp x ep`` lanes."""
    axes = " x ".join(f"{mesh.shape[a]}-way '{a}'"
                      for a in batch_shard_axes(mesh)) or "1-way 'ep'"
    if a.shape[0] % mesh.lanes:
        raise ValueError(f"batch {a.shape[0]} must divide over the {axes} "
                         f"mesh axis")
    return a[local_rows(a.shape[0], mesh)].to(mesh.device)


# the flat ep mesh's name for the same layout
ep_place_batch = hier_place_batch


def hier_place_tokens(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's (B_loc, T_loc, ...) block of a (B, T, ...) latent: its
    lane's batch rows and, on a patch axis, its patch's tokens;
    ``mesh.gather_samples`` puts the blocks back together."""
    x = hier_place_batch(x, mesh)
    return x[:, local_tokens(x.shape[1], mesh)]


def local_rows(n: int, mesh: Any) -> slice:
    """The slice of ``n`` batch rows this rank holds: its lane's (all of
    them without a mesh)."""
    if mesh is None:
        return slice(0, n)
    b = n // mesh.lanes
    return slice(mesh.lane * b, (mesh.lane + 1) * b)


def local_tokens(n: int, mesh: Any) -> slice:
    """The slice of ``n`` image tokens this rank holds: its patch's (all
    of them without a patch axis); raises unless they divide."""
    p, i = _axis(mesh, "patch")
    if n % p:
        raise ValueError(f"patch_tokens={n} must divide over the {p}-way "
                         f"'patch' mesh axis")
    t = n // p
    return slice(i * t, (i + 1) * t)


def place_experts(params, placements: Sequence[Optional[
        "placement_lib.Placement"]], mesh):
    """This rank's expert shards re-laid-out under ``placements`` (one per
    MoE layer, model order): for each placed layer the ep group's stacks
    are all-gathered (one layer at a time, so only one layer's full stacks
    exist at once), permuted into the placement's wire order
    (:func:`~repro_torch.core.placement.place_moe_params`), and sliced to
    this rank's rows, with the replicated ``experts_*_rep`` stacks kept
    whole.  ``params`` are in the original layout and ep-sharded; layers
    whose placement is None or the identity keep their shards."""
    ep = mesh.ep_mesh
    it = iter(placements)
    own = None

    def walk(node):
        nonlocal own
        if isinstance(node, dict):
            if all(k in node for k in placement_lib._MOE_LEAVES):
                pl = next(it, None)
                if pl is None or pl.is_identity:
                    return node
                full = {k: ep.all_gather(node[k])
                        for k in placement_lib._MOE_LEAVES}
                placed = placement_lib.place_moe_params(full, pl)
                own = own or expert_slice(full["experts_gate"].shape[0],
                                          mesh)
                out = dict(node)
                for k, v in placed.items():
                    if k.startswith("experts_"):
                        out[k] = v if k.endswith("_rep") else \
                            v[own].clone()
                return out
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    out = walk(params)
    if next(it, False) is not False:
        raise ValueError("more placements than the model has MoE layers")
    return out
