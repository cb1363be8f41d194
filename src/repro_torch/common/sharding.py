"""Expert-parallel sharding of params and batches (port of the flat-ep
part of ``repro.common.sharding``).

Each rank of an :class:`~repro_torch.launch.mesh.EPMesh` keeps rows
``[r * e_loc, (r + 1) * e_loc)`` of every routed-expert stack (the leaves
named ``experts_*``) and a full copy of everything else (router, shared
experts, attention, embeddings), and rows ``[r * b_loc, (r + 1) * b_loc)``
of every batch-leading array.  The reference expresses the same layout as
``PartitionSpec``\\ s; here a spec is the axis name or ``None``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch


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
    """The expert rows rank ``mesh.rank`` owns; raises unless the experts
    divide over the mesh."""
    if num_experts % mesh.size:
        raise ValueError(
            f"num_experts={num_experts} must divide over the {mesh.size}-way "
            f"'ep' mesh axis for expert parallelism (expert paging, which "
            f"lifts this in the reference, is not ported: ROADMAP A.9)")
    e_loc = num_experts // mesh.size
    return slice(mesh.rank * e_loc, (mesh.rank + 1) * e_loc)


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


def ep_place_batch(a: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a batch-leading array (latents, classes,
    per-slot selectors), on ``mesh.device``; ``mesh.all_gather`` puts
    them back together."""
    if a.shape[0] % mesh.size:
        raise ValueError(f"batch {a.shape[0]} must divide over the "
                         f"{mesh.size}-way 'ep' mesh axis")
    return a[local_rows(a.shape[0], mesh)].to(mesh.device)


def local_rows(n: int, mesh: Any) -> slice:
    """The slice of ``n`` batch rows rank ``mesh.rank`` holds (all of them
    without a mesh)."""
    if mesh is None:
        return slice(0, n)
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)
