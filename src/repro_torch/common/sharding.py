"""Sharding of params, batches and image tokens over the serving and
training meshes (port of ``repro.common.sharding``).

On a mesh (:mod:`repro_torch.launch.mesh`) each rank keeps rows
``[i * e_loc, (i + 1) * e_loc)`` of every routed-expert stack (the leaves
named ``experts_*``), ``i`` its index on the ``ep`` axis, so each dp and
patch group holds the experts once; and a full copy of everything else
(router, shared experts, attention, embeddings, hot-expert replicas
``experts_*_rep``).  The batch shards over ``dp x ep`` (the rank's
"lane", dp-major), the image tokens over ``patch``.  The reference
expresses the same layout as ``PartitionSpec``\\ s; here a spec is the
axis name or ``None``.

The training mesh (:class:`~repro_torch.launch.mesh.TrainMesh`) keeps the
reference's rules: :func:`param_spec`, :func:`tree_param_specs`,
:func:`opt_state_spec` and :func:`batch_spec` return a spec as a tuple with
one entry per dim, ``"model"``, ``"data"`` or ``None``, the entries of the
reference's ``PartitionSpec``.  Two layouts place an LM on it:

* ``train_lm``'s, the reference's ``train_lm``: only the stacked routed
  experts cut over ``model`` (:func:`shard_lm_experts`);
* the reference dry run's, tensor parallelism: every leaf cut to its
  ``param_spec`` slice (:func:`shard_lm_params`, which
  :func:`gather_lm_params` puts back), and the AdamW moments also cut over
  ``data`` by ``opt_state_spec`` (ZeRO, :func:`shard_lm_moments`).  The
  models find which leaves a rank holds cut by their shapes
  (:func:`held_cuts`; ``models/dense.tensor_parallel``).
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
            f"'ep' mesh axis for expert parallelism, or enable expert "
            f"paging (DiceConfig.paging), whose pool pads the wire so any "
            f"expert count serves on any mesh")
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


# ---------------------------------------------------------------------------
# the training mesh's rules (the reference's param_spec & co.)
# ---------------------------------------------------------------------------
def batch_spec(mesh) -> Any:
    """The spec entry of the batch dim: ``("pod", "data")`` when the mesh
    has a ``pod`` axis, else ``"data"``."""
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def _divisible(dim: int, mesh, axis: str) -> bool:
    return axis in mesh.axis_names and dim % mesh.shape[axis] == 0


# (leaf names, the dim they shard over "model") of the 2-D projections, in
# the reference's order
_PROJECTION_RULES = (
    (("wq", "wkv_a", "w_qkv", "wk", "wv", "wq_s", "wk_s", "wv_s"), 1),
    (("wo",), 0),
    (("w_in", "w_gate", "w_up"), 1),
    (("w_out", "w_down"), 0),
    (("embed", "unembed", "lm_head"), 0),
    (("w_xz", "w_inner_up"), 1),
    (("w_inner_down",), 0),
)


def param_spec(path: str, shape, mesh) -> Tuple[Any, ...]:
    """Rule-based spec of the param at ``path`` ('/'-joined tree path) of
    ``shape`` on ``mesh`` (anything with ``axis_names`` and ``shape``): one
    entry per dim, ``"model"`` or ``None``.  The rules match the leaf names
    the models use, in the reference's order: routed experts on their
    expert dim (dim 1 of a layer-stacked (L, E, d, f) leaf), the 2-D
    projections and the vocab on their head / hidden / vocab dim, then a
    stacked leaf on its largest trailing dim that divides, then a 2-D leaf
    on its last dim that divides, else replicated."""
    name = path.split("/")[-1]
    ndim = len(shape)

    def ok(i):
        return _divisible(shape[i], mesh, "model")

    def on(i):
        return tuple("model" if j == i else None for j in range(ndim))

    if name.startswith(("experts_", "moe_")) or "expert" in path:
        e_dim = 1 if ndim >= 4 else 0
        if ndim >= 2 and ok(e_dim):
            return on(e_dim)
    for names, dim in _PROJECTION_RULES:
        if name in names and ndim == 2 and ok(dim):
            return on(dim)
    if ndim >= 3:
        for i in sorted(range(1, ndim), key=lambda i: -shape[i]):
            if ok(i):
                return on(i)
    if ndim == 2:
        for i in (1, 0):
            if ok(i):
                return on(i)
    return (None,) * ndim


def tree_param_specs(params, mesh):
    """The tree of ``params`` with each leaf (anything with a ``shape``)
    replaced by its :func:`param_spec`."""
    def walk(node, names):
        if isinstance(node, dict):
            return {k: walk(v, names + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, names + (str(i),))
                              for i, v in enumerate(node))
        return param_spec("/".join(names), tuple(node.shape), mesh)
    return walk(params, ())


def opt_state_spec(pspec, shape, mesh) -> Tuple[Any, ...]:
    """ZeRO: the param's spec with its largest unsharded dim that divides
    over ``data`` sharded over ``data`` as well."""
    parts = list(pspec) + [None] * (len(shape) - len(pspec))
    cand = [i for i, p in enumerate(parts)
            if p is None and _divisible(shape[i], mesh, "data")]
    if cand:
        parts[max(cand, key=lambda i: shape[i])] = "data"
    return tuple(parts)


# ---------------------------------------------------------------------------
# the LMs' routed experts on a training mesh
# ---------------------------------------------------------------------------
def _names(path) -> Tuple[str, ...]:
    if isinstance(path, str):
        return tuple(n for n in path.replace("/", ".").split(".") if n)
    return tuple(path)


def is_lm_expert(path) -> bool:
    """Whether ``path`` (a '/'- or '.'-joined tree path, or its names) is a
    stacked routed-expert leaf of an LM, ``.../moe/experts_*``: the leaves
    a training mesh shards over ``model``."""
    names = _names(path)
    return len(names) >= 2 and names[-2] == "moe" \
        and names[-1].startswith("experts_")


def is_lm_token_local(path) -> bool:
    """Whether ``path`` is a leaf that ``moe_forward`` applies to the
    rank's own tokens on a training mesh (the router and the shared
    experts), of whose gradient each ``model`` rank holds a share."""
    names = _names(path)
    return len(names) >= 2 and names[-2] == "moe" \
        and names[-1].startswith(("router", "shared_"))


def lm_expert_slice(num_experts: int, mesh) -> slice:
    """The experts this rank holds on a training mesh, its slice along
    ``model``; raises unless they divide."""
    n, i = _axis(mesh, "model")
    if num_experts % n:
        raise ValueError(f"num_experts={num_experts} must divide over the "
                         f"{n}-way 'model' mesh axis for expert parallelism")
    e_loc = num_experts // n
    return slice(i * e_loc, (i + 1) * e_loc)


def shard_lm_experts(params, mesh):
    """``params`` with every stacked expert leaf (L, E, ...) cut to this
    rank's experts on dim 1 (``ep_shard_params`` cuts dim 0, the layer axis
    here); the cut is a copy, so the full stack can be freed, and the other
    leaves are the same tensors."""
    def walk(node, names):
        if isinstance(node, dict):
            return {k: walk(v, names + (str(k),)) for k, v in node.items()}
        if is_lm_expert(names) and mesh.shape["model"] > 1:
            return node[:, lm_expert_slice(node.shape[1], mesh)].clone()
        return node
    return walk(params, ())


def gather_lm_experts(params, mesh):
    """The inverse of :func:`shard_lm_experts`: every stacked expert leaf
    all-gathered over ``model`` on dim 1 (a collective: every rank of the
    group calls it)."""
    def walk(node, names):
        if isinstance(node, dict):
            return {k: walk(v, names + (str(k),)) for k, v in node.items()}
        if is_lm_expert(names):
            return mesh.model_gather(node, dim=1)
        return node
    return walk(params, ())


# ---------------------------------------------------------------------------
# the LMs under the reference's specs (tensor parallelism, ZeRO)
# ---------------------------------------------------------------------------
def tree_items(tree, names=()):
    """(path, leaf) of a nested dict in key order (JAX's flattening
    order), ``path`` '/'-joined."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_items(tree[k], names + (str(k),))]
    return [("/".join(names), tree)]


def _map(fn, tree, *rest, names=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), names=names + (str(k),))
                for k, v in tree.items()}
    return fn("/".join(names), tree, *rest)


def tree_map_leaves(fn, tree):
    """``fn`` of every leaf of a nested dict."""
    return _map(lambda path, t: fn(t), tree)


def _model_dim(spec) -> Optional[int]:
    return spec.index("model") if "model" in spec else None


def lm_param_cuts(params, mesh):
    """The tree of ``params`` (whole leaves, or anything with a ``shape``)
    with each leaf replaced by the dim its :func:`param_spec` cuts over
    ``model``, None where it is whole."""
    return _map(lambda path, t: _model_dim(param_spec(path, tuple(t.shape), mesh)),
                params)


def held_cuts(params, whole, cuts):
    """``cuts`` (:func:`lm_param_cuts` of the whole tree ``whole``) where a
    rank's ``params`` hold the leaf cut (its shape differs from the whole
    leaf's), None where they hold it whole."""
    return _map(lambda path, t, w, c: None if tuple(t.shape) == tuple(w.shape) else c,
                params, whole, cuts)


def _cut(t: torch.Tensor, dim: Optional[int], n: int, i: int) -> torch.Tensor:
    if dim is None or n == 1:
        return t
    k = t.shape[dim] // n
    return t.narrow(dim, i * k, k).clone()


def shard_lm_params(params, mesh):
    """``params`` (whole) with every leaf cut to this rank's slice of its
    :func:`param_spec` over ``model`` (the routed experts on their expert
    dim, as :func:`shard_lm_experts`; the reference dry run's
    ``tree_param_specs`` placement).  The cuts are copies, so the whole
    tree can be freed; a leaf the spec leaves whole is the same tensor."""
    n, i = _axis(mesh, "model")
    return _map(lambda path, t, c: _cut(t, c, n, i), params,
                lm_param_cuts(params, mesh))


def gather_lm_params(params, mesh, cuts):
    """The inverse of :func:`shard_lm_params`: every leaf with a cut dim in
    ``cuts`` (:func:`held_cuts`) all-gathered over ``model`` (a collective:
    every rank of the group calls it)."""
    return _map(lambda path, t, c: t if c is None else mesh.model_gather(t, c),
                params, cuts)


def lm_moment_dims(params, mesh):
    """The tree of ``params`` (whole) with each leaf replaced by the dim
    ``opt_state_spec`` cuts its AdamW moments over ``data`` (ZeRO), None
    where they are not cut."""
    def dim(path, t):
        spec = opt_state_spec(param_spec(path, tuple(t.shape), mesh),
                              tuple(t.shape), mesh)
        return spec.index("data") if "data" in spec else None
    return _map(dim, params)


def shard_lm_moments(state, dims, mesh):
    """An AdamW state whose moments (shaped like a rank's params) are cut
    to this rank's slice over ``data`` on ``dims`` (:func:`lm_moment_dims`):
    each rank of a data group then updates its slice of each leaf
    (``optim.adamw.adamw_update``)."""
    n, i = _axis(mesh, "data")
    cut = lambda path, t, d: _cut(t, d, n, i)  # noqa: E731
    return type(state)(step=state.step, mu=_map(cut, state.mu, dims),
                       nu=_map(cut, state.nu, dims))
