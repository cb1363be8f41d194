"""Rank jobs of ``tests/test_torch_train_mesh.py``: functions that
``repro_torch.launch.mesh.spawn`` runs in each gloo rank of a training
mesh (imported by the ranks, not collected by pytest).

Each takes the reference's params as a numpy tree and the global batch as
numpy arrays, and returns from rank 0 what the test holds against the
reference: losses, every gradient leaf with the experts gathered over
``model``, the clipped norm, the params after one AdamW step, and digests
that show which leaves are bit-identical across ranks.
"""
import contextlib
import hashlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.checkpoint.io import flatten
from repro_torch.common import sharding as shard_lib
from repro_torch.configs import get_smoke
from repro_torch.launch import train
from repro_torch.models import dense
from repro_torch.models.api import get_model
from repro_torch.optim import adamw

MOE = "qwen3-moe-30b-a3b"
DENSE = "qwen3-32b"


def moe_cfg(capacity_factor=1.0):
    return get_smoke(MOE).replace(capacity_factor=capacity_factor)


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()


def _every_rank(value):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def _batch(arrays, mesh):
    rows = shard_lib.local_rows(arrays["tokens"].shape[0], mesh)
    return {k: torch.from_numpy(np.asarray(v))[rows] for k, v in arrays.items()}


def moe_step(mesh, tree, batch, cfg, step0, total):
    """On this rank: the reduced gradients (:func:`train.lm_grads`) and one
    :func:`train.lm_train_step` from moments at zero and step ``step0``.
    Returns the loss, the gradient leaves and the params after the step
    with the experts gathered, the clipped norm, and every rank's digests
    of its non-expert gradient and param leaves."""
    full = bridge.from_jax_params(tree, device="cpu")
    params = shard_lib.shard_lm_experts(full, mesh)
    b = _batch(batch, mesh)
    loss, grads = train.lm_grads(params, b, cfg, mesh=mesh)
    opt = adamw.adamw_init(params)
    opt = opt._replace(step=torch.tensor(step0, dtype=torch.int32))
    params, opt, m = train.lm_train_step(params, opt, b, cfg, total=total,
                                         mesh=mesh)
    paths = [p for p, _ in flatten(grads)[0]]
    replicated = [i for i, p in enumerate(paths) if not shard_lib.is_lm_expert(p)]
    g_leaves = adamw.tree_leaves(grads)
    p_leaves = adamw.tree_leaves(params)
    digests = _every_rank(([_digest(g_leaves[i]) for i in replicated],
                           [_digest(p_leaves[i]) for i in replicated]))
    return dict(loss=float(loss), gnorm=float(m["grad_norm"]),
                grads=adamw.tree_leaves(shard_lib.gather_lm_experts(grads, mesh)),
                params=adamw.tree_leaves(shard_lib.gather_lm_experts(params, mesh)),
                paths=paths, digests=digests)


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _gather_bwd_sums(ctx, g):
    k = g.shape[ctx.dim] // ctx.mesh.model
    return (ctx.mesh.model_sum(g).narrow(ctx.dim, ctx.mesh.rank_in("model") * k, k),
            None, None)


# planted faults, each of which the step must show
FAULTS = {
    # the router's (and shared experts') gradient share not summed over model
    "router_not_summed": lambda: _patched(shard_lib, "is_lm_token_local",
                                          lambda path: False),
    # the clip's norm over this rank's experts only
    "norm_local_experts": lambda: _patched(train, "reduce_square_sums",
                                           lambda sq, paths, mesh: list(sq)),
    # the gather's backward summing the cotangents over model, not slicing
    "gather_bwd_sums": lambda: _patched(dense._ModelGather, "backward",
                                        staticmethod(_gather_bwd_sums)),
}


def unsplit_case(mesh, tree, wide, odd_batch, steps):
    """(h) on the data 2 x model 2 mesh, where the MoE block gathers the
    global batch: prefill of the rank's rows of the (B, S) prompt ``wide``
    (which splits the sequence) and ``steps`` decode steps (which split the
    global batch over model) at capacity_factor 1.0 and a capacity floor
    of 1, each step's logits gathered over the batch group; and the loss
    and reduced gradients of ``odd_batch``, whose odd length splits the
    global batch too."""
    cfg = moe_cfg()
    api = get_model(cfg)
    params = shard_lib.shard_lm_experts(bridge.from_jax_params(tree, device="cpu"), mesh)
    kw = train.mesh_kwargs(cfg, mesh)
    toks = torch.from_numpy(np.asarray(wide))[shard_lib.local_rows(len(wide), mesh)]
    S = toks.shape[1] - steps
    with torch.no_grad():
        lg, cache = api.prefill(params, {"tokens": toks[:, :S]}, cfg, **kw)
        logits = [mesh.batch_gather(lg)]
        for t in range(S, S + steps):
            lg, cache = api.decode_step(params, {"token": toks[:, t]}, cache, cfg,
                                        capacity_floor=1, **kw)
            logits.append(mesh.batch_gather(lg))
    loss, grads = train.lm_grads(params, _batch(odd_batch, mesh), cfg, mesh=mesh)
    return dict(decode=logits, loss=float(loss),
                grads=adamw.tree_leaves(shard_lib.gather_lm_experts(grads, mesh)))


def train_case(mesh, moe_tree, moe_batch, dense_tree, dense_batch, step0, total,
               wide, odd_batch, steps):
    """(a), (f), (c) and (h) of the test on the data 2 x model 2 mesh: the
    MoE step, the same step under each planted fault, the dense model's
    loss and gradients, and :func:`unsplit_case`."""
    torch.manual_seed(0)
    out = {"mesh": (tuple(mesh.axis_names), dict(mesh.shape),
                    _every_rank((mesh.rank_in("data"), mesh.rank_in("model"))))}
    out["a"] = moe_step(mesh, moe_tree, moe_batch, moe_cfg(), step0, total)
    out["faults"] = {}
    for name, plant in FAULTS.items():
        with plant():
            out["faults"][name] = moe_step(mesh, moe_tree, moe_batch, moe_cfg(),
                                           step0, total)
    cfg = get_smoke(DENSE)
    params = bridge.from_jax_params(dense_tree, device="cpu")
    loss, grads = train.lm_grads(params, _batch(dense_batch, mesh), cfg, mesh=mesh)
    out["c"] = dict(loss=float(loss), grads=adamw.tree_leaves(grads))
    out["h"] = unsplit_case(mesh, moe_tree, wide, odd_batch, steps)
    return out


def serve_case(mesh, tree, split, fallback, steps, ckpt):
    """(b) of the test on the data 1 x model 2 mesh: prefill then ``steps``
    decode steps of the MoE smoke model for the (B, S) prompt ``split``
    (prefill splits the sequence, decode the batch) and for ``fallback``
    (the tokens split neither way); the fallback prompt's loss and reduced
    gradients; and ``train_lm`` for one step writing ``ckpt`` (rank 0),
    with its params' experts gathered."""
    cfg = moe_cfg(get_smoke(MOE).capacity_factor)
    api = get_model(cfg)
    full = bridge.from_jax_params(tree, device="cpu")
    params = shard_lib.shard_lm_experts(full, mesh)
    kw = train.mesh_kwargs(cfg, mesh)
    out = {}
    for name, toks in (("split", split), ("fallback", fallback)):
        toks = torch.from_numpy(toks)
        S = toks.shape[1] - steps
        with torch.no_grad():
            lg, cache = api.prefill(params, {"tokens": toks[:, :S]}, cfg, **kw)
            logits = [lg]
            for t in range(S, S + steps):
                lg, cache = api.decode_step(params, {"token": toks[:, t]}, cache, cfg,
                                            **kw)
                logits.append(lg)
        out[name] = logits
    toks = torch.from_numpy(fallback)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    loss, grads = train.lm_grads(params, batch, cfg, mesh=mesh)
    out["fallback_grads"] = dict(
        loss=float(loss),
        grads=adamw.tree_leaves(shard_lib.gather_lm_experts(grads, mesh)))
    trained = train.train_lm(cfg, steps=1, batch=2, seq=8, mesh=mesh, ckpt=ckpt,
                             device="cpu")
    out["trained"] = shard_lib.gather_lm_experts(trained, mesh)
    return out
