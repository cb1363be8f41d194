"""Rank jobs of ``tests/test_torch_tp.py``: functions that
``repro_torch.launch.mesh.spawn`` runs in each gloo rank of a training mesh
(imported by the ranks, not collected by pytest).

Each rank cuts the reference's params (a numpy tree) to its slices of
their specs (``bridge.from_jax_params(mesh=)``), takes its rows of the
global batch, and runs the tensor-parallel step under each option set;
rank 0 returns what the test holds against the reference: the loss, every
gradient leaf and every updated param gathered over ``model``, the clipped
norm, and whether the ZeRO step's params are bit for bit the plain
step's on every rank.
"""
import contextlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.common import sharding as shard_lib
from repro_torch.configs import get_smoke
from repro_torch.launch import train
from repro_torch.models import dense
from repro_torch.models import tp as tp_lib
from repro_torch.models.api import get_model
from repro_torch.optim import adamw

CONFIGS = ("qwen3-32b", "gemma2-9b", "qwen3-moe-30b-a3b")
# the reference make_step's option sets, as lm_train_step's keywords
OPTIONS = {
    "none": {},
    "seq_shard": {"seq_shard": True},
    "attn_shard": {"attn_shard": "heads"},
    "attn_seq": {"attn_shard": "seq"},
    "seq_shard+attn_seq": {"seq_shard": True, "attn_shard": "seq"},
}


def config(name):
    cfg = get_smoke(name)
    return cfg.replace(capacity_factor=1.0) if cfg.is_moe else cfg


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _kv_mod(self, first, count, G):
    # the kv head of query head h taken as h % KVH (the smoke configs' 2)
    return [(first + i) % 2 for i in range(count)]


# planted faults: (config, option set, patch); each must fail the step's
# comparison with the reference
FAULTS = {
    # the norms' gradients under seq_shard kept as the rank's share (not
    # summed over model)
    "ln_not_summed": ("qwen3-32b", "seq_shard", lambda: _patched(
        tp_lib.TP, "norm",
        lambda self, p, cut: {"scale": self.use(p["scale"], cut["scale"], local=False)})),
    # the "seq" layout's queries masked as if they sat at position 0
    "offset_dropped": ("qwen3-32b", "attn_seq", lambda: _patched(
        tp_lib.TP, "seq_offset", lambda self, S: 0)),
    # GQA's kv heads mapped as h % KVH where KVH does not divide over model
    "kv_heads_mod": ("qwen3-32b", "none", lambda: _patched(tp_lib.TP, "kv_heads_for", _kv_mod)),
}


def _every_rank(value):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def _clone(tree):
    return adamw.tree_map(lambda t: t.clone(), tree)


def tp_step(mesh, name, tree, batch, options, step0, total):
    """On this rank: the tensor-parallel gradients (:func:`train.lm_grads`)
    and the rest of one ``train.lm_train_step`` (the clip, AdamW at the
    cosine schedule) from zero moments at step ``step0``, once with whole
    moments and once with them cut over ``data`` (ZeRO).
    Returns the loss, the gathered gradient leaves and updated params, the
    clipped norm, and every rank's verdict on ZeRO's bit-identity."""
    cfg = config(name)
    params = bridge.from_jax_params(tree, device="cpu", mesh=mesh)
    cuts = dense.param_cuts(params, cfg, mesh)
    rows = shard_lib.local_rows(batch["tokens"].shape[0], mesh)
    b = {k: torch.from_numpy(np.asarray(v))[rows] for k, v in batch.items()}
    loss, grads = train.lm_grads(params, b, cfg, mesh=mesh, **options)
    whole = get_model(cfg).init(cfg, generator=None)
    stepped = []
    for zero in (False, True):
        p = _clone(params)
        opt = adamw.adamw_init(p)
        if zero:
            opt = shard_lib.shard_lm_moments(opt, shard_lib.lm_moment_dims(whole, mesh), mesh)
        opt = opt._replace(step=torch.tensor(step0, dtype=torch.int32))
        clipped, gnorm = train.clip_lm_grads(grads, p, cfg, mesh)
        lr = adamw.cosine_schedule(opt.step, base_lr=3e-4, warmup=20, total=total)
        p, opt = adamw.adamw_update(clipped, opt, p, lr=lr, mesh=mesh)
        stepped.append((p, float(gnorm), opt))
    (plain, gnorm, _), (zeroed, _, zopt) = stepped
    same = all(torch.equal(a, z) for a, z in zip(adamw.tree_leaves(plain),
                                                  adamw.tree_leaves(zeroed)))
    cut_moments = sum(m.numel() for m in adamw.tree_leaves(zopt.mu)) \
        < sum(p.numel() for p in adamw.tree_leaves(plain))
    return dict(loss=float(loss), gnorm=gnorm,
                grads=adamw.tree_leaves(shard_lib.gather_lm_params(grads, mesh, cuts)),
                params=adamw.tree_leaves(shard_lib.gather_lm_params(plain, mesh, cuts)),
                paths=[p for p, _ in shard_lib.tree_items(params)],
                zero_same=_every_rank(same), zero_cut=cut_moments)


def tp_case(mesh, trees, batches, step0, total, faults):
    """Every config under every option set on this mesh, then the planted
    faults named in ``faults``."""
    torch.manual_seed(0)
    out = {"shape": dict(mesh.shape)}
    for name in CONFIGS:
        for opt, kw in OPTIONS.items():
            out[f"{name}/{opt}"] = tp_step(mesh, name, trees[name], batches[name], kw,
                                           step0, total)
    for fault in faults:
        name, opt, plant = FAULTS[fault]
        with plant():
            out[f"fault/{fault}"] = tp_step(mesh, name, trees[name], batches[name],
                                            OPTIONS[opt], step0, total)
    return out
