"""Training launcher of the port (port of ``repro.launch.train``).

Trains the DiT-MoE diffusion model on synthetic class-conditional latents
with rectified flow (``train_diffusion``, f32), and every language model
on the synthetic token stream (``train_lm``, bf16 params as the
reference's init gives them, f32 AdamW moments): RWKV-6 (``ssm``), the
``dense`` family (qwen3-32b, deepseek-67b, stablelm-12b at head_dim 160,
gemma2-9b with its windowed and global layers and its logit softcaps),
the ``moe`` family (qwen3-moe-30b-a3b, dbrx-132b, with the load-balance
loss), Zamba2 (``hybrid``), SeamlessM4T (``audio``, over stub audio
frames) and the Llama-3.2-Vision VLM (``vlm``, over stub image
embeddings), the stub inputs drawn each step from a generator on the
run's device as the reference draws them.  All use AdamW and the cosine
schedule, gradient clipping, and an optional checkpoint at the end (the
reference's format 3, readable by either package).  Every step goes
through the kernels' autograd Functions on the card (the backward kernels
included) and through their plain versions on the CPU; the LMs recompute
each layer in the backward as the reference does.

Over a training mesh (``train_lm(mesh=)``, ``--mesh local|prod``;
:class:`~repro_torch.launch.mesh.TrainMesh`, one process per rank) every
family trains data-parallel: each rank draws the whole global batch and
keeps its rows over the batch axes (``pod x data``), and the ``dense``,
``moe`` and ``vlm`` families also get ``mesh`` and ``batch_axes`` in
``loss_fn``, as in the reference, which runs the MoE block expert-parallel
over ``model`` (each rank holds its ``E / model`` experts).  The gradients
are reduced as :func:`reduce_grads` says, the clip sees the global norm,
and AdamW runs on each rank.  :func:`lm_train_step` also takes the
reference dry run's layout for the ``dense`` and ``moe`` families: params
cut by their specs over ``model`` (tensor parallelism, with the
``seq_shard`` / ``attn_shard`` hints) and the moments also over ``data``
(ZeRO); ``train_lm`` keeps the reference ``train_lm``'s.

  PYTHONPATH=src python -m repro_torch.launch.train --arch dit-moe-xl \\
      --smoke --device cpu --steps 5 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b \\
      --smoke --device cpu --steps 3 --batch 2 --seq 16

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen3-moe-30b-a3b --smoke --device cpu --mesh local --model 2

The flags are the reference's (``--arch --smoke --steps --batch --seq
--mesh --ckpt``) plus ``--device`` and ``--model``; the CLI prints every
step's loss (the reference's every 10th; over a mesh rank 0 prints the
mean over the batch group).  ``--mesh local`` is ``make_local_mesh(data=
world / model, model)`` over the running world: one rank, or torchrun's
``WORLD_SIZE`` ranks, whose default group it initialises from torchrun's
environment (NCCL when every rank has a card of its own, gloo otherwise).
``--mesh prod`` is ``make_production_mesh()``, which raises unless the
world holds 256 ranks.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.io import flatten, save_checkpoint, unflatten
from repro_torch.common import sharding as shard_lib
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config, get_smoke
from repro_torch.data.synthetic import latent_batches, token_batches
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.api import get_model
from repro_torch.models.dit_moe import init_dit
from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                     clip_by_global_norm, cosine_schedule,
                                     tree_leaves, tree_map)
from repro_torch.sampling.rectified_flow import rf_draws, rf_train_step


def stub_inputs(api, cfg, batch: int, gen: torch.Generator):
    """The family's stub modality inputs (``api.extra_inputs``: the VLM's
    image embeddings, the audio model's frames), standard normal draws
    from ``gen`` on its device in their dtype, as the reference's
    ``train_lm`` draws them each step."""
    return {name: torch.randn(shape(cfg, batch), generator=gen, device=gen.device,
                              dtype=torch.float32).to(dtype)
            for name, shape, dtype in api.extra_inputs}


def mesh_kwargs(cfg, mesh):
    """``loss_fn``'s mesh keywords: ``mesh`` and ``batch_axes`` for the
    ``dense``, ``moe`` and ``vlm`` families (as the reference's
    ``train_lm`` passes them), none for the others, which a mesh trains
    data-parallel only."""
    if mesh is None or cfg.family not in ("dense", "moe", "vlm"):
        return {}
    return {"mesh": mesh, "batch_axes": mesh_lib.batch_axes(mesh)}


def reduce_grads(grads, paths, mesh, *, tensor_parallel: bool = False):
    """The rank's gradients (in the order of ``paths``) reduced over a
    training mesh, one collective a leaf in f32:

    (i) the routed experts (the rank's own): the mean over the batch group;
    (ii) the leaves applied to the rank's own tokens, the router and shared
        experts (:func:`~repro_torch.common.sharding.is_lm_token_local`),
        of which each ``model`` rank holds a share: the sum over ``model``,
        then the mean over the batch group;
    (iii) every other leaf, the same on every ``model`` rank: the mean over
        the batch group, which leaves it bit-identical across ``model``.

    ``tensor_parallel`` (the step of :mod:`repro_torch.models.tp`): the
    backward has already summed over ``model`` every gradient a rank holds
    a share of (a cut leaf's by its gather's reduce-scatter, a whole leaf
    read for the rank's share of the work by an all-reduce), so every leaf
    takes the mean over the batch group only.
    """
    out = list(grads)
    for i, path in enumerate(paths):
        summed = mesh.shape["model"] > 1 and not tensor_parallel \
            and shard_lib.is_lm_token_local(path)
        if summed or mesh.lanes > 1:
            g = out[i].to(torch.float32)
            if summed:
                g = mesh.model_sum(g)
            out[i] = mesh.batch_mean(g).to(out[i].dtype)
    return out


def reduce_square_sums(sq, paths, mesh, cut=None):
    """The per-leaf sums of squares that the global norm adds up: those of
    the leaves cut over ``model`` (each rank holds a slice) summed over
    ``model``, the whole leaves' counted once.  ``cut``: one flag a leaf
    (default: the routed experts, ``train_lm``'s layout)."""
    sq = list(sq)
    if cut is None:
        cut = [shard_lib.is_lm_expert(p) for p in paths]
    held = [i for i, c in enumerate(cut) if c]
    if held and mesh.shape["model"] > 1:
        summed = mesh.model_sum(torch.stack([sq[i] for i in held]))
        for j, i in enumerate(held):
            sq[i] = summed[j]
    return sq


def loss_kwargs(cfg, mesh=None, remat_policy: str = "full", *,
                seq_shard: bool = False, attn_shard=None):
    """``loss_fn``'s keywords as the reference's dry run passes them:
    :func:`mesh_kwargs`, and ``remat_policy`` and the layout hints
    ``seq_shard`` / ``attn_shard`` for the ``dense`` and ``moe`` families
    (the other families recompute each layer whole and refuse another
    policy or a hint)."""
    kw = mesh_kwargs(cfg, mesh)
    if cfg.family in ("dense", "moe"):
        kw["remat_policy"] = remat_policy
        if seq_shard:
            kw["seq_shard"] = True
        if attn_shard:
            kw["attn_shard"] = attn_shard
    elif remat_policy != "full" or seq_shard or attn_shard:
        raise ValueError(f"remat_policy {remat_policy!r}, seq_shard, attn_shard: "
                         f"only the dense and moe families take another policy "
                         f"or a layout hint")
    return kw


def _tensor_parallel(params, cfg, mesh, kw):
    """The cut dims of a tensor-parallel step (``models/dense.
    tensor_parallel``), None for any other."""
    if mesh is None or cfg.family not in ("dense", "moe"):
        return None
    from repro_torch.models import dense
    return dense.tensor_parallel(params, cfg, mesh,
                                 seq_shard=kw.get("seq_shard", False),
                                 attn_shard=kw.get("attn_shard"))[1]


def _held_cut(params, cfg, mesh):
    """One flag a leaf (in leaf order): whether the rank holds it cut over
    ``model``, where a leaf other than the routed experts is (the
    reference's specs, dense and moe families); None where only the
    experts are (``train_lm``'s layout, :func:`reduce_square_sums`'
    default)."""
    if cfg.family not in ("dense", "moe"):
        return None
    from repro_torch.models import dense
    cuts = shard_lib.tree_items(dense.param_cuts(params, cfg, mesh))
    if all(c is None or shard_lib.is_lm_expert(p) for p, c in cuts):
        return None
    return [c is not None for _, c in cuts]


def lm_grads(params, batch, cfg, *, mesh=None, remat_policy: str = "full",
             seq_shard: bool = False, attn_shard=None):
    """(loss, gradient tree) of the family's ``loss_fn`` on ``batch``; over
    a ``mesh`` ``batch`` holds the rank's rows, the gradients are reduced
    (:func:`reduce_grads`) and the loss is the batch group's mean.
    ``remat_policy``, ``seq_shard`` and ``attn_shard`` as
    :func:`loss_kwargs`.  ``params`` hold the rank's slices: its experts
    (``train_lm``), or every leaf cut by its spec
    (``sharding.shard_lm_params``), which runs the step tensor-parallel."""
    api = get_model(cfg)
    kw = loss_kwargs(cfg, mesh, remat_policy, seq_shard=seq_shard,
                     attn_shard=attn_shard)
    rng = torch.profiler.record_function   # named ranges for profile_train
    with torch.enable_grad():
        # leaves that require grad, sharing the params' storage; the
        # params themselves stay plain tensors, so serving from them
        # later takes the kernels' no-grad path
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with rng("lm_train_step.forward"):
            loss, _ = api.loss_fn(live, batch, cfg, **kw)
        leaves = tree_leaves(live)
        with rng("lm_train_step.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    loss = loss.detach()
    if mesh is not None:
        with rng("lm_train_step.reduce"):
            grads = reduce_grads(grads, [p for p, _ in flatten(params)[0]],
                                 mesh, tensor_parallel=_tensor_parallel(
                                     params, cfg, mesh, kw) is not None)
            loss = mesh.batch_mean(loss)
    return loss, unflatten(params, grads)


def clip_lm_grads(grads, params, cfg, mesh=None):
    """(``grads`` clipped to global norm 1.0, the norm): over a ``mesh`` the
    norm of the whole tree (:func:`reduce_square_sums` adds the other
    ranks' squares of the leaves the rank holds cut over ``model``),
    taken before any ZeRO cut.  Rebind the caller's tree to the result
    (``grads, gnorm = clip_lm_grads(grads, ...)``): the unclipped tree is
    then freed before AdamW, which holds its own temporaries."""
    reduce = None
    if mesh is not None:
        paths = [p for p, _ in flatten(params)[0]]
        cut = _held_cut(params, cfg, mesh)
        reduce = (lambda sq: reduce_square_sums(sq, paths, mesh)) if cut is None \
            else (lambda sq: reduce_square_sums(sq, paths, mesh, cut))
    return clip_by_global_norm(grads, 1.0, reduce=reduce)


def lm_train_step(params, opt_state, batch, cfg, *, total: int, mesh=None,
                  remat_policy: str = "full", seq_shard: bool = False,
                  attn_shard=None):
    """One step of the reference's ``train_lm``: the gradients of the
    family's ``loss_fn`` on ``batch`` (tokens, labels), clipped to global
    norm 1.0, and AdamW at ``cosine_schedule(step, base_lr=3e-4,
    warmup=20, total=total)``.  ``params`` and the moments are updated in
    place; the metrics (``loss``, ``grad_norm``, ``lr``) stay 0-d device
    tensors.  Over a training ``mesh`` ``batch`` is the rank's rows and
    ``params`` hold the rank's slices (its experts, or every leaf by the
    reference's specs: tensor parallelism, the moments then optionally cut
    over ``data`` too, each rank updating its slice): the gradients are
    reduced (:func:`lm_grads`) and the norm is the global one
    (:func:`clip_lm_grads`).
    ``remat_policy`` chooses what the backward recomputes (the values are
    the same); ``seq_shard`` and ``attn_shard`` the tensor-parallel layout
    (:func:`loss_kwargs`).  Returns (params, opt_state, metrics)."""
    loss, grads = lm_grads(params, batch, cfg, mesh=mesh,
                           remat_policy=remat_policy, seq_shard=seq_shard,
                           attn_shard=attn_shard)
    with torch.profiler.record_function("lm_train_step.optimizer"):
        grads, gnorm = clip_lm_grads(grads, params, cfg, mesh)
        lr = cosine_schedule(opt_state.step, base_lr=3e-4, warmup=20,
                             total=total)
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr,
                                         mesh=mesh)
    return params, opt_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}


def train_lm(cfg, *, steps: int, batch: int, seq: int, mesh=None,
             ckpt: Optional[str] = None, log_every: int = 10, device=None,
             seed: int = 0, history: Optional[list] = None, params=None):
    """Train the language model ``cfg`` for ``steps`` steps on batches of
    ``batch`` x ``seq`` tokens from ``token_batches(..., seed=seed)`` (the
    reference's stream for the same seed), with the family's stub inputs
    (:func:`stub_inputs`) from a generator of the run's device seeded from
    ``seed + 1``.  The params come from the family's init on a generator
    of the run's device seeded from ``seed``, in the init's dtype (bf16),
    unless ``params`` gives them (a whole tree on the run's device, which
    the steps update in place; CUDA's and the CPU's generators draw
    different numbers, so a run on each device from one seed starts from
    other weights).
    Prints the reference's line every ``log_every`` steps and at the
    last, appends each step's metrics (:func:`lm_train_step`'s, device
    tensors) to ``history`` when given, writes ``ckpt`` at the end when
    given, and returns the trained params.

    Over a training ``mesh`` (the run's device is ``mesh.device``) every
    rank draws the same params and the whole global batch, keeps its
    experts (:func:`~repro_torch.common.sharding.shard_lm_experts`) and its
    rows over the batch axes (the ``model`` ranks of a data group the same
    ones; ``batch`` must divide over them), and steps with
    :func:`lm_train_step`.  Rank 0 prints; the returned params hold the
    rank's experts; the checkpoint gathers them and rank 0 writes it."""
    rows = slice(0, batch)
    if mesh is not None:
        if batch % mesh.lanes:
            raise ValueError(f"batch {batch} must divide over the "
                             f"{mesh.lanes} ranks of the batch axes "
                             f"{mesh_lib.batch_axes(mesh)}")
        rows = shard_lib.local_rows(batch, mesh)
    api = get_model(cfg)
    dev = resolve_device(device) if mesh is None else mesh.device
    if params is None:
        params = api.init(cfg, generator=torch.Generator(device=dev).manual_seed(seed))
    if mesh is not None:
        params = shard_lib.shard_lm_experts(params, mesh)
    opt = adamw_init(params)
    it = token_batches(cfg.vocab_size, batch, seq, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    talk = mesh is None or mesh.rank == 0
    t0 = time.time()
    for i in range(steps):
        b = dict(next(it), **stub_inputs(api, cfg, batch, gen))
        b = {k: v[rows] for k, v in b.items()}
        params, opt, m = lm_train_step(params, opt, b, cfg, total=steps,
                                       mesh=mesh)
        if history is not None:
            history.append(m)
        if talk and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:5d}  loss {float(m['loss']):.4f}  "
                  f"gnorm {float(m['grad_norm']):.3f}  "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)", flush=True)
    if ckpt:
        whole = params if mesh is None \
            else shard_lib.gather_lm_experts(params, mesh)
        if talk:
            save_checkpoint(ckpt, whole, step=steps)
            print(f"saved {ckpt}")
    return params


def train_diffusion(cfg, *, steps: int, batch: int, ckpt: Optional[str] = None,
                    log_every: int = 10, device=None, seed: int = 0):
    """Train ``cfg`` (a DiT-MoE config) for ``steps`` rectified-flow steps
    on batches of ``batch`` latents.  The weights, the latents and the
    loss's draws come from three generators on the run's device seeded
    from ``seed``.  Prints the loss every ``log_every`` steps (the only
    host synchronisations), writes ``ckpt`` at the end when given, and
    returns the trained params."""
    dev = resolve_device(device)
    params = init_dit(cfg, generator=torch.Generator(device=dev).manual_seed(seed))
    opt = adamw_init(params)
    it = latent_batches(batch=batch, tokens=cfg.patch_tokens,
                        channels=cfg.in_channels, num_classes=cfg.num_classes,
                        seed=seed + 1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    shape = (batch, cfg.patch_tokens, cfg.in_channels)
    t0 = time.time()
    for i in range(steps):
        b = next(it)
        params, opt, m = rf_train_step(params, opt, b, cfg,
                                       draws=rf_draws(gen, batch, shape))
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:5d}  loss {float(m['loss']):.4f}  "
                  f"mse {float(m['mse']):.4f}  "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)", flush=True)
    if ckpt:
        save_checkpoint(ckpt, params, step=steps)
        print(f"saved {ckpt}")
    return params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", choices=["none", "local", "prod"],
                    default="none")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--model", type=int, default=1,
                    help="--mesh local: the 'model' axis (expert parallelism); "
                         "'data' takes the rest of the world")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    started = args.mesh != "none" and _init_world(args.device)
    try:
        mesh = None
        if args.mesh == "local":
            world = dist.get_world_size() if dist.is_initialized() else 1
            mesh = mesh_lib.make_local_mesh(max(1, world // args.model),
                                            args.model, device=args.device)
        elif args.mesh == "prod":
            mesh = mesh_lib.make_production_mesh(device=args.device)
        if mesh is None or mesh.rank == 0:
            print(f"training {cfg.name} ({cfg.family}), "
                  f"{cfg.param_count() / 1e6:.1f}M params"
                  + (f", mesh {mesh.shape}" if mesh is not None else ""))
        if cfg.family == "dit_moe":
            # as in the reference, train_diffusion takes no mesh
            return train_diffusion(cfg, steps=args.steps, batch=args.batch,
                                   ckpt=args.ckpt, log_every=1,
                                   device=args.device)
        return train_lm(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                        mesh=mesh, ckpt=args.ckpt, log_every=1,
                        device=args.device)
    finally:
        if started:
            dist.destroy_process_group()


def _init_world(device) -> bool:
    """Initialise the default process group from torchrun's environment
    (``WORLD_SIZE`` > 1, not yet initialised): NCCL when every rank has a
    card of its own, gloo on the CPU or for ranks that share a card (the
    ``rank_device`` rules).  Returns whether it did."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return False
    dev = torch.device(device) if device is not None else None
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    own_card = (dev is None or (dev.type == "cuda" and dev.index is None)) \
        and cards >= world
    dist.init_process_group("nccl" if own_card else "gloo",
                            init_method="env://")
    return True


if __name__ == "__main__":
    main()
