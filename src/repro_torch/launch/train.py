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

  PYTHONPATH=src python -m repro_torch.launch.train --arch dit-moe-xl \\
      --smoke --device cpu --steps 5 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b \\
      --smoke --device cpu --steps 3 --batch 2 --seq 16

The flags are the reference's (``--arch --smoke --steps --batch --seq
--mesh --ckpt``) plus ``--device``; the CLI prints every step's loss (the
reference's every 10th).  The ``local`` and ``prod`` training meshes are
not ported yet and raise ``NotImplementedError`` naming ROADMAP.md (A,
order item 4) before any params are drawn.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.checkpoint.io import save_checkpoint, unflatten
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config, get_smoke
from repro_torch.data.synthetic import latent_batches, token_batches
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


def lm_train_step(params, opt_state, batch, cfg, *, total: int):
    """One step of the reference's ``train_lm``: the gradients of the
    family's ``loss_fn`` on ``batch`` (tokens, labels), clipped to global
    norm 1.0, and AdamW at ``cosine_schedule(step, base_lr=3e-4,
    warmup=20, total=total)``.  ``params`` and the moments are updated in
    place; the metrics (``loss``, ``grad_norm``, ``lr``) stay 0-d device
    tensors.  Returns (params, opt_state, metrics)."""
    api = get_model(cfg)
    rng = torch.profiler.record_function   # named ranges for profile_train
    with torch.enable_grad():
        # leaves that require grad, sharing the params' storage; the
        # params themselves stay plain tensors, so serving from them
        # later takes the kernels' no-grad path
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with rng("lm_train_step.forward"):
            loss, _ = api.loss_fn(live, batch, cfg)
        leaves = tree_leaves(live)
        with rng("lm_train_step.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    with rng("lm_train_step.optimizer"):
        grads = unflatten(params, [torch.zeros_like(p) if g is None else g
                                   for g, p in zip(grads, leaves)])
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        lr = cosine_schedule(opt_state.step, base_lr=3e-4, warmup=20,
                             total=total)
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr)
    return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm,
                               "lr": lr}


def train_lm(cfg, *, steps: int, batch: int, seq: int, mesh=None,
             ckpt: Optional[str] = None, log_every: int = 10, device=None,
             seed: int = 0):
    """Train the language model ``cfg`` for ``steps`` steps on batches of
    ``batch`` x ``seq`` tokens from ``token_batches(..., seed=seed)`` (the
    reference's stream for the same seed), with the family's stub inputs
    (:func:`stub_inputs`) from a generator of the run's device seeded from
    ``seed + 1``.  The params come from the family's init on a generator
    of the run's device seeded from ``seed``, in the init's dtype (bf16).
    Prints the reference's line every ``log_every`` steps and at the
    last, writes ``ckpt`` at the end when given, and returns the trained
    params.  A ``mesh`` raises first (not ported)."""
    if mesh is not None:
        raise NotImplementedError("train_lm over a mesh is not ported yet "
                                  "(ROADMAP.md A, order item 4)")
    api = get_model(cfg)
    dev = resolve_device(device)
    params = api.init(cfg, generator=torch.Generator(device=dev).manual_seed(seed))
    opt = adamw_init(params)
    it = token_batches(cfg.vocab_size, batch, seq, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    t0 = time.time()
    for i in range(steps):
        b = dict(next(it), **stub_inputs(api, cfg, batch, gen))
        params, opt, m = lm_train_step(params, opt, b, cfg, total=steps)
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:5d}  loss {float(m['loss']):.4f}  "
                  f"gnorm {float(m['grad_norm']):.3f}  "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)", flush=True)
    if ckpt:
        save_checkpoint(ckpt, params, step=steps)
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
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: training meshes are not ported yet "
            f"(ROADMAP.md A, order item 4)")
    print(f"training {cfg.name} ({cfg.family}), "
          f"{cfg.param_count() / 1e6:.1f}M params")
    if cfg.family == "dit_moe":
        return train_diffusion(cfg, steps=args.steps, batch=args.batch,
                               ckpt=args.ckpt, log_every=1, device=args.device)
    return train_lm(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                    ckpt=args.ckpt, log_every=1, device=args.device)


if __name__ == "__main__":
    main()
