"""Training launcher of the port (port of ``repro.launch.train``).

Trains the DiT-MoE diffusion model on synthetic class-conditional latents
with rectified flow, AdamW and the cosine schedule, gradient clipping, and
an optional checkpoint at the end (the reference's format 3, readable by
either package).  Training runs in f32.  Every step goes through the
kernels' autograd Functions on the card (the backward kernels included)
and through their plain versions on the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch dit-moe-xl \\
      --smoke --device cpu --steps 5 --batch 4

The flags are the reference's (``--arch --smoke --steps --batch --seq
--mesh --ckpt``) plus ``--device``.  Not ported yet, and refused with a
``NotImplementedError`` that names ROADMAP.md: the language-model families
(``train_lm`` waits for an ``rwkv6_scan`` backward kernel and for A.12's
families) and the ``local`` / ``prod`` training meshes.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.checkpoint.io import save_checkpoint
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config, get_smoke
from repro_torch.data.synthetic import latent_batches
from repro_torch.models.dit_moe import init_dit
from repro_torch.optim.adamw import adamw_init
from repro_torch.sampling.rectified_flow import rf_draws, rf_train_step


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
            f"(ROADMAP.md A)")
    if cfg.family != "dit_moe":
        raise NotImplementedError(
            f"training {cfg.name} ({cfg.family}) is not ported yet: train_lm "
            f"waits for an rwkv6_scan backward kernel and the other families "
            f"(ROADMAP.md A, A.12)")
    print(f"training {cfg.name} ({cfg.family}), "
          f"{cfg.param_count() / 1e6:.1f}M params")
    return train_diffusion(cfg, steps=args.steps, batch=args.batch,
                           ckpt=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
