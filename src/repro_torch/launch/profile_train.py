"""Where a training step's device time goes, by kernel and by part.

Trains DiT-MoE-XL at full width, depth cut (8 layers by default: the f32
params, gradients, moments and clipped copy of 28 layers do not fit one
80 GB card), with adaLN and the output layer perturbed from random
weights, under ``torch.profiler``, and prints the CUDA kernels grouped
into the port's kernels (forward and backward), cuBLAS products and
everything else, then the step's three parts (the ``rf_train_step.*``
ranges: forward and loss, backward, clip and AdamW), with the device's
busy share of the wall time::

    PYTHONPATH=src python -m repro_torch.launch.profile_train --layers 8 --batch 8 --steps 3

A warm-up step runs first and is not traced.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.dit_moe_xl import config as xl_config
from repro_torch.data.synthetic import latent_batches
from repro_torch.launch.profile_serve import RANGES, kernel_groups, print_groups
from repro_torch.models.dit_moe import init_dit
from repro_torch.optim.adamw import adamw_init
from repro_torch.sampling.rectified_flow import rf_draws, rf_train_step

PARTS = ("rf_train_step.forward", "rf_train_step.backward",
         "rf_train_step.optimizer")


def split_by_part(prof):
    """Kernel time (us) by part of the step.  A kernel belongs to the
    forward or the optimizer when it starts inside that range's device
    span (the trace lists a range on the device from its first kernel's
    start to its last's end); autograd launches the backward from its own
    thread, outside the range opened on this one, so every other kernel
    counts as the backward's."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.name in (PARTS[0], PARTS[2])]
    parts = dict.fromkeys(PARTS, 0.0)
    for e in events:
        if e.name.startswith(RANGES):
            continue
        start = e.time_range.start
        part = next((n for s, t, n in spans if s <= start < t), PARTS[1])
        parts[part] += e.time_range.elapsed_us()
    return parts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = xl_config().replace(num_layers=args.layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_dit(cfg, generator=gen)
    for blk in params["blocks"]:        # adaLN-zero blocks are identity maps
        blk["adaln"].normal_(0.0, 0.05, generator=gen)
    params["final_out"].normal_(0.0, 0.05, generator=gen)
    opt = adamw_init(params)
    it = latent_batches(batch=args.batch, tokens=cfg.patch_tokens,
                        channels=cfg.in_channels, num_classes=cfg.num_classes,
                        seed=1, device="cuda")
    shape = (args.batch, cfg.patch_tokens, cfg.in_channels)

    def step():
        nonlocal params, opt
        params, opt, _ = rf_train_step(params, opt, next(it), cfg,
                                       draws=rf_draws(gen, args.batch, shape))

    step()                                   # warm-up, not traced
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, total, groups = kernel_groups(prof)
    parts = split_by_part(prof)
    print(f"{cfg.name} at {args.layers} layers, batch {args.batch}, {args.steps} "
          f"training steps on {torch.cuda.get_device_name(0)}")
    print(f"wall {wall_us / 1e3:.3f} ms ({wall_us / 1e3 / args.steps:.3f} ms/step); "
          f"kernel time {total / 1e3:.3f} ms; device busy {100.0 * total / wall_us:.1f}%")
    print_groups(kernels, total, groups, args.steps, "step", args.top)
    print("kernel time by part of the step (the backward's with the few "
          "kernels outside the ranges: the batch and the draws):")
    for name in PARTS:
        us = parts[name]
        print(f"  {name:26s} {us / 1e3 / args.steps:10.3f} ms/step "
              f"{100.0 * us / total:6.1f}%")
    print(json.dumps({"wall_ms_per_step": wall_us / 1e3 / args.steps,
                      "busy_share": total / wall_us,
                      "groups_ms_per_step": {g: v[0] / 1e3 / args.steps
                                             for g, v in groups.items()},
                      "parts_ms_per_step": {k: v / 1e3 / args.steps
                                            for k, v in parts.items()}}))


if __name__ == "__main__":
    main()
