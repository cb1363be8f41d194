"""Where a training step's device time goes, by kernel and by part.

Trains one model on the card under ``torch.profiler`` and prints the CUDA
kernels grouped into the port's kernels (forward and backward), cuBLAS
products and everything else, then the step's parts (the
``*_train_step.forward / .backward / .optimizer`` ranges: forward and
loss, backward, clip and AdamW; the LMs' recomputed layers, the
``layers.remat`` ranges run in the backward, apart from it), with the
device's busy share of the wall time::

    PYTHONPATH=src python -m repro_torch.launch.profile_train --layers 8 --batch 8 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.profile_train --arch rwkv6-3b --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.profile_train --arch seamless-m4t-large-v2

``--arch dit-moe-xl`` (the default): full width, depth cut (8 layers by
default: the f32 params, gradients, moments and clipped copy of 28 layers
do not fit one 80 GB card), adaLN and the output layer perturbed from
random weights, f32, ``rf_train_step``.  An LM (``rwkv6-3b`` and the
families ``train_lm`` trains: ``qwen3-32b``, ``zamba2-7b``,
``seamless-m4t-large-v2``, ``llama-3.2-vision-11b``, ``gemma2-9b``,
``stablelm-12b``, ``qwen3-moe-30b-a3b``): bf16 params and f32
moments as ``train_lm`` makes them, the stub audio frames or image
embeddings drawn each step, batches of ``--seq`` tokens,
``lm_train_step``, at the depth of :data:`LM_TRAIN_LAYERS` (what one card
holds; ``chip_smoke.py`` phase 16 trains the same cuts) unless
``--layers`` names another, laid out as the family lays out its blocks
(:func:`lm_train_config`).  A warm-up step runs first and is not traced.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import latent_batches, token_batches
from repro_torch.launch.profile_serve import RANGES, kernel_groups, print_groups
from repro_torch.launch.train import lm_train_step, stub_inputs
from repro_torch.models.api import get_model
from repro_torch.models.dit_moe import init_dit
from repro_torch.optim.adamw import adamw_init
from repro_torch.sampling.rectified_flow import rf_draws, rf_train_step

PART_NAMES = ("forward", "backward", "optimizer")
RECOMPUTE = "recompute"
# the LMs' depth for a training profile on one 80 GB card (bf16 params,
# f32 moments: about 21 bytes a param at 8 x 128 tokens): seamless-m4t-
# large-v2 and rwkv6-3b whole; qwen3-32b 2 of 64 layers (1.56 B of
# embedding and unembedding, 0.49 B a layer); zamba2-7b 12 of 81 (two uses
# of the shared block); llama-3.2-vision-11b one superblock, 4 self layers
# and 1 cross; gemma2-9b 4 of 42 (1.83 B of embedding and unembedding,
# 0.20 B a layer: 2.63 B, two local and two global layers); stablelm-12b 6 of 40
# (1.03 B of embeddings, 0.28 B a layer: 2.70 B); qwen3-moe-30b-a3b 3 of 48
# (0.62 B of embeddings, 0.62 B a layer with all 128 experts: 2.49 B).
# dbrx-132b is not here: one layer and its embeddings are 4.5 B params,
# about 95 GB at those bytes a param
LM_TRAIN_LAYERS = {"qwen3-32b": 2, "zamba2-7b": 12, "llama-3.2-vision-11b": 5,
                   "gemma2-9b": 4, "stablelm-12b": 6, "qwen3-moe-30b-a3b": 3}
LM_ARCHS = ("rwkv6-3b", "qwen3-32b", "zamba2-7b", "seamless-m4t-large-v2",
            "llama-3.2-vision-11b", "gemma2-9b", "stablelm-12b", "qwen3-moe-30b-a3b")


def lm_train_config(arch: str, layers=None):
    """``arch``'s config at ``layers`` (default :data:`LM_TRAIN_LAYERS`, else
    its own depth), laid out as its family lays out blocks: zamba2's
    superblocks and trailing mamba blocks and the VLM's superblocks follow
    from ``num_layers``; the audio model cuts its encoder to the same
    depth as its decoder."""
    cfg = get_config(arch)
    layers = layers or LM_TRAIN_LAYERS.get(arch)
    if not layers:
        return cfg
    if cfg.family == "audio":
        return cfg.replace(num_layers=layers, encoder_layers=layers)
    return cfg.replace(num_layers=layers)


def parts_of(step_name: str):
    """The three range names of ``rf_train_step`` or ``lm_train_step``."""
    return tuple(f"{step_name}.{p}" for p in PART_NAMES)


def split_by_part(prof, parts=parts_of("rf_train_step")):
    """Kernel time (us) by part of the step: the three of ``parts`` and
    ``RECOMPUTE``.  A kernel belongs to the forward or the optimizer when
    it starts inside that range's device span (the trace lists a range on
    the device from its first kernel's start to its last's end); autograd
    launches the backward from its own thread, outside the range opened on
    this one, so a kernel outside both belongs to the recompute when it
    starts inside a ``layers.remat`` span (a recomputed layer run again in
    the backward), else to the backward."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.name in (parts[0], parts[2])]
    remat = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == "layers.remat"]
    out = dict.fromkeys(parts + (RECOMPUTE,), 0.0)
    for e in events:
        if e.name.startswith(RANGES):
            continue
        start = e.time_range.start
        part = next((n for s, t, n in spans if s <= start < t), None)
        if part is None:
            part = RECOMPUTE if any(s <= start < t for s, t in remat) else parts[1]
        out[part] += e.time_range.elapsed_us()
    return out


def _dit_step(args):
    """(config, step function, step name) for DiT-MoE-XL cut to --layers."""
    cfg = get_config("dit-moe-xl").replace(num_layers=args.layers or 8)
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
    return cfg, step, "rf_train_step"


def _lm_step(args):
    """(config, step function, step name) for an LM at :func:`lm_train_config`
    (--layers), bf16 params from seed 0, the family's stub inputs drawn
    each step as ``train_lm`` draws them."""
    cfg = lm_train_config(args.arch, args.layers)
    api = get_model(cfg)
    params = api.init(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    opt = adamw_init(params)
    it = token_batches(cfg.vocab_size, args.batch, args.seq, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    total = args.steps + 1

    def step():
        nonlocal params, opt
        batch = dict(next(it), **stub_inputs(api, cfg, args.batch, gen))
        params, opt, _ = lm_train_step(params, opt, batch, cfg, total=total)
    return cfg, step, "lm_train_step"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="dit-moe-xl", choices=("dit-moe-xl",) + LM_ARCHS)
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (DiT-MoE-XL: 8 by default; an LM: LM_TRAIN_LAYERS', "
                         "else its config's)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128, help="tokens a sequence (LM)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, step, name = (_dit_step if args.arch == "dit-moe-xl" else _lm_step)(args)
    parts = parts_of(name)

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
    by_part = split_by_part(prof, parts)
    shape = (f"batch {args.batch} x {args.seq} tokens" if name == "lm_train_step"
             else f"batch {args.batch}")
    print(f"{cfg.name} at {cfg.num_layers} layers, {shape}, {args.steps} "
          f"training steps on {torch.cuda.get_device_name(0)}")
    print(f"wall {wall_us / 1e3:.3f} ms ({wall_us / 1e3 / args.steps:.3f} ms/step); "
          f"kernel time {total / 1e3:.3f} ms; device busy {100.0 * total / wall_us:.1f}%")
    print_groups(kernels, total, groups, args.steps, "step", args.top)
    print("kernel time by part of the step (the backward's with the few "
          "kernels outside the ranges: the batch and the draws):")
    for part in parts[:1] + (RECOMPUTE,) + parts[1:]:
        us = by_part[part]
        print(f"  {part:26s} {us / 1e3 / args.steps:10.3f} ms/step "
              f"{100.0 * us / total:6.1f}%")
    for names in (("flash_attention", "flash_attention_bwd"), ("expert_ffn", "expert_ffn_bwd")):
        us = sum(groups[g][0] for g in names if g in groups)
        print(f"{' + '.join(names)} {us / 1e3 / args.steps:.3f} ms/step, "
              f"{100.0 * us / total:.1f}% of the kernel time")
    print(json.dumps({"arch": cfg.name, "layers": cfg.num_layers,
                      "wall_ms_per_step": wall_us / 1e3 / args.steps,
                      "busy_share": total / wall_us,
                      "groups_ms_per_step": {g: v[0] / 1e3 / args.steps
                                             for g, v in groups.items()},
                      "parts_ms_per_step": {k: v / 1e3 / args.steps
                                            for k, v in by_part.items()}}))


if __name__ == "__main__":
    main()
