"""Where an LM's prefill and decode spend device time, by kernel:
rwkv6-3b by default, any LM family's config with ``--arch``.

Builds the model in bf16 from random params (seed 0; the weights change no
shape, so they do not change the time) and the family's stub inputs
(``ModelApi.extra_inputs``) from a seed, prefills a batch of prompts from
``data.synthetic.token_batches`` (the cache sized for the decode steps;
the encoder-decoder's self cache padded, as its prefill returns exactly the
prompt's) and decodes greedily, each under its own ``torch.profiler``
trace.  Prints the CUDA kernels ranked by device time, grouped into the
port's hand-written kernels, cuBLAS products and everything else, with the
device's busy share of the wall time::

    PYTHONPATH=src python -m repro_torch.launch.profile_rwkv6 \\
        --batch 8 --prompt 2048 --decode 16
    PYTHONPATH=src python -m repro_torch.launch.profile_rwkv6 \\
        --arch zamba2-7b --batch 4 --prompt 4096 --decode 16

A warm-up prefill and decode step run first and are not traced.  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import token_batches
from repro_torch.launch.profile_serve import kernel_groups, print_groups
from repro_torch.models import encdec
from repro_torch.models.api import get_model


def _traced(fn):
    """(result, profiler, wall us) of ``fn()`` under a CPU+CUDA trace, the
    wall time taken between two synchronisations."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return out, prof, wall_us


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--decode", type=int, default=16)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_rwkv6: needs a CUDA device")
    cfg = get_config(args.arch)
    api = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = api.init(cfg, generator=gen)
    prompts = next(token_batches(cfg.vocab_size, args.batch, args.prompt, seed=0,
                                 device="cuda"))["tokens"]
    batch = {"tokens": prompts}
    batch.update({name: torch.randn(shape_fn(cfg, args.batch), generator=gen,
                                    device="cuda").to(dtype)
                  for name, shape_fn, dtype in api.extra_inputs})
    slots = args.prompt + args.decode + 1

    def prefill():
        last, state = api.prefill(params, batch, cfg, cache_len=slots)
        if cfg.family == "audio":                 # the prompt's slots only
            state = encdec.pad_cache(state, slots - args.prompt)
        return last, state

    last, state = prefill()                                          # warm-up
    api.decode_step(params, {"token": last.argmax(-1)}, state, cfg)

    def decode():
        nonlocal last, state
        for _ in range(args.decode):
            last, state = api.decode_step(params, {"token": last.argmax(-1)},
                                          state, cfg)

    (last, state), p_prof, p_wall = _traced(prefill)
    _, d_prof, d_wall = _traced(decode)
    report = {}
    print(f"{cfg.name} bf16 on {torch.cuda.get_device_name(0)}")
    for label, prof, wall_us, per, unit, what in (
            ("prefill", p_prof, p_wall, 1, "prefill",
             f"{args.batch} x {args.prompt} tokens"),
            ("decode", d_prof, d_wall, args.decode, "token",
             f"{args.decode} steps of {args.batch} tokens")):
        kernels, total, groups = kernel_groups(prof)
        print(f"{label}, {what}: wall {wall_us / 1e3 / per:.3f} ms/{unit}; kernel "
              f"time {total / 1e3 / per:.3f} ms/{unit}; device busy "
              f"{100.0 * total / wall_us:.1f}%")
        print_groups(kernels, total, groups, per, unit, args.top)
        report[label] = {f"wall_ms_per_{unit}": wall_us / 1e3 / per,
                         "busy_share": total / wall_us,
                         f"groups_ms_per_{unit}": {g: v[0] / 1e3 / per
                                                   for g, v in groups.items()},
                         f"launches_per_{unit}": {g: v[1] / per
                                                  for g, v in groups.items()}}
    print(json.dumps(report))


if __name__ == "__main__":
    main()
